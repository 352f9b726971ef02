"""Sharded serving subsystem: hash-partitioned multi-shard LSM with
scatter-gather execution and device-side cross-shard top-k merge.

The single ``LSMStore`` data plane scales out here: ``ShardRouter``
hash-partitions ingest by pk across N independent LSM shards (each with
its own memtable, flush scheduler, compaction tiers and per-segment
secondary indexes); ``ShardedExecutor`` fans hybrid queries out to every
shard's full pipeline — fused kernels, bitmap operators, visibility,
memtable overlay — and combines per-shard top-ks on device so the host
only ever sees O(shards * k) rows.

The JAX package also exports ``ShardedContinuousEngine`` here; it imports
the continuous-query engine and the incremental views, which are not
ported yet (ROADMAP queue 1, item 3), so this package exports the router
and the executor only.
"""
from repro_torch.core.shards.executor import (ShardedExecutor,  # noqa: F401
                                              ShardedPlan)
from repro_torch.core.shards.router import ShardRouter, hash_pks  # noqa: F401

__all__ = ["ShardRouter", "ShardedExecutor", "ShardedPlan", "hash_pks"]
