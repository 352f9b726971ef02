"""Sharded serving subsystem: hash-partitioned multi-shard LSM with
scatter-gather execution and device-side cross-shard top-k merge.

The single ``LSMStore`` data plane scales out here: ``ShardRouter``
hash-partitions ingest by pk across N independent LSM shards (each with
its own memtable, flush scheduler, compaction tiers and per-segment
secondary indexes); ``ShardedExecutor`` fans hybrid queries out to every
shard's full pipeline — fused kernels, bitmap operators, visibility,
memtable overlay — and combines per-shard top-ks on device so the host
only ever sees O(shards * k) rows; ``ShardedContinuousEngine`` aggregates
per-shard write deltas for Type 3/4 subscriptions.  The facade entry
point is ``Database(schema, shards=N)`` (core/api.py).
"""
from repro_torch.core.shards.continuous import \
    ShardedContinuousEngine  # noqa: F401
from repro_torch.core.shards.executor import (ShardedExecutor,  # noqa: F401
                                              ShardedPlan)
from repro_torch.core.shards.router import ShardRouter, hash_pks  # noqa: F401

__all__ = ["ShardRouter", "ShardedExecutor", "ShardedPlan",
           "ShardedContinuousEngine", "hash_pks"]
