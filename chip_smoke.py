#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

1. Builds the hand-written CUDA kernels from
   ``src/repro_torch/kernels/csrc`` (one ``nvcc`` per source, in parallel)
   and holds each against its plain PyTorch version at edge shapes (the two
   ADC kernels, the two merges, the beam search and both bitmap filter
   entry points bitwise; the list entry point at an empty list, a partial
   last block, every block of a 2,097,152-point segment and NaN points;
   the fused scan at ``FUSED_EDGE``: d up to MAX_DIM, a re-rank's 40 rows a
   query over 262,144 rows, a query under 128 admitted rows, NaN and +inf
   d2 rows, ties at its threshold, a mask its witnesses never sample; the
   beam search at ``GRAPH_EDGE``: a walk that stops before its last hop,
   NaN rows, the most rows whose visited words fit shared memory and
   2,097,152 rows on the global-memory path).
2. Drives the port's main path through its ``Database`` facade: one
   TRACY tweet table (128-d embeddings, IVF / ZORDER / INVERTED / BTREE
   indexes, flush_rows 2048, fanout 4, pq_m 8) filled through
   ``Table.put``/``flush`` on the card, then the exact hybrid templates
   t6, t8, t10, t13 (one rank term, no recall_target) and the filter-only
   t2, t4 as ``QueryBuilder``s through ``Database.execute_many`` in 21
   batches of 8 each (the first, which uploads the packed column,
   reported apart; one EXPLAIN per template printed).  The kernels'
   launch counts are zeroed just before and read just after; each must
   be > 0, and t2's spatial probes must make one list launch per
   ``ZOrderIndex.bitmap`` call that lists a block (each call counted and
   checked as it returns) and no per-block launch.
3. Holds every NN answer against a plain PyTorch brute force on the card
   in float64 (``tie_aware`` at the fp32 rounding bound ``round_bound``:
   each reported d2 within it of its row's exact d2 and of the exact j-th
   d2; a pk in one answer and not the other only where its exact d2 is
   within it of the k-th), printing tol / k-th d2 per template, and every
   filter answer against a numpy evaluation of the predicate.
4. The quantized path on the same store: TRACY's recall-targeted templates
   g6, g8, g13 (``benchmarks/tracy.py`` ``make_graph_templates`` at
   recall_target 0.9, as ``benchmarks/pq_study.py`` drives them) through
   ``Database.execute_many``, 21 batches of 8 each, each answer held
   against the float64 brute force over the survivors the ADC kernel kept
   (the exact re-rank) and in (score, pk) order; recall@10 against the
   exact dispatch on the same draws; g6 at refine 12 against the exact
   dispatch, bitwise.
5. The IVF-PQ probe: a 262,144-row TRACY store whose embedding column is
   ``IndexKind.PQIVF``, 20 t6- and 20 t8-shape queries through
   ``Executor.execute`` with a forced ``postfilter_nn`` plan; every
   returned distance against float64, recall@10 against a brute force.
6. The sharded path: ``Database(shards=4)``, a 4-shard ``ShardRouter`` of
   the same shape holding 1,048,576 rows, t6, t8, t10, t13, t2, t4 through
   ``Database.execute_many`` (the ``ShardedExecutor``; 21 batches of 8
   each), every answer checked as in 3, one cross-shard merge launch per
   NN batch, no per-block bitmap launch at t2.
7. The graph path: a GRAPH store of 8,192 rows in 8 segments, g6, g8, g13
   at recall_target 0.95 through ``Executor.execute_many`` (21 batches of
   8 each, planned by the planner alone), each answer held against the
   float64 top-k over the beam's survivors, ``rows_scanned`` against the
   visited words' popcount; recall@10 against the exact dispatch and a
   widened beam against it bitwise, printed.
8. The continuous path (``--phase continuous``): a 262,144-row TRACY
   table of the main store's config, the subscriptions of
   ``benchmarks/continuous_bench.py`` (12 SYNC, vector NN and
   ``GeoWithin`` alternating) and two ASYNC through ``subscribe``, 6 ticks
   of ``Database.advance`` in each of the modes none, fcache and views
   with puts, updates and deletes before every tick but the first; then
   the sharded table's ``ShardedContinuousEngine`` for 4 ticks.  Every
   answer at every tick is held against a fresh ``execute`` and the
   float64 brute force (a view's answer to the reference's own rule,
   ``hold_subscription``), and the schedule is checked.
9. Holds each kernel against its plain version on the inputs the paths
   gave it (ivf_scan and both bitmap filter entry points at every path
   shape), times both and one PyTorch library call where one computes the
   same function (every kernel by its device time in a profiler trace,
   beside its CUDA-event time: the fused scan at t6 (every launch of a
   call apart and summed, from one trace), the quantized scan,
   ivf_scan at its three most-launched and two most frequent single-query
   shapes, the bitmap filter's list launch at t2 and its per-block launch
   at (1024 x 2), pq_adc and its library call, the merges, the beam
   search; and one spatial probe op at t2 by its parts), traces one
   more t6, g6 and t2 batch and one sharded t6 batch for the device's busy
   share, and prints one JSON line ``{"kernels": [...]}``; the last line
   is
   ``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}``.

Each path's launch counts are zeroed just before it and read just after;
every kernel of the path must have launched.

    python3 chip_smoke.py                   # the full run (one GPU)
    python3 chip_smoke.py --phase kernels   # build + edge checks only
    python3 chip_smoke.py --phase sharded   # or main | graph | continuous

Any failing phase exits non-zero without the ``ok`` line.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
PAPER_ROWS = 8_000_000            # TRACY's preloaded tweets in the paper
ROWS = 2_097_152                  # one fully compacted 2 M-row segment
PQIVF_ROWS = 262_144              # the IVF-PQ store (cut further: ingest
#                                   builds 8 k-means codebooks per flush)
RECALL_TARGET = 0.9               # the quantized templates' recall target
SHARDED_ROWS = 1_048_576          # the sharded store (cut for the run's time)
N_SHARDS = 4
GRAPH_ROWS = 8_192                # the GRAPH store: the repo's graph study
GRAPH_FLUSH = 1_024               # 8 segments of 1,024 rows
GRAPH_RECALL = 0.95               # the graph templates' recall target
BATCHES = 21                      # per template: the first, then 20 timed
CONT_ROWS = 262_144               # the continuous table: every view
#                                   registration backfills every view over
#                                   every row on the host
CONT_MODES = ("none", "fcache", "views")
CONT_TICKS = 4                    # ticks a mode: the first, two after
#                                   writes, one with no write before it
SHARDED_CONT_TICKS = 4            # ticks of the sharded engine, the same
CONT_PUT, CONT_UPDATE, CONT_DELETE = 2048, 256, 64   # writes before a tick
VIEW_BUDGET = 64 * 2 ** 20        # the Database's default view budget
FP32_U = 2.0 ** -24               # fp32 unit roundoff
HBM_BYTES_PER_S = 3.35e12         # H100 SXM, NVIDIA data sheet
FP32_FLOPS = 67e12                # H100 SXM fp32 outside the tensor cores
TOPICS = ["sports", "music", "food", "travel", "tech", "finance",
          "weather", "movies", "health", "politics"]
SOURCES = {
    "fused_scan_topk": ("src/repro_torch/kernels/csrc/fused_scan.cu",
                        "src/repro/kernels/fused_scan.py:99"),
    "ivf_scan": ("src/repro_torch/kernels/csrc/ivf_scan.cu",
                 "src/repro/kernels/ivf_scan.py:37"),
    "bitmap_filter": ("src/repro_torch/kernels/csrc/bitmap_filter.cu",
                      "src/repro/kernels/bitmap_filter.py:31"),
    "quantized_scan_topk": ("src/repro_torch/kernels/csrc/quantized_scan.cu",
                            "src/repro/kernels/quantized_scan.py:86"),
    "pq_adc": ("src/repro_torch/kernels/csrc/pq_adc.cu",
               "src/repro/kernels/pq_adc.py:36"),
    "batched_topk_merge": ("src/repro_torch/kernels/csrc/topk_merge.cu",
                           "src/repro/kernels/topk_merge.py:96"),
    "graph_search_topk": ("src/repro_torch/kernels/csrc/graph_search.cu",
                          "src/repro/kernels/graph_search.py:144"),
    "topk_merge": ("src/repro_torch/kernels/csrc/topk_merge.cu",
                   "src/repro/kernels/topk_merge.py:38"),
}


# the quantized scan's four launches a call (csrc/quantized_scan.cu, the
# threshold and the select from csrc/scan_select.cuh)
QSCAN_KERNELS = ("qscan_witness", "topk_threshold", "qscan_scan",
                 "topk_select")
# the fused scan's four (csrc/fused_scan.cu, the same two shared ones)
FUSED_KERNELS = ("fscan_witness", "topk_threshold", "fscan_scan",
                 "topk_select")
# host time a profiler trace is held open before the first call and after
# the last launch has finished (``trace_spans``)
TRACE_PAD_S = 0.05
# bitmap_filter's list entry point: its launches also count in
# bitmap_filter's, so its per-block launches are the difference
ENTRY = "bitmap_filter_blocks"


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def log(*a) -> None:
    print(*a, flush=True)


def kernel_counts():
    """Each hand-written kernel's launch count, by the kernel's name."""
    from repro_torch.kernels import (bitmap_filter, fused_scan, graph_search,
                                     ivf_scan, pq_adc, quantized_scan,
                                     topk_merge)
    return {"fused_scan_topk": fused_scan.launches,
            "ivf_scan": ivf_scan.launches,
            "bitmap_filter": bitmap_filter.launches,
            "quantized_scan_topk": quantized_scan.launches,
            "pq_adc": pq_adc.launches,
            "batched_topk_merge": topk_merge.batched_launches,
            "graph_search_topk": graph_search.launches,
            "topk_merge": topk_merge.launches}


def counts():
    """Each kernel's launch count, and (``ENTRY``) the launches of
    bitmap_filter's list entry point alone, which also count in
    ``bitmap_filter``: its per-block launches are the difference."""
    from repro_torch.kernels import bitmap_filter
    c = {n: c.value for n, c in kernel_counts().items()}
    c[ENTRY] = bitmap_filter.blocks_launches.value
    return c


def reset_counts() -> None:
    from repro_torch.kernels import bitmap_filter
    for c in kernel_counts().values():
        c.reset()
    bitmap_filter.blocks_launches.reset()


def add_counts(total: dict) -> dict:
    """Add the launch counts since the last reset to ``total``; returns
    them."""
    c = counts()
    for k, v in c.items():
        total[k] = total.get(k, 0) + v
    return c


def bitmap_entries(c: dict) -> str:
    """bitmap_filter's launches in ``c`` by entry point."""
    return (f"bitmap_filter per block {c['bitmap_filter'] - c[ENTRY]}, "
            f"list {c[ENTRY]}")


def check_list_launches(what: str, delta: dict, probes: int) -> None:
    """The launch counts ``delta`` of a template's batches hold exactly one
    launch of bitmap_filter's list entry point for each of the ``probes``
    ``ZOrderIndex.bitmap`` calls that listed a block, and no per-block
    launch."""
    check(probes > 0 and delta[ENTRY] == probes
          and delta["bitmap_filter"] == delta[ENTRY],
          f"{what}: {probes} Z-order probes listed a block, launches "
          f"{bitmap_entries(delta)}")


def same_bits(a, b) -> bool:
    """Two tensors hold the same values bit for bit."""
    import torch
    a, b = a.detach().cpu().contiguous(), b.detach().cpu().contiguous()
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return bool(torch.equal(a, b))


# ---------------------------------------------------------------------------
# timing and comparison helpers
# ---------------------------------------------------------------------------

def cuda_ms(fn, reps: int = 20, warm: int = 3) -> float:
    """Mean device time of ``fn`` over ``reps`` calls (CUDA events)."""
    import torch
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def kernel_ms(fn, kernel, reps: int = 20, warm: int = 3) -> float:
    """Mean device time per call of ``fn`` of the kernel named ``kernel``
    (or of each of a tuple of names, summed; None: every kernel the call
    launches) over ``reps`` calls, from a ``torch.profiler`` trace: the
    kernels' own time, without the wrapper's allocations and the host's
    launch cost that a few-microsecond kernel's CUDA-event time is mostly
    made of.  Fails if no trace of three holds one launch of each named
    kernel a call (a trace can miss a few kernel records)."""
    return traced(fn, lambda spans: span_ms(spans, kernel, reps), reps, warm)


def kernel_parts(fn, names=None, reps: int = 20, warm: int = 3) -> dict:
    """Mean device milliseconds per call of ``fn`` of each kernel in
    ``names`` (by default ``FUSED_KERNELS``), all from one trace
    (``span_parts``): the launches of one call apart, and in sum what the
    call costs the card.  Traces up to three times, as ``kernel_ms``."""
    names = FUSED_KERNELS if names is None else names
    return traced(fn, lambda spans: span_parts(spans, names, reps), reps,
                  warm)


def traced(fn, measure, reps: int, warm: int):
    """``measure`` of the device spans of ``reps`` calls of ``fn``, after
    ``warm`` calls, from the first of up to three traces it does not fail
    on."""
    import torch
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    for attempt in range(3):
        try:
            return measure(trace_spans(fn, reps))
        except SmokeFailure as e:
            if attempt == 2:
                raise
            log(f"trace: {e}; tracing again")


def trace_spans(fn, reps: int):
    """(name, microseconds) of every device event in a ``torch.profiler``
    trace of ``reps`` calls of ``fn``.  The trace's window opens
    ``TRACE_PAD_S`` before the first call and closes as long after the
    last launch has finished: the profiler drops a device event whose
    time, converted to the host's clock, falls outside the window, and
    traces that end at the last launch have lost all or part of it."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        time.sleep(TRACE_PAD_S)
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        time.sleep(TRACE_PAD_S)
    return [(e.name, e.time_range.end - e.time_range.start)
            for e in prof.events()
            if getattr(e, "device_type", None) == DeviceType.CUDA]


def span_ms(spans, kernel, reps: int) -> float:
    """Mean milliseconds per call of the (name, microseconds) device spans
    of ``reps`` calls that belong to ``kernel`` (a name, a tuple of names,
    or None for every kernel but copies and fills).  Each named kernel must
    hold exactly ``reps`` spans."""
    if kernel is None:
        us = [t for n, t in spans if not n.startswith(("Memcpy", "Memset"))]
        check(len(us) >= reps, f"the trace holds {len(us)} kernel spans for "
              f"{reps} calls")
        return sum(us) / reps / 1e3
    total = 0.0
    for name in ((kernel,) if isinstance(kernel, str) else kernel):
        us = [t for n, t in spans if name in n]
        check(len(us) == reps, f"the trace holds {len(us)} launches of "
              f"{name}, not {reps}")
        total += sum(us)
    return total / reps / 1e3


def span_parts(spans, names, reps: int) -> dict:
    """Mean milliseconds per call of each of ``names`` over the (name,
    microseconds) device spans of ``reps`` calls.  Each name must hold
    exactly ``reps`` spans, and every span of the trace (kernels, fills,
    memsets and copies alike) must belong to one of them, so that their
    sum is every launch a call makes."""
    parts = {}
    for name in names:
        us = [t for n, t in spans if name in n]
        check(len(us) == reps, f"the trace holds {len(us)} launches of "
              f"{name}, not {reps}")
        parts[name] = sum(us) / reps / 1e3
    other = sorted({n for n, _ in spans if not any(k in n for k in names)})
    check(not other, f"a call also runs {other}")
    return parts


def row_bound(nbytes: float, flops: float):
    """(bound ms, what bounds it) for work of ``nbytes`` and ``flops``."""
    tb, tf = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS
    return max(tb, tf) * 1e3, ("bytes" if tb >= tf else "operations")


def round_bound(d: int, m: float, d2max: float) -> float:
    """Worst-case fp32 rounding of one squared distance computed by the
    expansion |q|^2 - 2 q.x + |x|^2 over d terms, the formula of the kernels
    and of their plain versions.  Each of the three length-d sums rounds by
    at most d u times the sum of its terms' magnitudes, which, with
    2 |q.x| <= |q|^2 + |x|^2, is 2 d u m in all for m = |q|^2 + |x|^2; the
    two additions add 2 u m, and a score's sqrt and re-squaring at most
    3 u d2.  u = 2^-24, fp32's unit roundoff."""
    return FP32_U * ((2 * d + 2) * m + 3 * d2max)


def exact_topk(q64, x64, adm, pks, k: int):
    """The exact answer for one query on the card: float64 d2 in the
    difference form over the admitted rows (``adm`` bool (n,) or None),
    the k smallest by (d2, pk).  Returns host (d2, pks, rows)."""
    import torch
    d2 = ((x64 - q64) ** 2).sum(dim=1)
    if adm is not None:
        d2 = torch.where(adm, d2, torch.full_like(d2, float("inf")))
    kk = min(k, int(torch.isfinite(d2).sum()))
    if kk == 0:
        return np.zeros(0), np.zeros(0, np.int64), np.zeros(0, np.int64)
    kth = torch.topk(d2, kk, largest=False).values[-1]
    rows = torch.nonzero(d2 <= kth).flatten()   # every row tied at the k-th
    cd = d2[rows].cpu().numpy()
    cp = pks[rows].cpu().numpy().astype(np.int64)
    rows = rows.cpu().numpy()
    order = np.lexsort((cp, cd))[:kk]
    return cd[order], cp[order], rows[order]


def tie_aware(f, fp, fx, td, tp, tol: float) -> int:
    """Hold one top-k answer against the exact one.  ``f`` is the answer's
    reported d2 (+inf in empty slots, which come last), ``fp`` its pks and
    ``fx`` the exact d2 of the rows its filled slots name; ``td``/``tp``
    are the exact answer's d2 and pks, ascending by (d2, pk).  Checks (1)
    each reported d2 within ``tol`` of its row's exact d2; given that, an
    answer ranked by the reported d2 has (2) the j-th reported d2 within
    tol of the exact j-th, and (3) every pk in one answer and not the
    other with its exact d2 within tol of the reported k-th.  Raises on
    anything else; returns the number of such tie swaps."""
    f, fx, td = (np.asarray(a, np.float64) for a in (f, fx, td))
    fin = np.isfinite(f)
    check(len(fx) == int(fin.sum()), "one exact d2 per filled slot")
    check(int(fin.sum()) == len(td),
          f"answer holds {int(fin.sum())} rows, the exact one {len(td)}")
    check(not fin[len(td):].any() and fin[:len(td)].all(),
          "empty slots out of place")
    if not len(td):
        return 0
    f, fp = f[fin], np.asarray(fp)[fin]
    err = np.abs(f - fx)
    check((err <= tol).all(), f"reported d2 is {err.max():.3g} from its "
          f"row's exact d2 > tol {tol:.3g}")
    err = np.abs(f - td)
    check((err <= tol).all(), f"j-th d2 is {err.max():.3g} from the exact "
          f"j-th > tol {tol:.3g}")
    dmap = dict(zip(np.asarray(tp).tolist(), td.tolist()))
    dmap.update(zip(fp.tolist(), fx.tolist()))
    only = set(fp.tolist()) ^ set(np.asarray(tp).tolist())
    for p in only:
        check(abs(dmap[p] - f[-1]) <= tol,
              f"pk {p} (exact d2 {dmap[p]:.9g}) is in one answer only and "
              f"not a tie of the k-th ({f[-1]:.9g}, tol {tol:.3g})")
    return len(only) // 2


# ---------------------------------------------------------------------------
# phase 1: build + edge checks
# ---------------------------------------------------------------------------

def fused_inputs(rng, nq, n, d, dev, mask_kind="partial", dup=False):
    """Packed-kernel inputs for a random case, prepared as the main path
    prepares them (``ops.fused_kernel_args``).  Mask kinds: ``partial``
    (30 % of rows), ``holes`` (every row but two whole blocks),
    ``sparse`` (0-6 rows a query, some queries none), ``rerank`` (40 rows
    a query, scattered, as an exact re-rank admits them), ``few`` (30 %,
    but query 1 admits 50 rows and query 2 none), ``nan`` (30 %, every
    query admits the NaN rows 7 and n // 2; query 0 admits 20 rows, both
    NaN rows among them), ``inf`` (30 %, rows 3 and 11 hold 1e20 in every
    feature, so their fp32 d2 overflows to +inf; every query admits them,
    query 0 60 rows in all), ``unsampled`` (half the rows at offsets 8-31
    of each 32-row group, none the scan's witnesses sample: the threshold
    stays +inf and full candidate regions are rescanned) and ``dup4``
    (every row one of 4 distinct vectors: d2 ties at the threshold)."""
    from repro_torch.kernels import ops
    q = rng.normal(size=(nq, d)).astype(np.float32)
    x = rng.normal(size=(n, d)).astype(np.float32)
    if dup:                       # equal d2 with distinct pks
        x[1::2] = x[0::2][:len(x[1::2])]
    if mask_kind == "dup4":
        x = x[rng.integers(0, 4, n)]
    mask = fused_mask(rng, nq, n, mask_kind)
    if mask_kind == "nan":
        x[[7, n // 2]] = np.nan
    elif mask_kind == "inf":
        x[[3, 11]] = 1e20
    pks = rng.permutation(n).astype(np.int64) * 3 + 1
    return ops.fused_kernel_args(q, x, mask, pks, dev)[0]


def fused_mask(rng, nq, n, kind):
    """The (nq, n) bool mask of ``fused_inputs``' mask kind ``kind``."""
    from repro_torch.kernels import fused_scan as fs
    if kind in ("partial", "few", "nan", "inf"):
        mask = rng.random((nq, n)) < 0.3
    elif kind in ("holes", "dup4"):
        mask = np.ones((nq, n), bool)
        mask[:, :fs.BLOCK_N] = False
        mask[:, n // 2:n // 2 + fs.BLOCK_N] = False
    elif kind == "rerank":
        mask = np.zeros((nq, n), bool)
        for qi in range(nq):
            mask[qi, rng.choice(n, size=40, replace=False)] = True
    elif kind == "unsampled":
        mask = (rng.random((nq, n)) < 0.5) & (np.arange(n) % 32 >= 8)
    else:                         # "sparse": few rows, some queries none
        mask = np.zeros((nq, n), bool)
        for qi in range(nq):
            if qi % 3:
                mask[qi, rng.choice(n, size=qi % 7, replace=False)] = True
    if kind == "few":
        mask[1] = False
        mask[1, rng.choice(n, size=50, replace=False)] = True
        mask[2] = False
    elif kind == "nan":
        mask[:, [7, n // 2]] = True
        mask[0] = False
        rest = np.setdiff1d(np.arange(n), [7, n // 2])
        mask[0, rng.choice(rest, size=18, replace=False)] = True
        mask[0, [7, n // 2]] = True
    elif kind == "inf":
        mask[:, [3, 11]] = True
        mask[0] = False
        mask[0, rng.choice(np.arange(12, n), size=58, replace=False)] = True
        mask[0, [3, 11]] = True
    return mask


# fused_scan_topk edge cases (nq, n, d, mask kind, duplicate rows): ragged
# n and query counts, d in {2, 4, 8, 16, 37, 128, MAX_DIM} (d % 4 != 0
# copies x 4 bytes at a time; d = 4096 leaves room for one scan block an
# SM), whole-block holes, empty queries, a re-rank's 40 rows a query
# over 262,144 rows, a query under 128 admitted rows, NaN and +inf d2
# rows, ties (pairs, and 4 distinct rows at the threshold) and a mask the
# witnesses never sample (threshold +inf: regions overflow and rescan)
FUSED_EDGE = [(3, 1000, 16, "partial", False), (13, 1537, 128, "holes", False),
              (10, 2048, 8, "sparse", False), (8, 1100, 4, "partial", True),
              (16, 600, 2, "partial", True), (8, 4096, 4096, "partial", False),
              (8, 262_144, 128, "rerank", False), (8, 5000, 64, "few", False),
              (8, 3000, 32, "nan", False), (8, 3000, 32, "inf", False),
              (8, 262_144, 24, "unsampled", False),
              (8, 65_536, 16, "dup4", False),
              (9, 20_000, 37, "partial", True)]


def fused_plain(args):
    """The plain version of the packed kernel on the same inputs, and the
    compacted (x, mask) it scans."""
    from repro_torch.kernels import fused_scan as fs
    xk, mk, _ = fs.compact(*args[1:5])
    return fs.plain(*args[:5]), (xk, mk)


def fused_compare(args, out, plain) -> tuple:
    """Hold the kernel's and the plain version's answers against the exact
    one (``tie_aware``, per query at ``round_bound`` over the rows either
    names).  Rows whose fp32 d2 is not finite are held apart: a NaN one
    never enters an answer (the plain version, which sorts every kept row
    at once, returns it after the empty slots, so it is read with its NaN
    slots empty: ``nan_as_empty``); a +inf one (its d2 overflowed) follows
    the finite rows, before the empty slots, in (pk, row) order, as the
    TPU kernel's sort on (d2, pk) puts it: both answers must hold exactly
    those.  Returns (max |d2 kernel - d2 plain| over finite slots, tie
    swaps, median tol / k-th d2 over queries with a full answer); raises
    on a disagreement or on a kernel order that is not strict."""
    import torch
    from repro_torch.kernels import fused_scan as fs
    from repro_torch.kernels import ref
    q, d = args[0], args[0].shape[1]
    xk, mk, pk = fs.compact(*args[1:5])
    d32 = ref.ivf_scan_ref(q, xk)
    adm = mk.bool()
    over = adm & torch.isposinf(d32)            # admitted, d2 overflowed
    adm = adm & torch.isfinite(d32)
    plain = nan_as_empty(*plain)
    x64, q64 = xk.double(), q.double()
    xn = (x64 ** 2).sum(dim=1)
    kd, kp, ki = (t.cpu().numpy() for t in out)
    rd, rp, ri = (t.cpu().numpy() for t in plain)
    pk_h = pk[0].cpu().numpy().astype(np.int64)
    err, swaps, power = 0.0, 0, []
    for qi in range(len(kd)):
        td, tp, trow = exact_topk(q64[qi], x64, adm[qi], pk[0], fs.KMAX)
        kf, rf = np.isfinite(kd[qi]), np.isfinite(rd[qi])
        nf = len(td)
        orow = torch.nonzero(over[qi]).flatten().cpu().numpy()
        orow = orow[np.lexsort((orow, pk_h[orow]))][:fs.KMAX - nf]
        no = len(orow)
        for name, (dd, pp, rr) in (("kernel", (kd, kp, ki)),
                                   ("plain version", (rd, rp, ri))):
            check(bool(np.isposinf(dd[qi][nf:nf + no]).all())
                  and np.array_equal(pp[qi][nf:nf + no], pk_h[orow])
                  and np.array_equal(rr[qi][nf:nf + no], orow),
                  f"{name}: the rows whose d2 overflowed are not the "
                  f"{no} after the finite ones, in pk order")
            check(bool((pp[qi][nf + no:] == ref.SENTINEL).all()),
                  f"{name}: a row past the admitted ones")
        rows = np.concatenate([ki[qi][kf], ri[qi][rf], trow]).astype(np.int64)
        if not len(rows):
            check(not kf.any() and not rf.any(), "answer where none is due")
            continue
        rt = torch.as_tensor(rows, device=q.device)
        ex = ((x64[rt] - q64[qi]) ** 2).sum(dim=1).cpu().numpy()
        m = float((q64[qi] ** 2).sum()) + float(xn[rt].max())
        tol = round_bound(d, m, float(ex.max()))
        nk, nr = int(kf.sum()), int(rf.sum())
        swaps += tie_aware(kd[qi], kp[qi], ex[:nk], td, tp, tol)
        tie_aware(rd[qi], rp[qi], ex[nk:nk + nr], td, tp, tol)
        if len(td) == fs.KMAX:
            power.append(tol / td[-1] if td[-1] > 0 else float("inf"))
        if kf.any():
            err = max(err, float(np.abs(kd[qi][kf] - rd[qi][kf]).max()))
        # the kernel's own order is exact: (d2, pk, row)
        for j in range(nk + no - 1):
            a = (kd[qi][j], kp[qi][j], ki[qi][j])
            b = (kd[qi][j + 1], kp[qi][j + 1], ki[qi][j + 1])
            check(a < b, f"kernel order broken at slot {j}: {a} {b}")
    return err, swaps, float(np.median(power)) if power else float("nan")


def ivf_compare(q, x, out, plain) -> float:
    """Hold the kernel's and the plain version's distance matrices against
    the float64 one, element by element at ``round_bound``; returns
    max |kernel - plain| over finite elements."""
    o, p = out.cpu().numpy(), plain.cpu().numpy()
    check((np.isfinite(o) == np.isfinite(p)).all(), "ivf_scan inf slots")
    fin = np.isfinite(p)
    if not fin.any():
        return 0.0
    q64, x64 = q.double(), x.double()
    qn = (q64 ** 2).sum(1)[:, None]
    xn = (x64 ** 2).sum(1)[None, :]
    ex = (qn - 2.0 * (q64 @ x64.T) + xn).cpu().numpy()[fin]
    tol = FP32_U * ((2 * q.shape[1] + 2) * (qn + xn).cpu().numpy()[fin]
                    + 3 * np.abs(ex))
    for name, v in (("kernel", o[fin]), ("plain version", p[fin])):
        e = np.abs(v - ex)
        check((e <= tol).all(), f"ivf_scan {name} is {e.max():.3g} from "
              f"the float64 distances (tol {tol[e.argmax()]:.3g})")
    return float(np.abs(o[fin] - p[fin]).max())


# ivf_scan edge shapes (nq, n, d, 1e30 pad rows): every launch path, query
# counts on both sides of the skinny path's 8 (1, 8, 9, 64, 2048), ragged
# n, d in {2, 7, 16, 100, 128}
IVF_EDGE = [(3, 1000, 100, False), (1, 128, 7, False), (9, 512, 128, True),
            (2048, 512, 128, True), (1, 1537, 128, True), (8, 4099, 2, False),
            (8, 512, 16, True), (64, 700, 16, True), (2048, 333, 2, False),
            (8, 2048, 128, True)]


def ivf_paths(shapes) -> set:
    """The ivf_scan launch paths a list of (nq, n, d, ...) shapes reaches."""
    from repro_torch.kernels import ivf_scan
    return {ivf_scan.launch_path(s[0], s[1], s[2]) for s in shapes}


def hold_plain(kind, key, x, y, out) -> float:
    """Hold one path call's output of ivf_scan, bitmap_filter or pq_adc
    against the plain version on the same inputs: ivf_scan within
    ``ivf_compare``'s bound (returns max |kernel - plain|), the other two
    bitwise (returns 0.0)."""
    from repro_torch.kernels import ref
    if kind == "ivf":
        return ivf_compare(x, y, out, ref.ivf_scan_ref(x, y))
    if kind == "pq":
        check(same_bits(out, ref.pq_adc_ref(x, y)), f"pq_adc main-path "
              f"input {key}: differs from the plain version")
        return 0.0
    bad = int((out.bool() != ref.bitmap_filter_ref(x, y)).sum())
    check(bad == 0, f"bitmap_filter main-path input {key}: {bad} rows "
          f"differ")
    return 0.0


def hold_list(key, a, out) -> float:
    """Hold one call of bitmap_filter's list entry point against its
    plain version on the same inputs, bitwise; returns 0.0."""
    from repro_torch.kernels import ref
    bad = int((out.bool() != ref.bitmap_filter_blocks_ref(*a)).sum())
    check(bad == 0, f"bitmap_filter_blocks input {key}: {bad} mask rows "
          f"differ from the plain version")
    return 0.0


def list_case(rng, n: int, kind: str, dev):
    """A random input of bitmap_filter's list entry point: n points in
    [0, 100]^2 in 128-point blocks, a row-id permutation, a rectangle
    whose corners are two points' own values, and a block list:
    ``empty``; ``partial`` (blocks 0, 2, ... and the partial last one);
    ``every`` block; ``nan`` (every block, every 7th point NaN in x and
    every 14th in y); ``repeat`` (repeated ids, and -1 and nb, which the
    kernel skips).  Returns the wrapper's arguments."""
    import torch
    from repro_torch.core.types import BLOCK_ROWS
    pts = rng.uniform(0, 100, (n, 2)).astype(np.float32)
    lo = np.minimum(pts[0], pts[n // 3])
    hi = np.maximum(pts[0], pts[n // 3])
    bounds = np.stack([[lo[0], hi[0]], [lo[1], hi[1]]]).astype(np.float32)
    if kind == "nan":
        pts[::7, 0] = np.nan
        pts[3::14, 1] = np.nan
    nb = -(-n // BLOCK_ROWS)
    blocks = {"empty": [], "partial": list(range(0, nb - 1, 2)) + [nb - 1],
              "every": range(nb), "nan": range(nb),
              "repeat": [nb - 1, 0, nb - 1, -1, nb, 1, 1]}[kind]
    return (torch.from_numpy(pts).to(dev),
            torch.from_numpy(rng.permutation(n).astype(np.int32)).to(dev),
            torch.as_tensor(np.asarray(blocks, np.int32), device=dev),
            torch.from_numpy(bounds).to(dev), n, BLOCK_ROWS)


# list entry point edge cases (points, block list): a partial last block
# (1,000 = 7 x 128 + 104), every block of a 2,097,152-point segment
LIST_EDGE = [(1000, "empty"), (1000, "partial"), (2_097_152, "every"),
             (5000, "nan"), (4099, "repeat")]


def edge_checks(dev, errs) -> None:
    import torch
    from repro_torch.kernels import bitmap_filter, fused_scan, ivf_scan, ref
    rng = np.random.default_rng(0)
    for nq, n, d, kind, dup in FUSED_EDGE:
        args = fused_inputs(rng, nq, n, d, dev, kind, dup)
        out = fused_scan.fused_scan_topk(*args)
        torch.cuda.synchronize()
        plain, _ = fused_plain(args)
        err, swaps, power = fused_compare(args, out, plain)
        errs["fused_scan_topk"] = max(errs["fused_scan_topk"], err)
        log(f"edge fused_scan_topk nq={nq} n={n} d={d} mask={kind} "
            f"ties={dup}: max|dd2|={err:.3g} tie swaps={swaps} "
            f"median tol/kth d2={power:.3g}")
    check(ivf_paths(IVF_EDGE) == set(ivf_scan.PATHS),
          "the ivf_scan edge shapes miss a launch path")
    for nq, n, d, padded in IVF_EDGE:
        q = rng.normal(size=(nq, d)).astype(np.float32)
        x = rng.normal(size=(n, d)).astype(np.float32)
        if padded:                # host padding rows, as ops pads them
            x[n // 3:] = 1e30
        qt, xt = torch.from_numpy(q).to(dev), torch.from_numpy(x).to(dev)
        out = ivf_scan.ivf_scan(qt, xt)
        torch.cuda.synchronize()
        err = ivf_compare(qt, xt, out, ref.ivf_scan_ref(qt, xt))
        if padded:
            check(bool(torch.isinf(out[:, n // 3:]).all()),
                  "1e30 padding rows must come out +inf")
        errs["ivf_scan"] = max(errs["ivf_scan"], err)
        log(f"edge ivf_scan nq={nq} n={n} d={d} padded={padded} "
            f"({ivf_scan.launch_path(nq, n, d)}): max|dd2|={err:.3g}")
    for n, c in [(4099, 3), (1_000_003, 1), (1025, 2)]:
        cols = rng.uniform(0, 10, (n, c)).astype(np.float32)
        cols[::97] = np.nan
        cols[::89, 0] = np.inf
        bounds = np.sort(rng.uniform(0, 10, (c, 2)), axis=1).astype(
            np.float32)
        bounds[0] = [-np.inf, 5.0]
        ct, bt = torch.from_numpy(cols).to(dev), torch.from_numpy(bounds).to(dev)
        out = bitmap_filter.bitmap_filter(ct, bt).cpu().numpy()
        want = ref.bitmap_filter_ref(ct, bt).cpu().numpy()
        bad = int((out.astype(bool) != want).sum())
        check(bad == 0, f"bitmap_filter: {bad} rows differ")
        log(f"edge bitmap_filter n={n} c={c}: 0 rows differ, "
            f"{int(want.sum())} pass")
    for n, kind in LIST_EDGE:
        a = list_case(rng, n, kind, dev)
        before = bitmap_filter.blocks_launches.value
        out = bitmap_filter.bitmap_filter_blocks(*a)
        torch.cuda.synchronize()
        hold_list((n, kind), a, out)
        launched = bitmap_filter.blocks_launches.value - before
        check(launched == (kind != "empty"), f"bitmap_filter_blocks "
              f"{kind}: {launched} launches")
        log(f"edge bitmap_filter_blocks n={n} blocks={kind} "
            f"({a[2].numel()} listed, {launched} launch): bitwise equal to "
            f"the plain version, {int(out.sum())} rows set")


def adc_case(rng, nq, n, m, kind):
    """A random quantized case: queries, codes, codebooks, bitmap, pks.
    ``dup`` draws every row from 4 code rows (ADC ties that must break by
    pk); ``tile_empty`` leaves the first query tile with no row (the
    occupancy skip); ``holes`` masks whole blocks for every query."""
    q = rng.normal(size=(nq, 4 * m)).astype(np.float32)
    books = rng.normal(size=(m, 256, 4)).astype(np.float32)
    codes = rng.integers(0, 256, (n, m), dtype=np.uint8)
    if kind == "dup":
        codes = codes[rng.integers(0, 4, n)]
    mask = rng.random((nq, n)) < 0.3
    if kind == "full":
        mask[:] = True
    elif kind == "tile_empty":
        mask[:8] = False
    elif kind == "holes":
        mask[:] = True
        mask[:, :512] = False
        mask[:, n // 2:n // 2 + 512] = False
    elif kind == "nan":
        # NaN ADC values: every row of query 0 (all admitted), and the rows
        # whose first code is below 64 for the others
        q[0] = np.nan
        books[0, :64] = np.nan
        mask[0] = True
    pks = rng.permutation(n).astype(np.int64) * 3 + 1
    return q, codes, books, mask, pks


def nan_as_empty(d, p, r):
    """A plain scan version's (score, pks, rows) — quantized ADC or fused
    d2 — with its NaN slots taken as empty ones (+inf, SENTINEL,
    SENTINEL).  A row whose score is NaN never enters a kernel's answer,
    as it never enters the TPU kernel's running list, which starts with
    KMAX empty slots that order before it.  The plain version sorts every
    kept row at once, so it returns such rows after the unadmitted rows'
    empty slots.  NaN sorts last, so only trailing slots change."""
    import torch
    from repro_torch.kernels import ref
    nan = torch.isnan(d)
    sent = torch.full_like(p, ref.SENTINEL)
    return (torch.where(nan, torch.full_like(d, float("inf")), d),
            torch.where(nan, sent, p), torch.where(nan, sent, r))


# quantized scan edge cases (nq, n, m, kind of ``adc_case``)
ADC_EDGE = [(8, 1000, 8, "partial"), (13, 1537, 16, "holes"),
            (16, 1, 4, "full"), (16, 2048, 8, "tile_empty"),
            (8, 1100, 8, "dup"), (10, 700, 4, "partial"),
            (8, 262_144, 8, "partial"), (8, 262_144, 8, "dup"),
            (16, 131_072, 8, "holes"), (8, 1000, 8, "nan"),
            (16, 262_144, 8, "nan")]


def adc_edge_checks(dev, errs) -> None:
    """The two ADC kernels against their plain versions, bitwise: the
    quantized scan through the main path's host prep (wrapper level, all
    KMAX slots) and through ``ops`` at k' in {1, 40, 128} against the same
    host logic over the plain version, NaN ADC values taken as empty slots
    (``nan_as_empty``); the single-query ADC at ragged shapes."""
    import torch
    from repro_torch.kernels import ops, pq_adc, quantized_scan, ref
    rng = np.random.default_rng(1)
    host = torch.device("cpu")
    for nq, n, m, kind in ADC_EDGE:
        q, codes, books, mask, pks = adc_case(rng, nq, n, m, kind)
        lut = ops.adc_lut(q, books)
        args, _ = ops.quantized_kernel_args(lut, codes, mask, pks, dev)
        out = quantized_scan.quantized_scan_topk(*args)
        torch.cuda.synchronize()
        plain = nan_as_empty(*quantized_scan.plain(*args[:5]))
        for a, b, what in zip(out, plain, ("adc", "pks", "rows")):
            check(same_bits(a, b), f"quantized_scan_topk {what} differ from "
                  f"the plain version (nq={nq} n={n} m={m} {kind})")
        kd, kp = out[0].cpu().numpy(), out[1].cpu().numpy()
        ties = 0
        for qi in range(nq):
            eq = kd[qi, 1:] == kd[qi, :-1]
            fin = np.isfinite(kd[qi, 1:])
            ties += int((eq & fin).sum())
            check(bool((kp[qi, 1:][eq & fin] > kp[qi, :-1][eq & fin]).all()),
                  "quantized_scan_topk: equal ADC not in pk order")
        if kind == "dup":
            check(ties > 0, "the duplicate-code case made no ADC ties")
        for k in (1, 40, 128):
            gd, gr = ops.quantized_scan_topk(q, codes, books, mask, pks, k,
                                             device=dev)
            wd, wr = ops._quantized_kernel(lut, codes, mask, pks, k, host)
            wr = np.where(np.isnan(wd), -1, wr)     # as nan_as_empty
            wd = np.where(np.isnan(wd), np.float32(np.inf), wd)
            check(np.array_equal(gd.view(np.uint32), wd.view(np.uint32))
                  and np.array_equal(gr, wr),
                  f"ops.quantized_scan_topk k'={k} differs from the plain "
                  f"version (nq={nq} n={n} m={m} {kind})")
        log(f"edge quantized_scan_topk nq={nq} n={n} m={m} mask={kind}: "
            f"bitwise equal to the plain version (wrapper and k' in 1, 40, "
            f"128), ADC ties {ties}")
    for n, m, dup in [(1, 8, False), (1000, 4, False), (4099, 16, True),
                      (1_000_003, 8, False)]:
        codes = rng.integers(0, 256, (n, m), dtype=np.uint8)
        if dup:
            codes = codes[rng.integers(0, 3, n)]
        lut = (rng.normal(size=(m, 256)) ** 2).astype(np.float32)
        ct, lt = torch.from_numpy(codes).to(dev), torch.from_numpy(lut).to(dev)
        out = pq_adc.pq_adc(ct, lt)
        torch.cuda.synchronize()
        check(same_bits(out, ref.pq_adc_ref(ct, lt)),
              f"pq_adc differs from the plain version (n={n} m={m})")
        log(f"edge pq_adc n={n} m={m} dup={dup}: bitwise equal to the plain "
            f"version")
    errs["quantized_scan_topk"] = errs["pq_adc"] = 0.0


def merge_case(rng, nq, s, kk, kind):
    """Candidate lists for the merges: scores with ``ties`` (few distinct
    values, so ids and positions break them) or ``pads`` (+inf slots with
    SENTINEL ids), ids a permutation."""
    from repro_torch.kernels import ref
    d = rng.uniform(0, 10, (nq, s, kk)).astype(np.float32)
    if kind == "ties":
        d = np.floor(d / 3).astype(np.float32)
    ids = rng.permutation(nq * s * kk).reshape(nq, s, kk).astype(np.int64)
    if kind == "pads":
        pad = rng.random((nq, s, kk)) < 0.4
        d[pad] = np.inf
        ids[pad] = ref.SENTINEL
    return d, ids


def merge_edge_checks(dev) -> None:
    """The two merge kernels against their plain versions, bitwise, on
    the card and on the host: ties on score, +inf pads, k = 1, k = s * kk,
    k > 128 (k = 300), s = 1, and lists too long for shared memory (the
    kernel reads them from global memory); the single-list merge with
    int32 and int64 ids."""
    import torch
    from repro_torch.kernels import ref, topk_merge
    rng = np.random.default_rng(2)
    host = torch.device("cpu")
    for nq, s, kk, k, kind in [(4, 3, 6, 5, "ties"), (8, 4, 10, 10, "pads"),
                               (8, 4, 10, 1, "plain"), (8, 4, 10, 40, "ties"),
                               (8, 4, 300, 300, "ties"), (5, 1, 7, 7, "pads"),
                               (3, 8, 8000, 200, "ties"),
                               (2, 2, 3, 6, "pads")]:
        d, ids = merge_case(rng, nq, s, kk, kind)
        dt = torch.from_numpy(d).to(dev)
        it = torch.from_numpy(ids.astype(np.int32)).to(dev)
        out = topk_merge.batched_topk_merge(dt, it, k)
        torch.cuda.synchronize()
        for where, want in (("card", ref.batched_topk_merge_ref(dt, it, k)),
                            ("host", ref.batched_topk_merge_ref(
                                dt.to(host), it.to(host), k))):
            check(same_bits(out[0], want[0]) and same_bits(out[1], want[1]),
                  f"batched_topk_merge differs from the plain version on "
                  f"the {where} (nq={nq} s={s} kk={kk} k={k} {kind})")
        log(f"edge batched_topk_merge nq={nq} s={s} kk={kk} k={k} {kind}: "
            f"bitwise equal to the plain version (card and host)")
        for id_type in (torch.int32, torch.int64):
            d1 = dt[0]
            i1 = torch.from_numpy(ids[0]).to(dev, id_type)
            k1 = min(k, d1.numel())
            out = topk_merge.topk_merge(d1, i1, k1)
            torch.cuda.synchronize()
            want = ref.topk_merge_ref(d1.to(host), i1.to(host), k1)
            check(same_bits(out[0], want[0]) and same_bits(out[1], want[1]),
                  f"topk_merge differs from the plain version (s={s} "
                  f"kk={kk} k={k1} {kind} {id_type})")
        log(f"edge topk_merge s={s} kk={kk} k={min(k, s * kk)} {kind}: "
            f"bitwise equal to the plain version (int32 and int64 ids)")


def graph_case(rng, nq, n, d, r_deg, n_ent, kind):
    """A random packed CSR case as the wrapper takes it: ``ints`` draws
    small-integer vectors (every sum exact) and pks with duplicates
    ((d2, pk) ties that break by position), ``floats`` normal vectors,
    ``nan`` normal vectors with one row in 16 holding a NaN feature (a
    NaN d2, which sorts after every number and enters no beam); a quarter
    of the adjacency is -1 padding; query 0 admits no row."""
    from repro_torch.kernels import ref
    if kind == "ints":
        q = rng.integers(-3, 4, (nq, d)).astype(np.float32)
        x = rng.integers(-3, 4, (n, d)).astype(np.float32)
        pks = (np.arange(n, dtype=np.int32) // 3)[None, :]
    else:
        q = rng.normal(size=(nq, d)).astype(np.float32)
        x = rng.normal(size=(n, d)).astype(np.float32)
        pks = (np.arange(n, dtype=np.int32) * 7 + 3)[None, :]
    if kind == "nan":
        x[rng.random(n) < 1 / 16, d // 2] = np.nan
    nbr = rng.integers(0, n, (n, r_deg)).astype(np.int32)
    nbr[rng.random((n, r_deg)) < 0.25] = -1
    mask = (rng.random((nq, n)) < 0.3).astype(np.uint8)
    mask[0] = 0
    ent = np.full((1, max(8, n_ent)), ref.SENTINEL, np.int32)
    ent[0, :n_ent] = rng.choice(n, n_ent, replace=False)
    return q, x, nbr, ent, mask, pks


# graph_search_topk's edge cases (nq, n, d, R, beam, hops, entries, kind):
# exact sums with tied pks, random floats, R 4, entries > beam, hops 0, the
# widest beam; a walk that stops adding rows before its last hop (96 rows
# under a beam of 128); NaN rows; d 13 and 67 (4-byte staging, a partial
# feature tile); 4,096 entries (a capacity of 4,096) and R 64 under a beam
# of 128 (8,192, staged in tiles of 64 rows); GRAPH_SMEM_ROWS, the most
# rows whose visited words the kernel keeps in shared memory at that
# shape; 2,097,152
# rows (256 KB of visited words a query in global memory, 64-bit row
# offsets), on a random CSR that needs no graph build
GRAPH_SMEM_ROWS = 560_768
GRAPH_EDGE = [(8, 512, 16, 8, 32, 4, 5, "ints"),
              (8, 1024, 16, 16, 64, 4, 5, "floats"),
              (16, 512, 12, 4, 40, 4, 5, "ints"),
              (8, 512, 12, 8, 8, 3, 20, "floats"),
              (8, 512, 16, 8, 8, 0, 5, "ints"),
              (8, 8192, 128, 16, 128, 12, 136, "floats"),
              (8, 96, 16, 8, 128, 12, 5, "ints"),
              (8, 2048, 32, 16, 40, 8, 5, "nan"),
              (8, 512, 13, 8, 32, 4, 5, "floats"),
              (8, 1024, 67, 16, 40, 6, 5, "floats"),
              (8, 8192, 128, 16, 40, 8, 4096, "floats"),
              (8, 8192, 128, 64, 128, 4, 5, "floats"),
              (8, GRAPH_SMEM_ROWS, 128, 16, 40, 8, 5, "floats"),
              (8, 2097152, 128, 16, 40, 8, 5, "floats")]
# the case whose walk must stop adding rows before its last hop
GRAPH_STOPS = (8, 96, 16, 8, 128, 12, 5, "ints")


def graph_compare(out, plain, what: str) -> None:
    for a, b, name in zip(out, plain, ("d2", "pks", "rows", "visited")):
        check(same_bits(a, b), f"graph_search_topk {name} differ from the "
              f"plain version ({what})")


def graph_edge_checks(dev) -> None:
    """The beam-search kernel against its plain version, all four outputs
    bitwise, on the card and on the host, at ``GRAPH_EDGE`` (the walk of
    ``GRAPH_STOPS`` shown to stop: its plain version's answer at one hop
    fewer is the same; ``GRAPH_SMEM_ROWS`` shown to be the most rows the
    wrapper keeps in shared memory, and the 2,097,152-row case to take the
    global-memory path); and through ``ops`` at a row count that is not a
    multiple of 32 against the same host logic over the plain version."""
    import torch
    from repro_torch.kernels import build, graph_search, ops, ref
    rng = np.random.default_rng(3)
    host = torch.device("cpu")
    limit = build.smem_per_block(dev)
    for case in GRAPH_EDGE:
        nq, n, d, r_deg, beam, hops, n_ent, kind = case
        args = [torch.from_numpy(a) for a in graph_case(
            rng, nq, n, d, r_deg, n_ent, kind)]
        dargs = [a.to(dev) for a in args]
        out = graph_search.graph_search_topk(*dargs, beam, hops)
        torch.cuda.synchronize()
        n_e = args[3].shape[1]
        path = graph_search.visited_path(n, d, beam, r_deg, n_e, limit)
        rows = graph_search.tile_rows(
            d, beam, graph_search.capacity(beam, r_deg, n_e), limit)
        what = (f"nq={nq} n={n} d={d} R={r_deg} beam={beam} hops={hops} "
                f"entries={n_ent} {kind}, visited words in {path} memory, "
                f"tiles of {rows} rows")
        plain = ref.graph_search_topk_ref(*args, beam, hops)
        graph_compare(out, ref.graph_search_topk_ref(*dargs, beam, hops),
                      what + ", card")
        graph_compare(out, plain, what + ", host")
        check(bool((out[2][0] == ref.SENTINEL).all()),
              "the all-masked query has a result")
        if case == GRAPH_STOPS:
            fewer = ref.graph_search_topk_ref(*args, beam, hops - 1)
            check(all(same_bits(a, b) for a, b in zip(plain, fewer)),
                  f"the walk of {what} adds rows in its last hop")
            what += ", its last hop adds no row"
        if n == GRAPH_SMEM_ROWS:
            check(path == "shared" and graph_search.visited_path(
                n + 32, d, beam, r_deg, n_e, limit) == "global",
                f"{n} rows is not the most whose visited words fit shared "
                f"memory at {what}")
        if n >= 2_097_152:
            check(path == "global", f"{what}: not the global-memory path")
        gathered = int(np.unpackbits(out[3].cpu().numpy().view(np.uint8),
                                     axis=1).sum())
        log(f"edge graph_search_topk {what}: d2, pks, rows and visited words "
            f"bitwise equal to the plain version (card and host); "
            f"{gathered} rows gathered")
    q, x, nbr, ent, mask, pks = graph_case(rng, 5, 700, 16, 8, 6, "floats")
    mask = mask.astype(bool)
    for beam, hops in ((24, 6), (128, 12)):
        got = ops.graph_search_topk(q, x, nbr, ent[0, :6], mask, pks[0],
                                    beam, hops, device=dev)
        want = ops._graph_kernel(q, x, nbr, ent[0, :6].astype(np.int64),
                                 mask, pks[0].astype(np.int64), beam, hops,
                                 host)
        check(all(np.array_equal(np.asarray(a).view(np.uint32)
                                 if a.dtype == np.float32 else a,
                                 np.asarray(b).view(np.uint32)
                                 if b.dtype == np.float32 else b)
                  for a, b in zip(got, want)),
              f"ops.graph_search_topk n=700 beam={beam} differs from the "
              f"plain version")
        log(f"edge ops.graph_search_topk n=700 beam={beam} hops={hops}: "
            f"d2, rows and gathered equal to the plain version")


# ---------------------------------------------------------------------------
# phase 2: the main path
# ---------------------------------------------------------------------------

class TracyData:
    """The TRACY tweet generator of ``benchmarks/tracy.py`` (topic-
    clustered embeddings, uniform points, topic words, uniform time, Zipf
    likes), drawn in bulk; it keeps every column for the brute force."""

    def __init__(self, dim: int, seed: int = 0, n_topics: int = 10):
        self.rng = np.random.default_rng(seed)
        self.dim = dim
        self.n_topics = n_topics
        self.centers = self.rng.normal(size=(n_topics, dim)).astype(
            np.float32)
        self.cols = {k: [] for k in ("embedding", "coordinate", "time",
                                     "t1", "t2")}

    def batch(self, pk0: int, n: int):
        """Rows pk0 .. pk0 + n - 1, kept for the brute force."""
        batch, t1, t2 = self.draw(n)
        for k, v in (("embedding", batch["embedding"]),
                     ("coordinate", batch["coordinate"]),
                     ("time", batch["time"]), ("t1", t1), ("t2", t2)):
            self.cols[k].append(v)
        return list(range(pk0, pk0 + n)), batch

    def draw(self, n: int):
        """n rows' columns, not kept: (batch, topic 1, topic 2)."""
        rng = self.rng
        t1 = rng.integers(0, self.n_topics, n)
        t2 = rng.integers(0, self.n_topics, n)
        w = rng.integers(0, 50, n)
        emb = (self.centers[t1] + 0.4 * rng.normal(size=(n, self.dim))
               ).astype(np.float32)
        pts = rng.uniform(0, 100, (n, 2)).astype(np.float32)
        words = np.asarray([f"{TOPICS[a]} {TOPICS[b]} w{c}"
                            for a, b, c in zip(t1, t2, w)], object)
        tm = rng.uniform(0, 1000, n)
        batch = {"embedding": emb, "coordinate": pts, "content": words,
                 "time": tm, "likes": rng.zipf(2.0, n).astype(np.float64)}
        return batch, t1, t2

    def finish(self):
        self.cols = {k: np.concatenate(v) for k, v in self.cols.items()}

    def query_vec(self):
        t = self.rng.integers(0, self.n_topics)
        return (self.centers[t] + 0.2 * self.rng.normal(size=self.dim)
                ).astype(np.float32)

    def rect(self, side):
        x, y = self.rng.uniform(0, 100 - side, 2)
        return (float(x), float(y), float(x + side), float(y + side))


def templates(data: TracyData):
    """The TRACY templates of the slice: (query, brute-force spec)."""
    from repro_torch.core import query as q
    d, cols = data, data.cols

    def time_mask(lo, hi):
        return (cols["time"] >= lo) & (cols["time"] <= hi)

    def text_mask(t):
        return (cols["t1"] == t) | (cols["t2"] == t)

    def geo_mask(r):
        p = cols["coordinate"]
        r32 = np.asarray(r, np.float32)
        return ((p[:, 0] >= r32[0]) & (p[:, 0] <= r32[2])
                & (p[:, 1] >= r32[1]) & (p[:, 1] <= r32[3]))

    def t2():
        lo, r = float(d.rng.uniform(0, 900)), d.rect(15)
        return (q.HybridQuery(where=q.And(q.Range("time", lo, lo + 50),
                                          q.GeoWithin("coordinate", r))),
                lambda: time_mask(lo, lo + 50) & geo_mask(r), None)

    def t4():
        lo = float(d.rng.uniform(0, 990))
        return (q.HybridQuery(where=q.Range("time", lo, lo + 2)),
                lambda: time_mask(lo, lo + 2), None)

    def t6():
        v = d.query_vec()
        return (q.HybridQuery(ranks=[q.VectorRank("embedding", v, 1.0)],
                              k=10), None, ("embedding", v))

    def t8():
        lo, v = float(d.rng.uniform(0, 800)), d.query_vec()
        return (q.HybridQuery(where=q.Range("time", lo, lo + 200),
                              ranks=[q.VectorRank("embedding", v, 1.0)],
                              k=10),
                lambda: time_mask(lo, lo + 200), ("embedding", v))

    def t10():
        x, y = d.rng.uniform(10, 90, 2)
        t = int(d.rng.integers(0, 10))
        p = np.asarray([x, y], np.float32)
        return (q.HybridQuery(where=q.TextContains("content", TOPICS[t]),
                              ranks=[q.SpatialRank("coordinate",
                                                   (float(x), float(y)),
                                                   1.0)], k=10),
                lambda: text_mask(t), ("coordinate", p))

    def t13():
        lo, t = float(d.rng.uniform(0, 800)), int(d.rng.integers(0, 10))
        v = d.query_vec()
        return (q.HybridQuery(where=q.Or(q.Range("time", lo, lo + 200),
                                         q.TextContains("content",
                                                        TOPICS[t])),
                              ranks=[q.VectorRank("embedding", v, 1.0)],
                              k=10),
                lambda: time_mask(lo, lo + 200) | text_mask(t),
                ("embedding", v))

    return {"t6": t6, "t8": t8, "t10": t10, "t13": t13, "t2": t2, "t4": t4}


def brute_nn(dev, xs, mask, qv, k, res):
    """Hold one NN answer (the executor's results) against the exact
    answer over the rows ``mask`` admits (numpy or a tensor on the card,
    None for every row), a plain PyTorch brute force on the card (row i
    holds pk i).
    Returns (tie swaps, tol / k-th d2 or None when nothing is admitted)."""
    import torch
    x64 = xs[qv.shape[0]]
    q64 = torch.from_numpy(qv.astype(np.float64)).to(dev)
    adm = mask if mask is None or isinstance(mask, torch.Tensor) \
        else torch.from_numpy(mask).to(dev)
    td, tp, _ = exact_topk(q64, x64, adm, torch.arange(len(x64), device=dev),
                           k)
    f = np.asarray([r.score for r in res], np.float64) ** 2
    fp = np.asarray([r.pk for r in res], np.int64)
    check(len(res) == len(td), f"{len(res)} results, {len(td)} admitted "
          f"rows within k")
    if not len(td):
        return 0, None
    rows = torch.as_tensor(np.concatenate([fp, tp]), device=dev)
    ex = ((x64[rows] - q64) ** 2).sum(dim=1)
    m = float((q64 ** 2).sum()) + float((x64[rows] ** 2).sum(dim=1).max())
    ex = ex.cpu().numpy()
    tol = round_bound(qv.shape[0], m, float(ex.max()))
    return tie_aware(f, fp, ex[:len(fp)], td, tp, tol), tol / td[-1]


def builder(table, query):
    """A ``HybridQuery`` as the ``QueryBuilder`` a user writes for it on
    ``table``."""
    b = table.query()
    if query.where is not None:
        b.where(query.where)
    return b.rank(*query.ranks, recall_target=query.recall_target) \
        .limit(query.k)


def tracy_store(dev, data: TracyData, rows: int, vector_index: str,
                flush_rows: int = 2048, fanout: int = 4,
                quantize: bool = True, shards: int = 1):
    """The TRACY tweet table (``benchmarks/tracy.py``'s schema at its
    published widths: 128-d embeddings with ``vector_index``, ZORDER
    points, INVERTED text, BTREE time and likes; by default flush_rows
    2048, fanout 4, pq_m 8) as the default table of a ``Database`` on
    ``dev`` (over ``shards`` shards), filled with ``rows`` rows through
    ``Table.put`` and ``flush``, in batches of at most ``flush_rows`` (as
    ``tracy.build_store`` feeds it).  Returns (database, ingest seconds)."""
    import torch
    from repro_torch.core.api import Database
    from repro_torch.core.lsm import LSMConfig
    from repro_torch.core.types import Column, ColumnType, IndexKind, Schema
    schema = Schema([
        Column("embedding", ColumnType.VECTOR, dim=data.dim,
               index=IndexKind[vector_index]),
        Column("coordinate", ColumnType.SPATIAL, index=IndexKind.ZORDER),
        Column("content", ColumnType.TEXT, index=IndexKind.INVERTED),
        Column("time", ColumnType.SCALAR, index=IndexKind.BTREE),
        Column("likes", ColumnType.SCALAR, index=IndexKind.BTREE)])
    cfg = LSMConfig(flush_rows=flush_rows, fanout=fanout, pq_m=8,
                    quantize_vectors=quantize)
    t0 = time.perf_counter()
    db = Database(schema, cfg, shards=shards, device=dev)
    table = db.table()
    done = 0
    while done < rows:
        n = min(2048, flush_rows, rows - done)
        pks, batch = data.batch(done, n)
        table.put(pks, batch)
        done += n
    table.flush()
    torch.cuda.synchronize()
    data.finish()
    return db, time.perf_counter() - t0


def main_path(dev, record):
    import torch
    dim, rows = 128, ROWS
    log(f"main path: TRACY tweet table, {rows} rows (paper: "
        f"{PAPER_ROWS}; cut to fit the run's time limit), dim={dim} "
        f"flush_rows=2048 fanout=4 pq_m=8 device={dev}")
    data = TracyData(dim)
    reset_counts()
    db, ingest_s = tracy_store(dev, data, rows, "IVF")
    table = db.table()
    ingest = counts()
    log(f"ingest: {ingest_s:.2f} s, segments "
        f"{[s.n_rows for s in table.store.segments]}, launches {ingest}")

    ex = table.executor
    tmpl = templates(data)
    xs = {dim: torch.from_numpy(data.cols["embedding"]).to(dev, torch.float64),
          2: torch.from_numpy(data.cols["coordinate"]).to(dev, torch.float64)}
    swaps_total = 0
    for name in ("t6", "t8", "t10", "t13", "t2", "t4"):
        before, probes = counts(), record.get("probes", 0)
        times, plan_desc, swaps, checked, power = [], "", 0, 0, []
        for b in range(BATCHES):
            made = [tmpl[name]() for _ in range(8)]
            built = [builder(table, m[0]) for m in made]
            if b == 0:
                log(f"EXPLAIN {name}:\n{built[0].explain()}")
            record["template"] = name
            t1 = time.perf_counter()
            out = db.execute_many(built)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t1) * 1e3)
            head = out[0][1].plan.splitlines()[0]     # the executed plan
            disp = head.split("dispatch=")[1].rstrip(")") \
                if "dispatch=" in head else (
                    "staged" if made[0][0].ranks else "-")
            plan_desc = f"plan={head.split('(')[0]} dispatch={disp}"
            for (qq, mask_fn, spec), (res, _) in zip(made, out):
                mask = mask_fn() if mask_fn is not None else None
                checked += 1
                if spec is None:            # filter query: exact pk set
                    want = set(np.nonzero(mask)[0].tolist())
                    got = {r.pk for r in res}
                    check(got == want, f"{name}: filter answer differs "
                          f"({len(got)} vs {len(want)} rows)")
                    continue
                sw, pw = brute_nn(dev, xs, mask, spec[1], qq.k, res)
                swaps += sw
                if pw is not None:
                    power.append(pw)
        after = counts()
        delta = {n: after[n] - before[n] for n in after}
        hold_pending(record)
        if name == "t2":
            check_list_launches("t2", delta,
                                record.get("probes", 0) - probes)
        swaps_total += swaps
        rest = np.asarray(times[1:])
        tol_note = (f", tol / k-th d2 median {np.median(power):.3g} max "
                    f"{max(power):.3g}" if power else "")
        log(f"query {name}: {plan_desc} first_batch_ms={times[0]:.3f} "
            f"p50_batch_ms={np.median(rest):.3f} (of the next {len(rest)} "
            f"batches of 8; min {rest.min():.3f} max {rest.max():.3f}) "
            f"launches {delta}; {checked} answers checked, tie swaps "
            f"{swaps}{tol_note}")
    total = counts()
    log(f"main path launches (ingest + queries): {total}")
    log(f"brute-force check: every answer agrees, tie swaps "
        f"{swaps_total}")
    return total, {"db": db, "ex": ex, "tmpl": tmpl, "xs": xs}


def quantized_templates(tmpl, recall_target: float = RECALL_TARGET):
    """TRACY's recall-targeted NN templates g6 (pure NN), g8 (NN + time
    range), g13 (disjunctive NN): t6, t8, t13 with a recall_target
    (``tracy.make_graph_templates``).  Each draw returns (targeted query,
    its exact twin of the same draw, brute-force mask function, rank
    spec)."""
    from repro_torch.core import query as q

    def make(tname):
        def g():
            exact, mask_fn, spec = tmpl[tname]()
            quant = q.HybridQuery(where=exact.where, ranks=exact.ranks,
                                  k=exact.k, recall_target=recall_target)
            return quant, exact, mask_fn, spec
        return g
    return {"g6": make("t6"), "g8": make("t8"), "g13": make("t13")}


def survivors(dev, rerank, qi: int, n: int):
    """The rows (as a pk-indexed bool mask over ``n`` pks on the card) the
    exact re-rank of query ``qi`` scanned: its bitmap in the recorded
    fused-scan inputs of the batch."""
    import torch
    _, _, mt, pkt, _, _ = rerank
    rows = torch.nonzero(mt[qi]).flatten()
    adm = torch.zeros(n, dtype=torch.bool, device=dev)
    adm[pkt[rows].long()] = True
    return adm


def quantized_path(dev, record, ctx) -> dict:
    """g6, g8, g13 at recall_target 0.9 on the main path's store, 21
    batches of 8 each as ``QueryBuilder``s through
    ``Database.execute_many`` (g6 at refine 12 through the table's
    ``Executor``, with its plans)."""
    import torch
    db, ex, xs = ctx["db"], ctx["ex"], ctx["xs"]
    table = db.table()
    n = len(xs[128])
    gt = quantized_templates(ctx["tmpl"])
    ctx["gt"] = gt
    total = dict.fromkeys(counts(), 0)

    def quantized_run(qs, plans=None):
        """One quantized ``execute_many``, its launches counted from 0 just
        before it to just after it; the exact dispatch's comparison runs
        stay outside these windows."""
        reset_counts()
        out = ex.execute_many(qs, plans=plans) if plans else \
            db.execute_many([builder(table, x) for x in qs])
        torch.cuda.synchronize()
        add_counts(total)
        return out

    for name in ("g6", "g8", "g13"):
        before = dict(total)
        times, swaps, power, recalls, plan_desc = [], 0, [], [], ""
        for _ in range(BATCHES):
            made = [gt[name]() for _ in range(8)]
            record["template"] = name
            t1 = time.perf_counter()
            out = quantized_run([m[0] for m in made])
            times.append((time.perf_counter() - t1) * 1e3)
            rerank = record["fused_last"]
            record["template"] = None
            head = out[0][1].plan.splitlines()[0]
            quantized = "dispatch=quantized" in head
            plan_desc = head
            if name != "g8":
                check(quantized, f"{name}: planned {head}, not the quantized "
                      f"dispatch")
            exact = ex.execute_many([m[1] for m in made])
            for qi, ((qq, _, mask_fn, spec), (res, st), (eres, _)) in \
                    enumerate(zip(made, out, exact)):
                keys = [(r.score, r.pk) for r in res]
                check(keys == sorted(keys), f"{name}: answer not in "
                      f"(score, pk) order")
                mask = mask_fn() if mask_fn is not None else None
                if quantized:
                    # (c) the answer is the exact top-k over the survivors
                    # the ADC kernel kept; (b) each score is its row's
                    # exact distance at the fp32 rounding bound
                    adm = survivors(dev, rerank, qi, n)
                    kept = int(adm.sum())
                    check(0 < kept <= qq.k * 16 and st.rerank_rows == kept,
                          f"{name}: {kept} survivors, rerank_rows "
                          f"{st.rerank_rows}")
                    if mask is not None:
                        check(bool(torch.from_numpy(mask).to(dev)[adm].all()),
                              f"{name}: a survivor fails the filter")
                else:
                    adm = mask
                sw, pw = brute_nn(dev, xs, adm, spec[1], qq.k, res)
                swaps += sw
                if pw is not None:
                    power.append(pw)
                want = {r.pk for r in eres}
                recalls.append(len({r.pk for r in res} & want)
                               / max(1, len(want)))
        delta = {k: v - before[k] for k, v in total.items()}
        rest = np.asarray(times[1:])
        log(f"query {name} (recall_target={RECALL_TARGET}): {plan_desc}; "
            f"first_batch_ms={times[0]:.3f} p50_batch_ms="
            f"{np.median(rest):.3f} (of the next {len(rest)} batches of 8; "
            f"min {rest.min():.3f} max {rest.max():.3f}) launches {delta}; "
            f"{len(recalls)} answers held against the float64 top-k over "
            f"their survivors, tie swaps {swaps}, tol / k-th d2 median "
            f"{np.median(power):.3g}; recall@10 against the exact dispatch "
            f"{np.mean(recalls):.4f}")
    same = 0
    for _ in range(3):
        made = [gt["g6"]() for _ in range(8)]
        plans = [ex.plan(m[0]) for m in made]
        for p in plans:
            p.refine = 12                       # k' = 120 <= KMAX
        quant = quantized_run([m[0] for m in made], plans)
        exact = ex.execute_many([m[1] for m in made])
        same += sum([(r.pk, r.score) for r in a] == [(r.pk, r.score)
                                                     for r in b]
                    for (a, _), (b, _) in zip(quant, exact))
    log(f"g6 at refine=12: {same} of 24 answers bitwise the exact "
        f"dispatch's")
    # each quantized dispatch re-ranks its survivors once: one fused launch
    # for each ADC launch, none of them the exact dispatch's
    check(total["fused_scan_topk"] == total["quantized_scan_topk"],
          f"quantized path: {total['fused_scan_topk']} re-rank launches for "
          f"{total['quantized_scan_topk']} ADC launches")
    return total


def pqivf_path(dev) -> dict:
    """The IVF-PQ probe: a TRACY store whose embedding column is
    ``IndexKind.PQIVF``, 20 t6- and 20 t8-shape queries through
    ``Executor.execute`` with a forced ``postfilter_nn`` plan."""
    import torch
    from repro_torch.core.optimizer.planner import Plan
    dim, rows = 128, PQIVF_ROWS
    log(f"IVF-PQ probe: TRACY tweet table with embedding PQIVF, {rows} rows "
        f"(paper: {PAPER_ROWS}; cut to keep the whole smoke inside the "
        f"run's time limit), dim={dim} flush_rows=2048 fanout=4 pq_m=8")
    data = TracyData(dim, seed=1)
    reset_counts()
    db, ingest_s = tracy_store(dev, data, rows, "PQIVF")
    table = db.table()
    log(f"IVF-PQ ingest: {ingest_s:.2f} s, segments "
        f"{[s.n_rows for s in table.store.segments]}, launches {counts()}")
    ex = table.executor
    tmpl = templates(data)
    x64 = torch.from_numpy(data.cols["embedding"]).to(dev, torch.float64)
    for name in ("t6", "t8"):
        times, recalls, worst = [], [], 0.0
        for _ in range(20):
            qq, mask_fn, spec = tmpl[name]()
            plan = Plan(kind="postfilter_nn",
                        residual=[qq.where] if qq.where is not None else [],
                        ranks=list(qq.ranks), k=qq.k)
            t1 = time.perf_counter()
            res, _ = ex.execute(qq, plan=plan)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t1) * 1e3)
            check(0 < len(res) <= qq.k, f"IVF-PQ {name}: {len(res)} rows")
            mask = mask_fn() if mask_fn is not None else None
            pks = np.asarray([r.pk for r in res], np.int64)
            if mask is not None:
                check(bool(mask[pks].all()), f"IVF-PQ {name}: an answer "
                      f"fails the filter")
            q64 = torch.from_numpy(spec[1].astype(np.float64)).to(dev)
            rt = torch.as_tensor(pks, device=dev)
            ex_d2 = ((x64[rt] - q64) ** 2).sum(dim=1).cpu().numpy()
            m = float((q64 ** 2).sum()) + float((x64[rt] ** 2).sum(1).max())
            tol = round_bound(dim, m, float(ex_d2.max()))
            f = np.asarray([r.score for r in res], np.float64) ** 2
            err = np.abs(f - ex_d2)
            check((err <= tol).all(), f"IVF-PQ {name}: a distance is "
                  f"{err.max():.3g} from float64 (tol {tol:.3g})")
            worst = max(worst, float((err / tol).max()))
            keys = [(r.score, r.pk) for r in res]
            check(keys == sorted(keys), f"IVF-PQ {name}: answer order")
            adm = torch.from_numpy(mask).to(dev) if mask is not None else None
            _, tp, _ = exact_topk(q64, x64, adm,
                                  torch.arange(len(x64), device=dev), qq.k)
            recalls.append(len(set(pks.tolist()) & set(tp.tolist()))
                           / max(1, len(tp)))
        t = np.asarray(times)
        log(f"IVF-PQ {name}: 20 queries, p50 {np.median(t):.3f} ms (min "
            f"{t.min():.3f} max {t.max():.3f}); every distance within "
            f"the fp32 bound of float64 (worst {worst:.3g} of it); "
            f"recall@10 against the float64 brute force "
            f"{np.mean(recalls):.4f}")
    return counts()


def sharded_path(dev, record):
    """The sharded store: ``Database(shards=4)``, a 4-shard
    ``ShardRouter`` of TRACY's shape filled with SHARDED_ROWS rows, then
    t6, t8, t10, t13, t2 and t4 as ``QueryBuilder``s through
    ``Database.execute_many`` (the table's ``ShardedExecutor``), 21
    batches of 8 each, every answer held against the float64 brute force
    (NN) or numpy (filters)."""
    import torch
    dim, rows = 128, SHARDED_ROWS
    log(f"sharded path: TRACY tweet table over {N_SHARDS} shards, {rows} "
        f"rows (paper: {PAPER_ROWS}; cut for the run's time), dim={dim} "
        f"flush_rows=2048 fanout=4 pq_m=8 per shard")
    data = TracyData(dim, seed=2)
    total = dict.fromkeys(counts(), 0)
    reset_counts()
    db, ingest_s = tracy_store(dev, data, rows, "IVF", shards=N_SHARDS)
    table = db.table()
    router = table.store
    ingest = add_counts(total)
    log(f"sharded ingest: {ingest_s:.2f} s, rows per shard "
        f"{router.shard_rows()}, segments per shard "
        f"{[[s.n_rows for s in sh.segments] for sh in router.shards]}, "
        f"launches {ingest}")
    ex = table.executor
    tmpl = templates(data)
    xs = {dim: torch.from_numpy(data.cols["embedding"]).to(dev, torch.float64),
          2: torch.from_numpy(data.cols["coordinate"]).to(dev, torch.float64)}
    nn_batches = 0
    for name in ("t6", "t8", "t10", "t13", "t2", "t4"):
        before, probes = dict(total), record.get("probes", 0)
        times, swaps, checked, head = [], 0, 0, ""
        for _ in range(BATCHES):
            made = [tmpl[name]() for _ in range(8)]
            built = [builder(table, m[0]) for m in made]
            record["template"] = f"sharded {name}"
            reset_counts()
            t1 = time.perf_counter()
            out = db.execute_many(built)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t1) * 1e3)
            c = add_counts(total)
            record["template"] = None
            head = out[0][1].plan.splitlines()[0]
            nn = made[0][2] is not None
            nn_batches += nn
            check(c["batched_topk_merge"] == int(nn),
                  f"sharded {name}: {c['batched_topk_merge']} merge "
                  f"launches in one batch")
            for (qq, mask_fn, spec), (res, st) in zip(made, out):
                check(st.shards == N_SHARDS, f"sharded {name}: shards "
                      f"{st.shards}")
                mask = mask_fn() if mask_fn is not None else None
                checked += 1
                if spec is None:
                    check(st.merge_rows == 0, "a filter query merged")
                    want = set(np.nonzero(mask)[0].tolist())
                    got = {r.pk for r in res}
                    check(got == want, f"sharded {name}: filter answer "
                          f"differs ({len(got)} vs {len(want)} rows)")
                    continue
                check(0 < st.merge_rows <= N_SHARDS * qq.k,
                      f"sharded {name}: merge_rows {st.merge_rows}")
                swaps += brute_nn(dev, xs, mask, spec[1], qq.k, res)[0]
        delta = {k: v - before[k] for k, v in total.items()}
        hold_pending(record)
        if name == "t2":
            check_list_launches("sharded t2", delta,
                                record.get("probes", 0) - probes)
        rest = np.asarray(times[1:])
        log(f"sharded query {name}: {head.split(' ')[0]} "
            f"first_batch_ms={times[0]:.3f} p50_batch_ms="
            f"{np.median(rest):.3f} (of the next {len(rest)} batches of 8; "
            f"min {rest.min():.3f} max {rest.max():.3f}) launches {delta}; "
            f"{checked} answers checked, tie swaps {swaps}")
    check(total["batched_topk_merge"] == nn_batches,
          f"sharded path: {total['batched_topk_merge']} merge launches for "
          f"{nn_batches} NN batches")
    log(f"sharded path: one batched_topk_merge launch per NN batch "
        f"({nn_batches}); every answer agrees")
    return total, {"ex": ex, "tmpl": tmpl}


def popcounts(vis) -> np.ndarray:
    """Rows set in each query's visited words."""
    v = np.ascontiguousarray(vis.cpu().numpy())
    return np.unpackbits(v.view(np.uint8), axis=1).sum(axis=1)


def graph_path(dev, record):
    """The graph dispatch: a GRAPH store of GRAPH_ROWS rows in 8 segments
    (the repo's graph study, ``benchmarks/hybrid_latency.py``), TRACY's
    recall-targeted templates at recall_target 0.95 through
    ``Executor.execute_many``, 21 batches of 8 each, planned by the
    planner alone.  Each answer is held against the float64 top-k over the
    survivors the beam search kept (the exact re-rank), ``rows_scanned``
    against the visited words' popcount; recall@10 against the exact
    dispatch and a widened beam (128, 12 hops) are printed."""
    import torch
    dim, rows = 128, GRAPH_ROWS
    log(f"graph path: TRACY tweet table with embedding GRAPH, {rows} rows "
        f"in {rows // GRAPH_FLUSH} segments (the size of the repo's graph "
        f"study, bounded by the host graph build), dim={dim} flush_rows="
        f"{GRAPH_FLUSH} fanout=32, no PQ tier")
    data = TracyData(dim, seed=3)
    total = dict.fromkeys(counts(), 0)
    reset_counts()
    db, ingest_s = tracy_store(dev, data, rows, "GRAPH",
                               flush_rows=GRAPH_FLUSH, fanout=32,
                               quantize=False)
    ingest = add_counts(total)
    log(f"graph ingest: {ingest_s:.2f} s, segments "
        f"{[s.n_rows for s in db.table().store.segments]}, launches "
        f"{ingest}")
    ex = db.table().executor
    gt = quantized_templates(templates(data), GRAPH_RECALL)
    xs = {dim: torch.from_numpy(data.cols["embedding"]).to(dev, torch.float64)}
    n = rows

    def graph_run(qs, plans=None):
        """One graph ``execute_many``, its launches counted from 0 just
        before it to just after it: one beam search and one re-rank."""
        reset_counts()
        out = ex.execute_many(qs, plans=plans)
        torch.cuda.synchronize()
        c = add_counts(total)
        check(c["graph_search_topk"] == 1 and c["fused_scan_topk"] == 1,
              f"graph batch launched {c['graph_search_topk']} beam searches "
              f"and {c['fused_scan_topk']} re-ranks")
        return out

    for name in ("g6", "g8", "g13"):
        times, swaps, recalls, gathered = [], 0, [], []
        heads = set()
        for _ in range(BATCHES):
            made = [gt[name]() for _ in range(8)]
            record["template"] = f"graph {name}"
            t1 = time.perf_counter()
            out = graph_run([m[0] for m in made])
            times.append((time.perf_counter() - t1) * 1e3)
            record["template"] = None
            rerank = record["fused_last"]
            pop = popcounts(record["graph"][-1][1][3])
            exact = ex.execute_many([m[1] for m in made])
            for qi, ((qq, _, mask_fn, spec), (res, st), (eres, _)) in \
                    enumerate(zip(made, out, exact)):
                head = st.plan.splitlines()[0]
                heads.add(head.split("(")[0] + " "
                          + head[head.index("dispatch="):].rstrip(")"))
                check("dispatch=graph" in head, f"{name}: planned {head}")
                filtered = mask_fn is not None
                # rows_scanned: the walk's gathered rows, plus the rows a
                # residual filter scanned (none on these plans)
                check(st.rows_scanned == int(pop[qi]),
                      f"{name}: rows_scanned {st.rows_scanned}, popcount "
                      f"{int(pop[qi])}")
                gathered.append(int(pop[qi]))
                keys = [(r.score, r.pk) for r in res]
                check(keys == sorted(keys), f"{name}: answer order")
                adm = survivors(dev, rerank, qi, n)
                check(st.rerank_rows == int(adm.sum()),
                      f"{name}: rerank_rows {st.rerank_rows}")
                if filtered:
                    check(bool(torch.from_numpy(mask_fn()).to(dev)[adm]
                               .all()), f"{name}: a survivor fails the "
                          f"filter")
                swaps += brute_nn(dev, xs, adm, spec[1], qq.k, res)[0]
                want = {r.pk for r in eres}
                recalls.append(len({r.pk for r in res} & want)
                               / max(1, len(want)))
        rest = np.asarray(times[1:])
        log(f"graph query {name} (recall_target={GRAPH_RECALL}): "
            f"plans {sorted(heads)}; first_batch_ms={times[0]:.3f} "
            f"p50_batch_ms={np.median(rest):.3f} (of the next {len(rest)} "
            f"batches of 8; min {rest.min():.3f} max {rest.max():.3f}); "
            f"{len(recalls)} answers held against the float64 top-k over "
            f"their survivors, tie swaps {swaps}; rows gathered per query "
            f"median {int(np.median(gathered))} of {n}; recall@10 against "
            f"the exact dispatch {np.mean(recalls):.4f}")
    same = 0
    for _ in range(3):
        made = [gt["g6"]() for _ in range(8)]
        plans = [ex.plan(m[0]) for m in made]
        for p in plans:
            p.graph_beam, p.graph_hops = 128, 12
        wide = graph_run([m[0] for m in made], plans)
        exact = ex.execute_many([m[1] for m in made])
        same += sum([(r.pk, r.score) for r in a] == [(r.pk, r.score)
                                                     for r in b]
                    for (a, _), (b, _) in zip(wide, exact))
    log(f"g6 at beam=128 hops=12: {same} of 24 answers bitwise the exact "
        f"dispatch's")
    check(total["graph_search_topk"] == total["fused_scan_topk"],
          f"graph path: {total['graph_search_topk']} beam searches, "
          f"{total['fused_scan_topk']} re-ranks")
    return total, {"ex": ex, "gt": gt}


# ---------------------------------------------------------------------------
# the continuous phase: subscriptions through the facade under writes
# ---------------------------------------------------------------------------

class LiveRows:
    """What a TRACY table holds under writes, pk-indexed (row i is pk i),
    with room for ``capacity`` pks: the current embedding, point and time
    of every pk written, which pks are live, and the embeddings and
    points on ``dev`` in float64 for the brute force (``xs``, keyed by
    width as ``brute_nn`` reads them)."""

    def __init__(self, dev, cols, capacity: int):
        import torch
        n, d = cols["embedding"].shape
        self.dev, self.n = dev, n
        self.live = np.zeros(capacity, bool)
        self.live[:n] = True
        self.pts = np.zeros((capacity, 2), np.float32)
        self.pts[:n] = cols["coordinate"]
        self.time = np.zeros(capacity)
        self.time[:n] = cols["time"]
        self.xs = {w: torch.zeros((capacity, w), dtype=torch.float64,
                                  device=dev) for w in (d, 2)}
        self.xs[d][:n] = torch.from_numpy(cols["embedding"]).to(
            dev, torch.float64)
        self.xs[2][:n] = torch.from_numpy(cols["coordinate"]).to(
            dev, torch.float64)

    def write(self, pks, batch) -> None:
        """A put of ``batch`` at ``pks`` (new rows or updates)."""
        import torch
        pks = np.asarray(pks, np.int64)
        self.pts[pks] = batch["coordinate"]
        self.time[pks] = batch["time"]
        self.live[pks] = True
        at = torch.from_numpy(pks).to(self.dev)
        for w, col in ((batch["embedding"].shape[1], "embedding"),
                       (2, "coordinate")):
            self.xs[w][at] = torch.from_numpy(
                np.asarray(batch[col], np.float32)).to(self.dev,
                                                       torch.float64)
        self.n = max(self.n, int(pks.max()) + 1)

    def delete(self, pks) -> None:
        self.live[np.asarray(pks, np.int64)] = False

    def mask(self, expr) -> np.ndarray:
        """Live rows passing ``expr`` (``And`` / ``Or`` of ``Range`` on
        time and ``GeoWithin``; None passes every row), evaluated as the
        executor does: time in float64, points against the rectangle in
        float32."""
        from repro_torch.core import query as q

        def ev(e):
            if e is None:
                return np.ones(len(self.live), bool)
            if isinstance(e, (q.And, q.Or)):
                parts = [ev(c) for c in e.children]
                return (np.logical_and if isinstance(e, q.And)
                        else np.logical_or).reduce(parts)
            if isinstance(e, q.Range) and e.col == "time":
                return (self.time >= e.lo) & (self.time <= e.hi)
            if isinstance(e, q.GeoWithin):
                r = np.asarray(e.rect, np.float32)
                p = self.pts
                return ((p[:, 0] >= r[0]) & (p[:, 0] <= r[2])
                        & (p[:, 1] >= r[1]) & (p[:, 1] <= r[3]))
            raise SmokeFailure(f"the smoke does not mirror {e!r}")
        return self.live & ev(expr)


def continuous_mix(data: TracyData):
    """The subscriptions of ``benchmarks/continuous_bench.py:20-31``: 12
    SYNC at interval 1.0, vector NN (k 10 on the embedding) and
    ``GeoWithin`` over ``rect(12)`` alternating; then two ASYNC: a t8-like
    NN with a time range and a t2-like time range with a ``GeoWithin``.
    Returns [(SYNC interval or None for ASYNC, query)]."""
    from repro_torch.core import query as q
    out = []
    for i in range(12):
        if i % 2 == 0:
            out.append((1.0, q.HybridQuery(ranks=[q.VectorRank(
                "embedding", data.query_vec(), 1.0)], k=10)))
        else:
            out.append((1.0, q.HybridQuery(
                where=q.GeoWithin("coordinate", data.rect(12)))))
    lo = float(data.rng.uniform(0, 800))
    out.append((None, q.HybridQuery(
        where=q.Range("time", lo, lo + 200),
        ranks=[q.VectorRank("embedding", data.query_vec(), 1.0)], k=10)))
    lo = float(data.rng.uniform(0, 900))
    out.append((None, q.HybridQuery(where=q.And(
        q.Range("time", lo, lo + 50),
        q.GeoWithin("coordinate", data.rect(15))))))
    return out


def check_schedule(interval, ran: bool, wrote: bool) -> None:
    """A SYNC subscription at interval 1.0 is due at every tick (the
    ticks are 1.0 apart); an ASYNC one runs exactly when a write came
    since its last run (``wrote``; true at the first tick, when it is
    dirty from its registration)."""
    if interval is not None:
        check(ran, "a SYNC subscription due at this tick did not run")
    else:
        check(ran == wrote, f"an ASYNC subscription {'did not run' if wrote
              else 'ran'} with{'' if wrote else 'out'} a write before")


def check_cache_hits(mode: str, hits: int, n_sync: int, wrote: bool) -> None:
    """The full-result cache's hits at one tick: in ``fcache`` mode a
    tick with no write before it serves every SYNC subscription from the
    cache (each ran at the tick before, and nothing invalidated it), and
    a tick after a delete serves none (a delete empties the cache); the
    other modes keep no cache."""
    want = n_sync if mode == "fcache" and not wrote else 0
    check(hits == want, f"{mode}: {hits} cache hits at a tick "
          f"{'after a write' if wrote else 'with no write before it'}, "
          f"{want} expected")


def hold_subscription(dev, rows: LiveRows, query, res, fresh, rewrite=None):
    """Hold one subscription's answer ``res`` at a tick against ``fresh``,
    an ``execute`` of the same query on the same table at that tick, both
    against the table's current rows: an NN answer tie-aware at the fp32
    bound (``brute_nn``), a filter answer as an exact pk set.

    ``rewrite`` is the view rewrite that answered (views mode, when a view
    served the query), else None.  A view answers by the reference's own
    rule (``core/views/rewrite.py``), held here exactly:

    - a vector view: the exact top-k of the live rows passing the filter
      among the view's 4 k candidates nearest the query by the vectors it
      holds (``VectorNNView.topk_for``);
    - a spatial view: the live rows passing the residual filter among the
      view's pks whose held point lies in the rectangle
      (``SpatialRangeView.pks_in``).  It may differ from the fresh answer
      only in pks whose held point is not their current one (a row
      updated out of the view's rectangle stays in it with its old point;
      ROADMAP.md §3) or lies on the rectangle's edge (``pks_in`` compares
      in float64, the executor in float32).

    Returns (tie swaps, whether the answer's pks are the fresh answer's,
    pks in one of the two and not the other)."""
    from repro_torch.core import query as q
    mask = rows.mask(query.where)
    got, fresh_pks = [r.pk for r in res], [r.pk for r in fresh]
    off = len(set(got) ^ set(fresh_pks))
    if query.ranks:
        qv = np.asarray(query.ranks[0].q, np.float32)
        swaps = brute_nn(dev, rows.xs, mask, qv, query.k, fresh)[0]
        adm = mask
        if rewrite is not None:
            cand = [pk for _, pk in rewrite.vector_view.topk_for(
                qv, max(query.k * 4, query.k))]
            adm = np.zeros_like(mask)
            adm[np.asarray(cand, np.int64)] = True
            adm &= mask
            check(int(adm.sum()) >= query.k, f"a vector view answered "
                  f"from {int(adm.sum())} live candidates, under k")
        return (swaps + brute_nn(dev, rows.xs, adm, qv, query.k, res)[0],
                got == fresh_pks, off)
    want = set(np.nonzero(mask)[0].tolist())
    check(set(fresh_pks) == want, f"a fresh execute differs from numpy "
          f"({len(fresh_pks)} vs {len(want)} rows)")
    if rewrite is None:
        check(set(got) == want, f"a subscription's filter answer differs "
              f"({len(got)} vs {len(want)} rows)")
        return 0, True, 0
    view, pred = rewrite.spatial_view, rewrite.spatial_pred
    residual = [p for p in query.filters if p is not pred]
    keep = rows.mask(q.And(residual) if residual else None)
    expect = {pk for pk in view.pks_in(pred.rect) if keep[pk]}
    check(set(got) == expect, f"a spatial view answered {len(got)} rows, "
          f"its points name {len(expect)}")
    r64, r32 = pred.rect, np.asarray(pred.rect, np.float32)
    for pk in set(got) ^ want:
        held = view.rows.get(pk)
        x, y = (float(v) for v in rows.pts[pk])
        edge = ((r64[0] <= x <= r64[2] and r64[1] <= y <= r64[3])
                != bool(r32[0] <= x <= r32[2] and r32[1] <= y <= r32[3]))
        check(held is not None and (held != (x, y) or edge),
              f"pk {pk} is off the fresh answer with its current point "
              f"{(x, y)} in the view")
    return 0, set(got) == want, off


def write_round(table, rows: LiveRows, data: TracyData, rng) -> None:
    """The writes before a tick: CONT_PUT new rows, updates of
    CONT_UPDATE live pks and deletes of CONT_DELETE, each through the
    facade and into ``rows``."""
    new = np.arange(rows.n, rows.n + CONT_PUT)
    batch = data.draw(CONT_PUT)[0]
    table.put(new, batch)
    rows.write(new, batch)
    upd = rng.choice(np.nonzero(rows.live)[0], CONT_UPDATE, replace=False)
    batch = data.draw(CONT_UPDATE)[0]
    table.put(upd, batch)
    rows.write(upd, batch)
    gone = rng.choice(np.nonzero(rows.live)[0], CONT_DELETE, replace=False)
    table.delete(gone)
    rows.delete(gone)


def run_subscriptions(dev, record, db, table, rows, data, mix, ticks,
                      what):
    """Subscribe ``mix`` on ``table`` through the facade, then ``ticks``
    ticks of ``db.advance`` 1.0 apart: writes before every tick but the
    first and the last, so the last tick has no write before it.  At
    every tick every answer is held (``hold_subscription``; an ASYNC
    subscription that did not run by its last answer) and the schedule
    (``check_schedule``) and the full-result cache's hits
    (``check_cache_hits``) are checked.  The launch counts of the
    registrations, the writes and the advances are added up from 0, the
    checks' launches left out (and out of the recorder's counts).
    Returns (launches, advance ms per tick, a tally of the answers: held,
    tie swaps, pks off the fresh answers, and by query kind those a view
    served and how many of them had the fresh answer's pks)."""
    import torch
    rng = np.random.default_rng(len(what))
    total = dict.fromkeys(counts(), 0)
    reset_counts()
    t0 = time.perf_counter()
    subs = [(interval, builder(table, qq).subscribe(interval_s=interval)
             if interval is not None else
             builder(table, qq).subscribe(on_change=True))
            for interval, qq in mix]
    torch.cuda.synchronize()
    add_counts(total)
    log(f"{what}: {len(subs)} subscriptions registered in "
        f"{(time.perf_counter() - t0) * 1e3:.3f} ms")
    engine = table.engine
    n_sync = sum(interval is not None for interval, _ in mix)
    by_view = {}        # rid -> the rewrite that served its last answer
    adv = []
    tally = dict.fromkeys(("held", "swaps", "off", "nn by view",
                           "nn by view as fresh", "geo by view",
                           "geo by view as fresh"), 0)
    for tick in range(ticks):
        wrote = tick < ticks - 1
        if 0 < tick < ticks - 1:
            reset_counts()
            write_round(table, rows, data, rng)
            torch.cuda.synchronize()
            add_counts(total)
        hits = {s.rid: engine.registered[s.rid].view_hits for _, s in subs}
        cached = engine.metrics.get("cache_hits", 0)
        reset_counts()
        t1 = time.perf_counter()
        out = db.advance(float(tick))[table.name]
        torch.cuda.synchronize()
        adv.append((time.perf_counter() - t1) * 1e3)
        add_counts(total)
        record["checking"] = True
        check_cache_hits(engine.mode,
                         engine.metrics.get("cache_hits", 0) - cached,
                         n_sync, wrote)
        for interval, sub in subs:
            # a write (or, at the first tick, the registration) came
            # before every tick but the last
            ran = sub.rid in out
            check_schedule(interval, ran, wrote)
            reg = engine.registered[sub.rid]
            if ran:
                by_view[sub.rid] = reg.rewrite \
                    if reg.view_hits > hits[sub.rid] else None
            fresh, _ = table.execute(sub.decl.query)
            sw, same, off = hold_subscription(
                dev, rows, sub.decl.query,
                out[sub.rid] if ran else reg.last_result, fresh,
                by_view[sub.rid])
            tally["held"] += 1
            tally["swaps"] += sw
            tally["off"] += off
            if ran and by_view[sub.rid] is not None:
                kind = "nn" if sub.decl.query.ranks else "geo"
                tally[f"{kind} by view"] += 1
                tally[f"{kind} by view as fresh"] += same
        record["checking"] = False
    for _, sub in subs:
        sub.cancel()
    return total, adv, tally


def continuous_path(dev, record):
    """Continuous queries through the facade: a TRACY table of CONT_ROWS
    rows at the main store's widths and config (its own: the phase
    writes), the subscriptions of ``continuous_mix`` for CONT_TICKS ticks
    in each of the modes none, fcache and views, each mode a
    ``Database(continuous_mode=...)`` that adopts the table; then
    ``ShardedContinuousEngine`` on a 4-shard table of CONT_ROWS rows of
    its own (so the sharded path's table keeps the rows its batches and
    the busy share read) for SHARDED_CONT_TICKS ticks with the same
    writes."""
    from repro_torch.core.api import Database
    dim, t0 = 128, time.perf_counter()
    log(f"continuous path: TRACY tweet table, {CONT_ROWS} rows, dim={dim} "
        f"flush_rows=2048 fanout=4 pq_m=8, view budget {VIEW_BUDGET} bytes; "
        f"{CONT_TICKS} ticks a mode, before every tick but the first and "
        f"the last a put of {CONT_PUT} new rows, updates of {CONT_UPDATE} "
        f"pks and deletes of {CONT_DELETE}")
    data = TracyData(dim, seed=4)
    total = dict.fromkeys(counts(), 0)
    reset_counts()
    base, ingest_s = tracy_store(dev, data, CONT_ROWS, "IVF")
    table = base.table()
    add_counts(total)
    log(f"continuous ingest: {ingest_s:.2f} s, segments "
        f"{[s.n_rows for s in table.store.segments]}")
    rows = LiveRows(dev, data.cols, CONT_ROWS + len(CONT_MODES)
                    * (CONT_TICKS - 2) * CONT_PUT)
    record["template"] = None
    for mode in CONT_MODES:
        t1 = time.perf_counter()
        db = Database(continuous_mode=mode, view_budget_bytes=VIEW_BUDGET,
                      device=dev)
        t = db.adopt_store("tweets", table.store)
        c, adv, tally = run_subscriptions(
            dev, record, db, t, rows, data, continuous_mix(data),
            CONT_TICKS, f"continuous {mode}")
        for k, v in c.items():
            total[k] += v
        m = t.engine.metrics
        log(f"continuous {mode}: first advance {adv[0]:.3f} ms, p50 "
            f"advance after writes {np.median(adv[1:-1]):.3f} ms (ticks "
            f"2-{CONT_TICKS - 1}), advance with no write before it "
            f"{adv[-1]:.3f} ms; executions {m['executions']}, view_hits "
            f"{m['view_hits']}, cache_hits {m['cache_hits']}; launches {c}; "
            f"answers held against a fresh execute and the float64 brute "
            f"force: {tally}; {time.perf_counter() - t1:.1f} s in all")
    t1 = time.perf_counter()
    sdata = TracyData(dim, seed=5)
    sharded_total = dict.fromkeys(counts(), 0)
    reset_counts()
    sdb, ingest_s = tracy_store(dev, sdata, CONT_ROWS, "IVF",
                                shards=N_SHARDS)
    add_counts(sharded_total)
    srows = LiveRows(dev, sdata.cols, CONT_ROWS
                     + (SHARDED_CONT_TICKS - 2) * CONT_PUT)
    st = sdb.table()
    c, adv, tally = run_subscriptions(
        dev, record, sdb, st, srows, sdata, continuous_mix(sdata),
        SHARDED_CONT_TICKS, "sharded continuous")
    for k, v in c.items():
        sharded_total[k] += v
    m = st.engine.metrics
    log(f"sharded continuous ({type(st.engine).__name__}, {st.n_shards} "
        f"shards, {st.n_rows} rows; ingest {ingest_s:.2f} s): first advance "
        f"{adv[0]:.3f} ms, p50 advance after writes "
        f"{np.median(adv[1:-1]):.3f} ms, advance with no write before it "
        f"{adv[-1]:.3f} ms; executions {m['executions']}, delta batches "
        f"{m['delta_batches']}; launches {c}; answers held: {tally}; "
        f"{time.perf_counter() - t1:.1f} s in all")
    log(f"continuous path: {time.perf_counter() - t0:.1f} s in all")
    return total, sharded_total


# ---------------------------------------------------------------------------
# phase 3: kernels on the main path's inputs
# ---------------------------------------------------------------------------

def install_recorder(record):
    """Keep the inputs the paths hand each kernel wrapper (one set per
    template for the two scans and bitmap_filter's list entry point, the
    last fused call apart, one per shape for ivf_scan, bitmap_filter's
    per-block entry point and pq_adc up to the 64 or 80 that are timed,
    every call of the merge and the beam search, the beam search's
    outputs too).  The first call of each shape of ivf_scan, pq_adc and
    bitmap_filter's per-block entry point is held against the plain
    version on its own inputs as it runs (``hold_plain``); that of each
    shape of the list entry point, whose shapes differ from call to call,
    is kept with its output and held by ``hold_pending`` after the timed
    batches (``hold_list``).  A ``template`` of None records no scan
    inputs; calls made while ``checking`` is set (the continuous phase's
    fresh executes) are held but not counted."""
    from repro_torch.kernels import (bitmap_filter, fused_scan, graph_search,
                                     ivf_scan, pq_adc, quantized_scan,
                                     topk_merge)
    orig = {"fused": fused_scan.fused_scan_topk, "ivf": ivf_scan.ivf_scan,
            "bitmap": bitmap_filter.bitmap_filter,
            "blocks": bitmap_filter.bitmap_filter_blocks,
            "quantized": quantized_scan.quantized_scan_topk,
            "pq": pq_adc.pq_adc, "merge": topk_merge.batched_topk_merge,
            "graph": graph_search.graph_search_topk,
            "topk": topk_merge.topk_merge}
    record.update(fused={}, quantized={}, ivf={}, bitmap={}, pq={},
                  blocks={}, merge=[], graph=[])

    def per_template(kind):
        def rec(*a):
            if kind == "fused":
                record["fused_last"] = a
            if record.get("template") is not None:
                record[kind][record["template"]] = a
            return orig[kind](*a)
        return rec

    def per_shape(kind):
        counts = record[kind + "_calls"] = {}
        errs = record[kind + "_err"] = {}

        def rec(x, y):
            key = tuple(x.shape) + tuple(y.shape)
            counts[key] = counts.get(key, 0) + (not record.get("checking"))
            # inputs to time: of the first 64 shapes, and of 16 more
            # single-query ivf_scan shapes (the probes' launches come late)
            held = len(record[kind])
            if key not in record[kind] and (held < 64 or (
                    kind == "ivf" and x.shape[0] <= 8 and held < 80)):
                record[kind][key] = (x.clone(), y.clone())
            out = orig[kind](x, y)
            if key not in errs:       # every shape, at its first call
                errs[key] = hold_plain(kind, key, x, y, out)
            return out
        return rec

    list_calls = record["blocks_calls"] = {}
    record["blocks_err"] = {}
    pending = record["blocks_pending"] = {}

    def blocks(cols, rows, blk, bounds, n_out, block_rows):
        # every shape (points, columns, listed blocks, mask rows) kept with
        # its output at its first call, to hold later; each template's last
        # call kept for timing (the points and row ids are the index's own
        # device copies, which no call writes)
        key = (cols.shape[0], cols.shape[1], blk.numel(), n_out)
        list_calls[key] = list_calls.get(key, 0) + 1
        a = (cols, rows, blk.clone(), bounds.clone(), n_out, block_rows)
        if record.get("template") is not None:
            record["blocks"][record["template"]] = a
        out = orig["blocks"](cols, rows, blk, bounds, n_out, block_rows)
        if key not in record["blocks_err"] and key not in pending:
            pending[key] = (a, out.clone())
        return out

    def merge(d, i, k):
        record["merge"].append((d.clone(), i.clone(), k))
        return orig["merge"](d, i, k)

    def graph(*a):
        out = orig["graph"](*a)
        record["graph"].append((a, out))
        return out

    topk_merge.batched_topk_merge = merge
    graph_search.graph_search_topk = graph
    fused_scan.fused_scan_topk = per_template("fused")
    quantized_scan.quantized_scan_topk = per_template("quantized")
    ivf_scan.ivf_scan = per_shape("ivf")
    bitmap_filter.bitmap_filter = per_shape("bitmap")
    bitmap_filter.bitmap_filter_blocks = blocks
    pq_adc.pq_adc = per_shape("pq")
    return orig


def hold_pending(record) -> None:
    """Hold the list calls the recorder kept (the first of each shape)
    against the plain version, outside the timed batches."""
    pending = record.get("blocks_pending", {})
    for key, (a, out) in pending.items():
        record["blocks_err"][key] = hold_list(key, a, out)
    pending.clear()


def install_probe_counter(record):
    """Count in ``record["probes"]`` the ``ZOrderIndex.bitmap`` calls
    that list a block, and fail on a call that does not make exactly one
    launch of bitmap_filter's list entry point (none if it lists no
    block) or that makes a per-block launch."""
    from repro_torch.core.index import spatial
    orig = spatial.ZOrderIndex.bitmap
    record["probes"] = 0

    def bitmap(self, segment, predicate):
        before = counts()
        out = orig(self, segment, predicate)
        d = {k: v - before[k] for k, v in counts().items()}
        listed = self.last_blocks_read > 0
        record["probes"] += listed
        check(d[ENTRY] == int(listed) and d["bitmap_filter"] == d[ENTRY],
              f"a ZOrderIndex.bitmap call listing {self.last_blocks_read} "
              f"blocks made launches {bitmap_entries(d)}")
        return out
    spatial.ZOrderIndex.bitmap = bitmap


def measure(record, orig, launches, errs, dev):
    import torch
    from repro_torch.kernels import ivf_scan, ref
    out = []
    # fused scan: every template's call on the paths, each timed
    fs_rows = {}
    for tname, a in record["fused"].items():
        kout = orig["fused"](*a)
        torch.cuda.synchronize()
        plain, (xk, mk) = fused_plain(a)
        err, swaps, power = fused_compare(a, kout, plain)
        errs["fused_scan_topk"] = max(errs["fused_scan_topk"], err)
        nq, d = a[0].shape
        adm = mk[:, :].bool()
        pairs = int(adm.sum())
        rows_any = int(adm.any(dim=0).sum())
        nbytes = (rows_any * (4 * d + 4) + a[2].numel() + a[0].numel() * 4
                  + nq * 128 * 12)
        flops = 2 * d * pairs
        k_ms = cuda_ms(lambda: orig["fused"](*a))
        p_ms = cuda_ms(lambda: fused_plain(a), reps=5, warm=1)

        def library():
            dd = torch.cdist(a[0], xk).square()
            dd = torch.where(mk.bool(), dd, torch.full_like(dd, float("inf")))
            return torch.topk(dd, 128, dim=1, largest=False)
        l_ms = cuda_ms(library, reps=5, warm=1)
        bound, by = row_bound(nbytes, flops)
        fs_rows[tname] = (k_ms, p_ms, bound, by, l_ms)
        log(f"fused_scan path shape ({nq}, {a[2].shape[1]}, {d}, "
            f"{a[4].shape[0]}, {pairs}): {tname}")
        log(f"kernel fused_scan_topk {tname} nq={nq} kept rows="
            f"{xk.shape[0]} d={d}: max|dd2|={err:.3g} tie swaps={swaps} "
            f"median tol/kth d2={power:.3g}; "
            f"{pairs} admitted (query, row) pairs; kernel {k_ms:.4f} ms, "
            f"plain {p_ms:.4f} ms, cdist+where+topk {l_ms:.4f} ms, bound "
            f"{bound:.4f} ms ({by})")
    if fs_rows:
        main = "t6" if "t6" in fs_rows else next(iter(fs_rows))
        e_ms, p_ms, bound, by, l_ms = fs_rows[main]
        a = record["fused"][main]
        parts = kernel_parts(lambda: orig["fused"](*a))
        k_ms = sum(parts.values())
        wit = witness_bytes(a)
        log(f"kernel fused_scan_topk {main}: {k_ms:.4f} ms device time, "
            f"every launch of a call (" + ", ".join(
                f"{k} {v:.4f}" for k, v in parts.items()) + f" ms), "
            f"{e_ms:.4f} ms a call by CUDA events; the witnesses re-read at "
            f"most {wit} bytes of x beside the bound's "
            f"({wit / HBM_BYTES_PER_S * 1e3:.4f} ms)")
        out.append(("fused_scan_topk", k_ms, p_ms, bound, by, l_ms,
                    {"events_ms": e_ms, "launch_ms": parts,
                     "witness_bytes": wit}))
    if record["quantized"]:
        out.append(measure_quantized(record, orig))
    if record["blocks"]:
        out.append(measure_bitmap(record, orig, launches, errs))

    for kind, name in (("ivf", "ivf_scan"), ("pq", "pq_adc")):
        if not record[kind]:
            continue
        best = None
        # the paths' most frequent shapes, timed: ivf_scan's three and its
        # two most frequent single-query ones, by device time and CUDA
        # events; pq_adc's one by device time (and its library call too)
        calls_of = record[kind + "_calls"]
        ranked = sorted(record[kind].items(), key=lambda kv: -calls_of[kv[0]])
        timed = {k for k, _ in ranked[:3 if kind == "ivf" else 1]}
        errs_of = record[kind + "_err"]
        check(set(errs_of) == set(calls_of), f"{name}: a path shape was "
              f"not held against the plain version")
        errs[name] = max(errs[name], max(errs_of.values()))
        if kind == "ivf":
            timed |= {k for k, _ in [kv for kv in ranked
                                     if kv[0][0] <= 8][:2]}
            log(f"ivf_scan: {len(calls_of)} path shapes, "
                f"{sum(calls_of.values())} launches; inputs held for "
                f"timing for {len(record['ivf'])}")
            for key, n in sorted(calls_of.items(), key=lambda kv: -kv[1]):
                log(f"ivf_scan path shape {key}: {n} launches, "
                    f"{ivf_scan.launch_path(key[0], key[2], key[1])} path, "
                    f"max|dd2| {errs_of[key]:.3g}")
        for key, (x, y) in ranked:
            if key not in timed:
                continue
            calls = calls_of[key]
            if kind == "ivf":
                nq, d = x.shape
                n = y.shape[0]
                nbytes = 4 * (nq * d + n * d + nq * n)
                flops = 2 * nq * n * d
                lib = (lambda x=x, y=y: torch.cdist(x, y).square())
                plain = (lambda x=x, y=y: ref.ivf_scan_ref(x, y))
                path = ivf_scan.launch_path(nq, n, d)
            else:
                n, m = x.shape
                nbytes, flops = n * m + 4 * y.numel() + 4 * n, n * m
                # the library yardstick: one gather of the LUT, summed
                lib = (lambda x=x, y=y:
                       torch.gather(y, 1, x.T.long()).sum(dim=0))
                plain = (lambda x=x, y=y: ref.pq_adc_ref(x, y))
                path = None
            e_ms = cuda_ms(lambda x=x, y=y: orig[kind](x, y))
            k_ms = kernel_ms(lambda x=x, y=y: orig[kind](x, y), name)
            bound, by = row_bound(nbytes, flops)
            log(f"kernel {name} {key} ({calls} path launches at this shape"
                f"{', ' + path + ' path' if path else ''}): kernel "
                f"{k_ms:.4f} ms device time ({e_ms:.4f} ms a call by CUDA "
                f"events), bound {bound:.5f} ms ({by})")
            if best is None:          # the main path's most frequent shape
                p_ms = cuda_ms(plain)
                if lib is None:
                    l_ms = None
                elif kind == "pq":
                    l_ms = kernel_ms(lib, None)
                    log(f"kernel pq_adc library (gather-sum) {key}: "
                        f"{l_ms:.4f} ms device time ({cuda_ms(lib):.4f} ms "
                        f"a call by CUDA events)")
                else:
                    l_ms = cuda_ms(lib)
                best = (name, k_ms, p_ms, bound, by, l_ms)
                log(f"kernel {name} {key}: plain {p_ms:.4f} ms, library "
                    f"{l_ms if l_ms is None else round(l_ms, 4)} ms")
        log(f"kernel {name}: all {len(errs_of)} path shapes held against "
            f"the plain version, max abs err {errs[name]:.3g}")
        out.append(best)
    if record["merge"]:
        out.append(measure_merge(record, orig))
    if record["graph"]:
        out.append(measure_graph(record, orig))
    out.append(measure_topk(orig, dev))
    line = []
    for name, k_ms, p_ms, bound, by, l_ms, *extra in out:
        src, rep = SOURCES[name]
        line.append({"name": name, "route": "cuda", "source": src,
                     "replaces": rep, "launches": launches[name],
                     "max_abs_err": errs[name], "ms": k_ms,
                     "plain_ms": p_ms, "bound_ms": bound, "bound_by": by,
                     "library_ms": l_ms, **(extra[0] if extra else {})})
    return line


def witness_bytes(args) -> int:
    """The most bytes of x the fused scan's witnesses read on ``args``
    (the wrapper's inputs) beside the scan's own read: their sampled rows
    (``fused_scan.witness_rows``) of every query tile, 4 d bytes each (the
    kernel reads only those some query of the tile admits)."""
    from repro_torch.kernels import build
    from repro_torch.kernels import fused_scan as fs
    nq, d = args[0].shape
    nkeep = args[4].shape[0]
    chunks = fs.chunking(nq // fs.BLOCK_Q, nkeep,
                         build.sm_count(args[0].device))
    return fs.witness_rows(nkeep, chunks) * 4 * d * (nq // fs.BLOCK_Q)


def zero_kernel(fn, kernel: str) -> str:
    """The name of the one device kernel besides ``kernel`` (and copies)
    that a call of ``fn`` runs: the fill that zeroes the wrapper's output
    before the launch.  Fails unless a trace of three shows one such
    name."""
    for _ in range(3):
        names = {n for n, _ in trace_spans(fn, 5)
                 if kernel not in n and not n.startswith("Memcpy")}
        if len(names) == 1:
            break
    name = next(iter(names), "")
    check(len(names) == 1 and ("Fill" in name or "Memset" in name),
          f"a call runs {sorted(names)} beside {kernel}, not one fill")
    return name


def measure_bitmap(record, orig, launches, errs):
    """bitmap_filter's row.  Its list entry point at the main path's t2
    input (the last t2 query's block list on the 2,097,152-row segment):
    device time of the mask's zeroing and the kernel, the two launches a
    call makes, in a profiler trace, and of the call by CUDA events; its
    plain version; its bound (the listed points' values and row ids, the
    list and the bounds read once, the n_out-byte mask written once).
    Beside it the kernel alone, against its own bound (what it reads, and
    one byte for each row it sets).  Then what one ``ops.rect_filter_blocks``
    call at that input spends (host clock, and the trace's memset, kernel
    and copies).  The per-block entry point at (1024 x 2), on the first
    1,024 of the same points, by device time.  Every path call of either
    entry point was held by the recorder (the list calls here, by
    ``hold_pending``)."""
    import torch
    from repro_torch.kernels import ops, ref
    hold_pending(record)
    for kind, name in (("blocks", "list"), ("bitmap", "per-block")):
        check(set(record[kind + "_err"]) == set(record[kind + "_calls"]),
              f"bitmap_filter {name}: a path shape was not held against "
              f"the plain version")
    tname = "t2" if "t2" in record["blocks"] else next(iter(record["blocks"]))
    a = record["blocks"][tname]
    cols, rows, blocks, bounds, n_out, br = a
    n, c = cols.shape
    b = blocks.long()
    b = b[(b >= 0) & (b * br < n)]
    listed = int(torch.clamp(n - b * br, max=br).sum())
    kname = "bitmap_filter_blocks_kernel"

    def call():
        return orig["blocks"](*a)
    hits = int(call().sum())
    fill = zero_kernel(call, kname)
    e_ms = cuda_ms(call)
    k_ms = kernel_ms(call, (fill, kname))
    ko_ms = kernel_ms(call, kname)
    x, y = cols[:1024].contiguous(), bounds
    pb_e = cuda_ms(lambda: orig["bitmap"](x, y))
    pb_ms = kernel_ms(lambda: orig["bitmap"](x, y), "bitmap_filter_kernel")
    check(bool((orig["bitmap"](x, y).bool()
                == ref.bitmap_filter_ref(x, y)).all()),
          "bitmap_filter (1024 x 2) differs from the plain version")
    pb_bound, _ = row_bound(4 * 1024 * c + 1024 + 8 * c, 2 * 1024 * c)
    p_ms = cuda_ms(lambda: ref.bitmap_filter_blocks_ref(*a))
    read = listed * (4 * c + 4) + 4 * blocks.numel() + 8 * c
    bound, by = row_bound(read + n_out, 2 * c * listed)
    ko_bound, _ = row_bound(read + hits, 2 * c * listed)
    log(f"kernel bitmap_filter_blocks {tname} ({n} points, {blocks.numel()} "
        f"listed blocks, {listed} listed points, {n_out}-row mask, {hits} "
        f"rows set): zeroing + kernel {k_ms:.4f} ms device time ({e_ms:.4f} "
        f"ms a call by CUDA events), plain {p_ms:.4f} ms, library none (no "
        f"one PyTorch call gathers, filters and scatters), bound "
        f"{bound:.6f} ms ({by}, {read + n_out} bytes); the kernel alone "
        f"{ko_ms:.4f} ms, bound {ko_bound:.6f} ms ({read + hits} bytes); "
        f"zeroing kernel {fill}")
    # one op call at t2's input: host clock, and its device parts
    hb = bounds.cpu().numpy()
    rect = (hb[0, 0], hb[1, 0], hb[0, 1], hb[1, 1])
    bnp = blocks.cpu().numpy()

    def op():
        return ops.rect_filter_blocks(cols, rows, bnp, rect, n_out, br,
                                      device=cols.device)
    op()
    reps = 20
    t0 = time.perf_counter()
    for _ in range(reps):
        op()
    op_ms = (time.perf_counter() - t0) * 1e3 / reps
    spans = trace_spans(op, reps)

    def part(*keys):
        return sum(t for nm, t in spans if any(k in nm for k in keys)) \
            / reps / 1e3
    parts = {"memset": part(fill),
             "kernel": part("bitmap_filter_blocks_kernel"),
             "copy_in": part("HtoD"), "copy_out": part("DtoH")}
    log(f"op rect_filter_blocks {tname}: {op_ms:.4f} ms a call by the host "
        f"clock; device " + ", ".join(f"{k} {v:.4f}" for k, v in
                                      parts.items()) + " ms a call")
    per_block = launches["bitmap_filter"] - launches[ENTRY]
    log(f"kernel bitmap_filter per block (1024 x {c}): {pb_ms:.4f} ms "
        f"device time ({pb_e:.4f} ms a call by CUDA events), bound "
        f"{pb_bound:.7f} ms; launches on the paths: per block {per_block}, "
        f"list {launches[ENTRY]}")
    return ("bitmap_filter", k_ms, p_ms, bound, by, None, {
        "events_ms": e_ms, "kernel_only_ms": ko_ms,
        "kernel_only_bound_ms": ko_bound,
        "entry_launches": {"bitmap_filter": per_block,
                           ENTRY: launches[ENTRY]},
        "op_ms": op_ms, "op_device_ms": parts,
        "per_block_ms": pb_ms, "per_block_events_ms": pb_e,
        "per_block_bound_ms": pb_bound})


def measure_merge(record, orig):
    """The cross-shard merge on every input the sharded path gave it,
    bitwise against its plain version; the first (a t6 batch) timed, the
    kernel by its device time in a profiler trace.  No
    single PyTorch call computes it: ``torch.topk`` does not break ties by
    id."""
    import torch
    from repro_torch.kernels import ref
    for d, i, k in record["merge"]:
        o = orig["merge"](d, i, k)
        torch.cuda.synchronize()
        w = ref.batched_topk_merge_ref(d, i, k)
        check(same_bits(o[0], w[0]) and same_bits(o[1], w[1]),
              f"batched_topk_merge differs from the plain version on a "
              f"sharded-path input {tuple(d.shape)} k={k}")
    d, i, k = record["merge"][0]
    nq, s, kk = d.shape
    e_ms = cuda_ms(lambda: orig["merge"](d, i, k))
    k_ms = kernel_ms(lambda: orig["merge"](d, i, k),
                     "batched_topk_merge_kernel")
    p_ms = cuda_ms(lambda: ref.batched_topk_merge_ref(d, i, k))
    # each candidate read once (score + id), each winner written once; one
    # comparison per candidate is the least a selection does
    bound, by = row_bound(nq * s * kk * 8 + nq * k * 8, nq * s * kk)
    log(f"kernel batched_topk_merge: {len(record['merge'])} sharded-path "
        f"inputs bitwise equal to the plain version; at {tuple(d.shape)} "
        f"k={k}: kernel {k_ms:.4f} ms device time ({e_ms:.4f} ms a call "
        f"by CUDA events), plain {p_ms:.4f} ms, library none "
        f"(torch.topk breaks no ties by id), bound {bound:.6f} ms ({by})")
    return ("batched_topk_merge", k_ms, p_ms, bound, by, None)


def measure_graph(record, orig):
    """The beam search on every input the graph path gave it: all four
    outputs bitwise against its plain version and against what the path
    got, each input shape printed; a default-plan g6 batch timed (every
    launch of a wrapper call, from a profiler trace).  Bound: the vectors,
    pks and bitmap bytes of the rows the walk gathered (each read once), the
    queries, entries and outputs; 3 d operations per gathered row (the
    neighbour lists it reads are left out: a lower bound).  No single
    PyTorch call computes it."""
    import torch
    from repro_torch.kernels import ref
    timed = None
    shapes = {}
    for a, got in record["graph"]:
        o = orig["graph"](*a)
        torch.cuda.synchronize()
        graph_compare(o, ref.graph_search_topk_ref(*a), "graph-path input")
        graph_compare(o, got, "graph-path output")
        if timed is None:
            timed = (a, got)
        key = tuple(a[0].shape) + tuple(a[2].shape) + (a[3].shape[1],
                                                      a[6], a[7])
        shapes[key] = shapes.get(key, 0) + 1
    for key, calls in sorted(shapes.items()):
        log(f"graph_search path shape (nq, d, n, R, entries, beam, hops) "
            f"{key}: {calls} calls")
    a, got = timed
    q, x, nbr, ent, mask, pks, beam, hops = a
    nq, d = q.shape
    gathered = int(popcounts(got[3]).sum())
    nbytes = (gathered * (4 * d + 4 + 1) + q.numel() * 4 + ent.numel() * 4
              + nq * beam * 12 + got[3].numel() * 4)
    bound, by = row_bound(nbytes, gathered * 3 * d)
    e_ms = cuda_ms(lambda: orig["graph"](*a))
    k_ms = kernel_ms(lambda: orig["graph"](*a), None)
    p_ms = cuda_ms(lambda: ref.graph_search_topk_ref(*a), reps=3, warm=1)
    log(f"kernel graph_search_topk: {len(record['graph'])} graph-path "
        f"inputs, d2, pks, rows and visited words bitwise equal to the plain "
        f"version and to the path's outputs; at nq={nq} rows={x.shape[0]} "
        f"R={nbr.shape[1]} entries={ent.shape[1]} beam={beam} hops={hops} "
        f"({gathered} rows gathered): kernel {k_ms:.4f} ms device time "
        f"(every launch of a call; {e_ms:.4f} ms a call by CUDA events), "
        f"plain {p_ms:.4f} ms, "
        f"library none, bound {bound:.6f} ms ({by})")
    return ("graph_search_topk", k_ms, p_ms, bound, by, None,
            {"events_ms": e_ms})


def measure_topk(orig, dev):
    """The single-list merge, which no path runs (only ``ops.merge_topk``
    reaches it): timed at one query's sharded merge shape, (4, 10) -> 10,
    by its device time in a profiler trace, against its plain version.  No single PyTorch call breaks ties by
    position as it does (``torch.sort(stable=True)`` + a slice is two)."""
    import torch
    from repro_torch.kernels import ref
    rng = np.random.default_rng(4)
    d = torch.from_numpy(rng.uniform(0, 10, (4, 10)).astype(
        np.float32)).to(dev)
    i = torch.arange(40, dtype=torch.int64, device=d.device).view(4, 10)
    o = orig["topk"](d, i, 10)
    torch.cuda.synchronize()
    w = ref.topk_merge_ref(d, i, 10)
    check(same_bits(o[0], w[0]) and same_bits(o[1], w[1]),
          "topk_merge differs from the plain version")
    e_ms = cuda_ms(lambda: orig["topk"](d, i, 10))
    k_ms = kernel_ms(lambda: orig["topk"](d, i, 10), "topk_merge_kernel")
    p_ms = cuda_ms(lambda: ref.topk_merge_ref(d, i, 10))
    bound, by = row_bound(40 * 12 + 10 * 12, 40)
    log(f"kernel topk_merge at (4, 10) k=10: kernel {k_ms:.4f} ms device "
        f"time ({e_ms:.4f} ms a call by CUDA events), plain "
        f"{p_ms:.4f} ms, library none, bound {bound:.7f} ms ({by})")
    return ("topk_merge", k_ms, p_ms, bound, by, None)


def measure_quantized(record, orig):
    """The quantized scan on every template's recorded main-path input,
    bitwise against its plain version; g6's batch timed with the plain
    version and a library yardstick (gather-sum + where + topk)."""
    import torch
    from repro_torch.kernels import fused_scan, quantized_scan
    check(bool(record["quantized"]), "the quantized scan recorded no input")
    row = None
    for tname, a in record["quantized"].items():
        kout = orig["quantized"](*a)
        torch.cuda.synchronize()
        plain = quantized_scan.plain(*a[:5])
        for x, y, what in zip(kout, plain, ("adc", "pks", "rows")):
            check(same_bits(x, y), f"quantized_scan_topk {tname} main-path "
                  f"input: {what} differ from the plain version")
        ck, mk, _ = fused_scan.compact(*a[1:5])
        nq, m = a[0].shape[0], ck.shape[1]
        pairs = int(mk.bool().sum())
        log(f"kernel quantized_scan_topk {tname} nq={nq} kept rows="
            f"{ck.shape[0]} m={m}: adc, pks and rows bitwise equal to the "
            f"plain version; {pairs} admitted (query, row) pairs")
        if tname != "g6":
            continue
        rows_any = int(mk.bool().any(dim=0).sum())
        nbytes = (rows_any * (m + 4) + a[2].numel() + a[0].numel() * 4
                  + nq * 128 * 12)
        flops = m * pairs
        e_ms = cuda_ms(lambda: orig["quantized"](*a))
        stages = {k: kernel_ms(lambda: orig["quantized"](*a), k)
                  for k in QSCAN_KERNELS}
        k_ms = kernel_ms(lambda: orig["quantized"](*a), QSCAN_KERNELS)
        log(f"kernel quantized_scan_topk {tname}: device time "
            + ", ".join(f"{k} {v:.4f}" for k, v in stages.items())
            + f" ms; {k_ms:.4f} ms in all ({e_ms:.4f} ms a call by CUDA "
            f"events)")
        p_ms = cuda_ms(lambda: quantized_scan.plain(*a[:5]), reps=3, warm=1)
        lut3 = a[0].view(nq, m, 256)

        def library():
            idx = ck.T.long().unsqueeze(0).expand(nq, -1, -1)
            dd = torch.gather(lut3, 2, idx).sum(dim=1)
            dd = torch.where(mk.bool(), dd, torch.full_like(dd, float("inf")))
            return torch.topk(dd, 128, dim=1, largest=False)
        l_ms = cuda_ms(library, reps=3, warm=1)
        bound, by = row_bound(nbytes, flops)
        row = ("quantized_scan_topk", k_ms, p_ms, bound, by, l_ms)
        log(f"kernel quantized_scan_topk {tname}: kernel {k_ms:.4f} ms "
            f"device time, plain "
            f"{p_ms:.4f} ms, gather-sum+where+topk {l_ms:.4f} ms, bound "
            f"{bound:.4f} ms ({by}, {nbytes} bytes)")
    check(row is not None, "g6 never reached the quantized scan")
    return row


def busy_share(ctx) -> None:
    """Device busy share of one more t6, g6 and t2 batch on the main store
    and one t6 batch on the sharded store (after the counts were read):
    device time of every kernel and copy in a ``torch.profiler`` trace
    over the batch's wall time.  An untraced batch of the same template
    runs first, so the traced one finds the store's packs on the card (the
    later paths' packs may have evicted them from the LRU).  A trace
    without device events is reported as not measured."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    runs = []
    if "main" in ctx:
        m = ctx["main"]
        ex, tmpl, gt = m["ex"], m["tmpl"], m["gt"]
        runs += [("t6", ex, lambda: tmpl["t6"]()[0]),
                 ("g6", ex, lambda: gt["g6"]()[0]),
                 ("t2", ex, lambda: tmpl["t2"]()[0])]
    if "sharded" in ctx:
        sex, stmpl = ctx["sharded"]["ex"], ctx["sharded"]["tmpl"]
        runs.append(("sharded t6", sex, lambda: stmpl["t6"]()[0]))
    for name, ex, draw in runs:
        ex.execute_many([draw() for _ in range(8)])
        torch.cuda.synchronize()
        queries = [draw() for _ in range(8)]
        try:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                ex.execute_many(queries)
                torch.cuda.synchronize()
                wall_us = (time.perf_counter() - t0) * 1e6
            dev_us = sum(getattr(e, "self_device_time_total", 0.0)
                         for e in prof.key_averages())
            busy_us = device_busy_us(prof)
        except RuntimeError as e:        # a tracer the sandbox refuses
            log(f"busy share {name}: not measured ({e})")
            continue
        if busy_us <= 0:
            log(f"busy share {name}: not measured (no device events)")
            continue
        log(f"busy share {name}: device busy {busy_us / 1e3:.3f} ms of "
            f"{wall_us / 1e3:.3f} ms traced batch wall time "
            f"({100 * busy_us / wall_us:.2f} % busy, "
            f"{100 - 100 * busy_us / wall_us:.2f} % idle; the per-op sum of "
            f"self device time, which may count an interval more than once, "
            f"is {dev_us / 1e3:.3f} ms)")


def device_busy_us(prof) -> float:
    """Microseconds in which the card ran at least one traced kernel,
    copy or fill: the union of the device events' intervals."""
    from torch.autograd import DeviceType
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if getattr(e, "device_type", None) == DeviceType.CUDA)
    busy, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy


def card_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    check(r.returncode == 0, f"nvidia-smi failed: {r.stderr.strip()}")
    return r.stdout.strip().splitlines()[0]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phase", default="all",
                    choices=("all", "kernels", "main", "sharded", "graph",
                             "continuous"))
    args = ap.parse_args()
    if not (HERE / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        print("chip_smoke.py: src/repro_torch not found beside this script;"
              " run it from the root of a checkout of the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(HERE / "src"))
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device (torch.cuda.is_available() "
              "is false)", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    from repro_torch.kernels import build
    try:
        log(card_line())
        log(sys.version.split()[0], torch.__version__, torch.version.cuda)
        t0 = time.perf_counter()
        build.build_all()
        log(f"kernel build: {time.perf_counter() - t0:.1f} s "
            f"(nvcc, {len(build.SOURCES)} sources in parallel)")
        for name, text in build.BUILD_LOG.items():
            for ln in text.splitlines():
                if "registers" in ln or "spill" in ln or "error" in ln:
                    log(f"  {name}: {ln.strip()}")
        errs = {n: 0.0 for n in SOURCES}
        edge_checks(dev, errs)
        adc_edge_checks(dev, errs)
        merge_edge_checks(dev)
        graph_edge_checks(dev)
        if args.phase == "kernels":
            log("kernels phase finished: no result")
            return 0
        record = {}
        orig = install_recorder(record)
        install_probe_counter(record)
        run = ("main", "sharded", "graph", "continuous") \
            if args.phase == "all" else (args.phase,)
        paths, ctx = {}, {}
        if "main" in run:
            paths["main"], ctx["main"] = main_path(dev, record)
            paths["quantized"] = quantized_path(dev, record, ctx["main"])
            paths["IVF-PQ"] = pqivf_path(dev)
        if "sharded" in run:
            paths["sharded"], ctx["sharded"] = sharded_path(dev, record)
        if "graph" in run:
            paths["graph"], ctx["graph"] = graph_path(dev, record)
        if "continuous" in run:
            paths["continuous"], paths["sharded continuous"] = \
                continuous_path(dev, record)
        for path, must in (("main", ("fused_scan_topk", "ivf_scan",
                                     "bitmap_filter")),
                           ("quantized", ("quantized_scan_topk",
                                          "fused_scan_topk")),
                           ("IVF-PQ", ("pq_adc", "ivf_scan")),
                           ("sharded", ("batched_topk_merge",
                                        "fused_scan_topk", "ivf_scan",
                                        "bitmap_filter")),
                           ("graph", ("graph_search_topk",
                                      "fused_scan_topk")),
                           ("continuous", ("ivf_scan", "bitmap_filter")),
                           ("sharded continuous", ("batched_topk_merge",
                                                   "ivf_scan"))):
            if path not in paths:
                continue
            log(f"{path} path launches: {paths[path]}; "
                f"{bitmap_entries(paths[path])}")
            for name in must:
                check(paths[path][name] > 0,
                      f"{name} never launched on the {path} path")
        launches = {n: sum(c.get(n, 0) for c in paths.values())
                    for n in list(SOURCES) + [ENTRY]}
        line = measure(record, orig, launches, errs, dev)
        if args.phase == "all":
            check(sorted(r["name"] for r in line) == sorted(SOURCES),
                  "the kernel line lacks a kernel")
        busy_share(ctx)
        log(card_line())
        log(json.dumps({"kernels": line}))
    except SmokeFailure as e:
        print(f"chip_smoke.py: FAILED: {e}", file=sys.stderr)
        return 1
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
