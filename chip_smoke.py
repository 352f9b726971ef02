#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

1. Builds the five hand-written CUDA kernels from
   ``src/repro_torch/kernels/csrc`` (one ``nvcc`` per source, in parallel)
   and holds each against its plain PyTorch version at edge shapes (the two
   ADC kernels bitwise).
2. Drives the port's main path: one TRACY tweet store (128-d embeddings,
   IVF / ZORDER / INVERTED / BTREE indexes, flush_rows 2048, fanout 4,
   pq_m 8) filled through ``LSMStore.put``/``flush`` on the card, then the
   exact hybrid templates t6, t8, t10, t13 (one rank term, no
   recall_target) and the filter-only t2, t4 through
   ``Executor.execute_many`` in 21 batches of 8 each (the first, which
   uploads the packed column, reported apart).  The kernels' launch counts
   are zeroed just before and read just after; each must be > 0.
3. Holds every NN answer against a plain PyTorch brute force on the card
   in float64 (``tie_aware`` at the fp32 rounding bound ``round_bound``:
   each reported d2 within it of its row's exact d2 and of the exact j-th
   d2; a pk in one answer and not the other only where its exact d2 is
   within it of the k-th), printing tol / k-th d2 per template, and every
   filter answer against a numpy evaluation of the predicate.
4. The quantized path on the same store: TRACY's recall-targeted templates
   g6, g8, g13 (``benchmarks/tracy.py`` ``make_graph_templates`` at
   recall_target 0.9, as ``benchmarks/pq_study.py`` drives them) through
   ``Executor.execute_many``, 21 batches of 8 each, each answer held
   against the float64 brute force over the survivors the ADC kernel kept
   (the exact re-rank) and in (score, pk) order; recall@10 against the
   exact dispatch on the same draws; g6 at refine 12 against the exact
   dispatch, bitwise.
5. The IVF-PQ probe: a 262,144-row TRACY store whose embedding column is
   ``IndexKind.PQIVF``, 20 t6- and 20 t8-shape queries through
   ``Executor.execute`` with a forced ``postfilter_nn`` plan; every
   returned distance against float64, recall@10 against a brute force.
6. Holds each kernel against its plain version on the inputs the paths
   gave it, times both and one PyTorch library call, traces one more t6,
   g6 and t2 batch for the device's busy share, and prints one JSON line
   ``{"kernels": [...]}``; the last line is
   ``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}``.

Each path's launch counts are zeroed just before it and read just after;
every kernel of the path must have launched.

    python3 chip_smoke.py                   # the full run (one GPU)
    python3 chip_smoke.py --phase kernels   # build + edge checks only

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
BATCHES = 21                      # per template: the first, then 20 timed
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
}


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def log(*a) -> None:
    print(*a, flush=True)


def kernel_modules():
    """Each hand-written kernel's wrapper module, by the kernel's name."""
    from repro_torch.kernels import (bitmap_filter, fused_scan, ivf_scan,
                                     pq_adc, quantized_scan)
    return {"fused_scan_topk": fused_scan, "ivf_scan": ivf_scan,
            "bitmap_filter": bitmap_filter,
            "quantized_scan_topk": quantized_scan, "pq_adc": pq_adc}


def counts():
    return {n: m.launches.value for n, m in kernel_modules().items()}


def reset_counts() -> None:
    for m in kernel_modules().values():
        m.launches.reset()


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
    prepares them (``ops.fused_kernel_args``)."""
    from repro_torch.kernels import fused_scan as fs
    from repro_torch.kernels import ops
    q = rng.normal(size=(nq, d)).astype(np.float32)
    x = rng.normal(size=(n, d)).astype(np.float32)
    if dup:                       # equal d2 with distinct pks
        x[1::2] = x[0::2][:len(x[1::2])]
    if mask_kind == "partial":
        mask = rng.random((nq, n)) < 0.3
    elif mask_kind == "holes":
        mask = np.ones((nq, n), bool)
        mask[:, :fs.BLOCK_N] = False
        mask[:, n // 2:n // 2 + fs.BLOCK_N] = False
    else:                         # "sparse": few rows, some queries none
        mask = np.zeros((nq, n), bool)
        for qi in range(nq):
            if qi % 3:
                mask[qi, rng.choice(n, size=qi % 7, replace=False)] = True
    pks = rng.permutation(n).astype(np.int64) * 3 + 1
    return ops.fused_kernel_args(q, x, mask, pks, dev)[0]


def fused_plain(args):
    """The plain version of the packed kernel on the same inputs, and the
    compacted (x, mask) it scans."""
    from repro_torch.kernels import fused_scan as fs
    xk, mk, _ = fs.compact(*args[1:5])
    return fs.plain(*args[:5]), (xk, mk)


def fused_compare(args, out, plain) -> tuple:
    """Hold the kernel's and the plain version's answers against the exact
    one (``tie_aware``, per query at ``round_bound`` over the rows either
    names).  Returns (max |d2 kernel - d2 plain| over filled slots, tie
    swaps, median tol / k-th d2 over queries with a full answer); raises on
    a disagreement or on a kernel order that is not strict."""
    import torch
    from repro_torch.kernels import fused_scan as fs
    q, d = args[0], args[0].shape[1]
    xk, mk, pk = fs.compact(*args[1:5])
    x64, q64 = xk.double(), q.double()
    xn = (x64 ** 2).sum(dim=1)
    kd, kp, ki = (t.cpu().numpy() for t in out)
    rd, rp, ri = (t.cpu().numpy() for t in plain)
    err, swaps, power = 0.0, 0, []
    for qi in range(len(kd)):
        td, tp, trow = exact_topk(q64[qi], x64, mk[qi].bool(), pk[0],
                                  fs.KMAX)
        kf, rf = np.isfinite(kd[qi]), np.isfinite(rd[qi])
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
        for j in range(nk - 1):
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


def edge_checks(dev, errs) -> None:
    import torch
    from repro_torch.kernels import bitmap_filter, fused_scan, ivf_scan, ref
    rng = np.random.default_rng(0)
    for nq, n, d, kind, dup in [(3, 1000, 16, "partial", False),
                                (13, 1537, 128, "holes", False),
                                (10, 2048, 8, "sparse", False),
                                (8, 1100, 4, "partial", True),
                                (16, 600, 2, "partial", True)]:
        args = fused_inputs(rng, nq, n, d, dev, kind, dup)
        out = fused_scan.fused_scan_topk(*args)
        torch.cuda.synchronize()
        plain, _ = fused_plain(args)
        err, swaps, power = fused_compare(args, out, plain)
        errs["fused_scan_topk"] = max(errs["fused_scan_topk"], err)
        log(f"edge fused_scan_topk nq={nq} n={n} d={d} mask={kind} "
            f"ties={dup}: max|dd2|={err:.3g} tie swaps={swaps} "
            f"median tol/kth d2={power:.3g}")
    for nq, n, d, padded in [(3, 1000, 100, False), (1, 128, 7, False),
                             (9, 512, 128, True), (2048, 512, 128, True)]:
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
        log(f"edge ivf_scan nq={nq} n={n} d={d} padded={padded}: "
            f"max|dd2|={err:.3g}")
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
    pks = rng.permutation(n).astype(np.int64) * 3 + 1
    return q, codes, books, mask, pks


def adc_edge_checks(dev, errs) -> None:
    """The two ADC kernels against their plain versions, bitwise: the
    quantized scan through the main path's host prep (wrapper level, all
    KMAX slots) and through ``ops`` at k' in {1, 40, 128} against the same
    host logic over the plain version; the single-query ADC at ragged
    shapes."""
    import torch
    from repro_torch.kernels import ops, pq_adc, quantized_scan, ref
    rng = np.random.default_rng(1)
    host = torch.device("cpu")
    for nq, n, m, kind in [(8, 1000, 8, "partial"), (13, 1537, 16, "holes"),
                           (16, 1, 4, "full"), (16, 2048, 8, "tile_empty"),
                           (8, 1100, 8, "dup"), (10, 700, 4, "partial")]:
        q, codes, books, mask, pks = adc_case(rng, nq, n, m, kind)
        lut = ops.adc_lut(q, books)
        args, _ = ops.quantized_kernel_args(lut, codes, mask, pks, dev)
        out = quantized_scan.quantized_scan_topk(*args)
        torch.cuda.synchronize()
        plain = quantized_scan.plain(*args[:5])
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
        for k, v in (("embedding", emb), ("coordinate", pts), ("time", tm),
                     ("t1", t1), ("t2", t2)):
            self.cols[k].append(v)
        return list(range(pk0, pk0 + n)), batch

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


def tracy_store(dev, data: TracyData, rows: int, vector_index: str):
    """The TRACY tweet table (``benchmarks/tracy.py``'s schema at its
    published widths: 128-d embeddings with ``vector_index``, ZORDER
    points, INVERTED text, BTREE time and likes; flush_rows 2048, fanout
    4, pq_m 8) filled with ``rows`` rows through ``LSMStore.put`` and
    ``flush`` on ``dev``.  Returns (store, ingest seconds)."""
    import torch
    from repro_torch.core.lsm import LSMConfig, LSMStore
    from repro_torch.core.types import Column, ColumnType, IndexKind, Schema
    schema = Schema([
        Column("embedding", ColumnType.VECTOR, dim=data.dim,
               index=IndexKind[vector_index]),
        Column("coordinate", ColumnType.SPATIAL, index=IndexKind.ZORDER),
        Column("content", ColumnType.TEXT, index=IndexKind.INVERTED),
        Column("time", ColumnType.SCALAR, index=IndexKind.BTREE),
        Column("likes", ColumnType.SCALAR, index=IndexKind.BTREE)])
    t0 = time.perf_counter()
    store = LSMStore(schema, LSMConfig(flush_rows=2048, fanout=4, pq_m=8),
                     device=dev)
    done = 0
    while done < rows:
        n = min(2048, rows - done)
        pks, batch = data.batch(done, n)
        store.put(pks, batch)
        done += n
    store.flush()
    torch.cuda.synchronize()
    data.finish()
    return store, time.perf_counter() - t0


def main_path(dev, record):
    import torch
    from repro_torch.core.executor import Executor
    dim, rows = 128, ROWS
    log(f"main path: TRACY tweet table, {rows} rows (paper: "
        f"{PAPER_ROWS}; cut to fit the run's time limit), dim={dim} "
        f"flush_rows=2048 fanout=4 pq_m=8 device={dev}")
    data = TracyData(dim)
    reset_counts()
    store, ingest_s = tracy_store(dev, data, rows, "IVF")
    ingest = counts()
    log(f"ingest: {ingest_s:.2f} s, segments "
        f"{[s.n_rows for s in store.segments]}, launches {ingest}")

    ex = Executor(store)
    tmpl = templates(data)
    xs = {dim: torch.from_numpy(data.cols["embedding"]).to(dev, torch.float64),
          2: torch.from_numpy(data.cols["coordinate"]).to(dev, torch.float64)}
    swaps_total = 0
    for name in ("t6", "t8", "t10", "t13", "t2", "t4"):
        before = counts()
        times, plan_desc, swaps, checked, power = [], "", 0, 0, []
        for _ in range(BATCHES):
            made = [tmpl[name]() for _ in range(8)]
            record["template"] = name
            t1 = time.perf_counter()
            out = ex.execute_many([m[0] for m in made])
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
    return total, {"ex": ex, "tmpl": tmpl, "xs": xs}


def quantized_templates(tmpl):
    """TRACY's recall-targeted NN templates g6 (pure NN), g8 (NN + time
    range), g13 (disjunctive NN): t6, t8, t13 with recall_target 0.9.  Each
    draw returns (quantized query, its exact twin of the same draw,
    brute-force mask function, rank spec)."""
    from repro_torch.core import query as q

    def make(tname):
        def g():
            exact, mask_fn, spec = tmpl[tname]()
            quant = q.HybridQuery(where=exact.where, ranks=exact.ranks,
                                  k=exact.k, recall_target=RECALL_TARGET)
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
    batches of 8 each through ``Executor.execute_many``."""
    import torch
    ex, xs = ctx["ex"], ctx["xs"]
    n = len(xs[128])
    gt = quantized_templates(ctx["tmpl"])
    ctx["gt"] = gt
    total = dict.fromkeys(SOURCES, 0)

    def quantized_run(qs, plans=None):
        """One quantized ``execute_many``, its launches counted from 0 just
        before it to just after it; the exact dispatch's comparison runs
        stay outside these windows."""
        reset_counts()
        out = ex.execute_many(qs, plans=plans)
        torch.cuda.synchronize()
        for k, v in counts().items():
            total[k] += v
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
    from repro_torch.core.executor import Executor
    from repro_torch.core.optimizer.planner import Plan
    dim, rows = 128, PQIVF_ROWS
    log(f"IVF-PQ probe: TRACY tweet table with embedding PQIVF, {rows} rows "
        f"(paper: {PAPER_ROWS}; cut to keep the whole smoke inside the "
        f"run's time limit), dim={dim} flush_rows=2048 fanout=4 pq_m=8")
    data = TracyData(dim, seed=1)
    reset_counts()
    store, ingest_s = tracy_store(dev, data, rows, "PQIVF")
    log(f"IVF-PQ ingest: {ingest_s:.2f} s, segments "
        f"{[s.n_rows for s in store.segments]}, launches {counts()}")
    ex = Executor(store)
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


# ---------------------------------------------------------------------------
# phase 3: kernels on the main path's inputs
# ---------------------------------------------------------------------------

def install_recorder(record):
    """Keep the inputs the paths hand each kernel wrapper (one set per
    template for the two scans, the last fused call apart, one per shape
    for the others).  A ``template`` of None records no scan inputs."""
    from repro_torch.kernels import (bitmap_filter, fused_scan, ivf_scan,
                                     pq_adc, quantized_scan)
    orig = {"fused": fused_scan.fused_scan_topk, "ivf": ivf_scan.ivf_scan,
            "bitmap": bitmap_filter.bitmap_filter,
            "quantized": quantized_scan.quantized_scan_topk,
            "pq": pq_adc.pq_adc}
    record.update(fused={}, quantized={}, ivf={}, bitmap={}, pq={})

    def per_template(kind):
        def rec(*a):
            if kind == "fused":
                record["fused_last"] = a
            if record.get("template") is not None:
                record[kind][record["template"]] = a
            return orig[kind](*a)
        return rec

    def per_shape(kind):
        def rec(x, y):
            key = tuple(x.shape) + tuple(y.shape)
            hit = record[kind].get(key)
            if hit is None and len(record[kind]) < 64:
                record[kind][key] = [x.clone(), y.clone(), 0]
            if key in record[kind]:
                record[kind][key][2] += 1
            return orig[kind](x, y)
        return rec

    fused_scan.fused_scan_topk = per_template("fused")
    quantized_scan.quantized_scan_topk = per_template("quantized")
    ivf_scan.ivf_scan = per_shape("ivf")
    bitmap_filter.bitmap_filter = per_shape("bitmap")
    pq_adc.pq_adc = per_shape("pq")
    return orig


def measure(record, orig, launches, errs):
    import torch
    from repro_torch.kernels import ref
    out = []
    # fused scan: every template's main-path call, the full scan timed
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
        bound = max(nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS) * 1e3
        by = "bytes" if nbytes / HBM_BYTES_PER_S >= flops / FP32_FLOPS \
            else "operations"
        fs_rows[tname] = (k_ms, p_ms, bound, by, l_ms)
        log(f"kernel fused_scan_topk {tname} nq={nq} kept rows="
            f"{xk.shape[0]} d={d}: max|dd2|={err:.3g} tie swaps={swaps} "
            f"median tol/kth d2={power:.3g}; "
            f"{pairs} admitted (query, row) pairs; kernel {k_ms:.4f} ms, "
            f"plain {p_ms:.4f} ms, cdist+where+topk {l_ms:.4f} ms, bound "
            f"{bound:.4f} ms ({by})")
    main = "t6" if "t6" in fs_rows else next(iter(fs_rows))
    k_ms, p_ms, bound, by, l_ms = fs_rows[main]
    out.append(("fused_scan_topk", k_ms, p_ms, bound, by, l_ms))
    out.append(measure_quantized(record, orig))

    for kind, name in (("ivf", "ivf_scan"), ("bitmap", "bitmap_filter"),
                       ("pq", "pq_adc")):
        best = None
        for key, (x, y, calls) in sorted(record[kind].items(),
                                         key=lambda kv: -kv[1][2]):
            o = orig[kind](x, y)
            torch.cuda.synchronize()
            if kind == "ivf":
                err = ivf_compare(x, y, o, ref.ivf_scan_ref(x, y))
                nq, d = x.shape
                n = y.shape[0]
                nbytes = 4 * (nq * d + n * d + nq * n)
                flops = 2 * nq * n * d
                lib = (lambda x=x, y=y: torch.cdist(x, y).square())
                plain = (lambda x=x, y=y: ref.ivf_scan_ref(x, y))
            elif kind == "pq":
                check(same_bits(o, ref.pq_adc_ref(x, y)), f"pq_adc main-path "
                      f"input {key}: differs from the plain version")
                err = 0.0
                n, m = x.shape
                nbytes, flops = n * m + 4 * y.numel() + 4 * n, n * m
                # the library yardstick: one gather of the LUT, summed
                lib = (lambda x=x, y=y:
                       torch.gather(y, 1, x.T.long()).sum(dim=0))
                plain = (lambda x=x, y=y: ref.pq_adc_ref(x, y))
            else:
                want = ref.bitmap_filter_ref(x, y)
                err = float((o.bool() != want).sum())
                check(err == 0, f"bitmap_filter main-path input {key}: "
                      f"{int(err)} rows differ")
                n, c = x.shape
                nbytes, flops = 4 * n * c + n + 8 * c, 2 * n * c
                lib = None
                plain = (lambda x=x, y=y: ref.bitmap_filter_ref(x, y))
            errs[name] = max(errs[name], err)
            if best is None:          # the main path's most frequent shape
                k_ms = cuda_ms(lambda x=x, y=y: orig[kind](x, y))
                p_ms = cuda_ms(plain)
                l_ms = cuda_ms(lib) if lib is not None else None
                tb, tf = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS
                bound = max(tb, tf) * 1e3
                by = "bytes" if tb >= tf else "operations"
                best = (name, k_ms, p_ms, bound, by, l_ms)
                log(f"kernel {name} {key} ({calls} main-path launches at "
                    f"this shape): kernel {k_ms:.4f} ms, plain {p_ms:.4f} "
                    f"ms, library {l_ms if l_ms is None else round(l_ms, 4)}"
                    f" ms, bound {bound:.5f} ms ({by})")
        log(f"kernel {name}: {len(record[kind])} main-path shapes held "
            f"against the plain version, max abs err {errs[name]:.3g}")
        out.append(best)
    line = []
    for name, k_ms, p_ms, bound, by, l_ms in out:
        src, rep = SOURCES[name]
        line.append({"name": name, "route": "cuda", "source": src,
                     "replaces": rep, "launches": launches[name],
                     "max_abs_err": errs[name], "ms": k_ms,
                     "plain_ms": p_ms, "bound_ms": bound, "bound_by": by,
                     "library_ms": l_ms})
    return line


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
        k_ms = cuda_ms(lambda: orig["quantized"](*a))
        p_ms = cuda_ms(lambda: quantized_scan.plain(*a[:5]), reps=3, warm=1)
        lut3 = a[0].view(nq, m, 256)

        def library():
            idx = ck.T.long().unsqueeze(0).expand(nq, -1, -1)
            dd = torch.gather(lut3, 2, idx).sum(dim=1)
            dd = torch.where(mk.bool(), dd, torch.full_like(dd, float("inf")))
            return torch.topk(dd, 128, dim=1, largest=False)
        l_ms = cuda_ms(library, reps=3, warm=1)
        tb, tf = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS
        bound = max(tb, tf) * 1e3
        by = "bytes" if tb >= tf else "operations"
        row = ("quantized_scan_topk", k_ms, p_ms, bound, by, l_ms)
        log(f"kernel quantized_scan_topk {tname}: kernel {k_ms:.4f} ms, plain "
            f"{p_ms:.4f} ms, gather-sum+where+topk {l_ms:.4f} ms, bound "
            f"{bound:.4f} ms ({by}, {nbytes} bytes)")
    check(row is not None, "g6 never reached the quantized scan")
    return row


def busy_share(ctx) -> None:
    """Device busy share of one more t6, g6 and t2 batch (after the counts
    were read): device time of every kernel and copy in a
    ``torch.profiler`` trace over the batch's wall time.  A trace without
    device events is reported as not measured."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    ex, tmpl, gt = ctx["ex"], ctx["tmpl"], ctx["gt"]
    draw = {"t6": lambda: tmpl["t6"]()[0], "g6": lambda: gt["g6"]()[0],
            "t2": lambda: tmpl["t2"]()[0]}
    for name in ("t6", "g6", "t2"):
        queries = [draw[name]() for _ in range(8)]
        try:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                ex.execute_many(queries)
                torch.cuda.synchronize()
                wall_us = (time.perf_counter() - t0) * 1e6
            dev_us = sum(getattr(e, "self_device_time_total", 0.0)
                         for e in prof.key_averages())
        except RuntimeError as e:        # a tracer the sandbox refuses
            log(f"busy share {name}: not measured ({e})")
            continue
        if dev_us <= 0:
            log(f"busy share {name}: not measured (no device events)")
            continue
        log(f"busy share {name}: device {dev_us / 1e3:.3f} ms of "
            f"{wall_us / 1e3:.3f} ms traced batch wall time "
            f"({100 * dev_us / wall_us:.2f} % busy, "
            f"{100 - 100 * dev_us / wall_us:.2f} % idle)")


def card_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    check(r.returncode == 0, f"nvidia-smi failed: {r.stderr.strip()}")
    return r.stdout.strip().splitlines()[0]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phase", choices=("all", "kernels"), default="all")
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
        if args.phase == "kernels":
            log("kernels phase finished: no result")
            return 0
        record = {}
        orig = install_recorder(record)
        paths = {}
        paths["main"], ctx = main_path(dev, record)
        paths["quantized"] = quantized_path(dev, record, ctx)
        paths["IVF-PQ"] = pqivf_path(dev)
        for path, must in (("main", ("fused_scan_topk", "ivf_scan",
                                     "bitmap_filter")),
                           ("quantized", ("quantized_scan_topk",
                                          "fused_scan_topk")),
                           ("IVF-PQ", ("pq_adc", "ivf_scan"))):
            log(f"{path} path launches: {paths[path]}")
            for name in must:
                check(paths[path][name] > 0,
                      f"{name} never launched on the {path} path")
        launches = {n: sum(c[n] for c in paths.values()) for n in SOURCES}
        line = measure(record, orig, launches, errs)
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
