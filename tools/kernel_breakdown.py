#!/usr/bin/env python3
"""Break earlier kernels down on the card, and hold this tree's kernels
against the earlier ones bitwise.

    python3 tools/kernel_breakdown.py [--parent A42] [--fused-parent C4]
        [--graph-parent P21] [--only SECTIONS] [--no-variants]
        [--shapes-from LOG]

``A42`` is the ``src/repro_torch/kernels/csrc`` directory of ``a42a644``
(whose quantized scan and ``ivf_scan`` a later tree replaced), ``C4``
that of ``c4ac6b8`` (whose fused scan a later tree replaced) and ``P21``
that of ``75ad3ab`` (whose beam search a later tree replaced), each
unpacked from ``git archive <commit> src/repro_torch/kernels`` into a
directory that ``.gitignore`` lists (``archive_check/``).  The patches
below match those commits' sources line for line, so the variants build
from them alone.  Sections (``--only``, comma-separated; all by default):

- ``qscan`` (A42): that ``quantized_scan.cu`` as it is and in variants
  with one part taken out (the offers to the top-k lists, the LUT
  gathers, the mask reads, both the offers and the gathers) or with its
  list inserts counted, each variant's two launches (pass 1, the chunk
  merge) timed by device time at the shape of the quantized path's g6
  batch (8 queries x 2,097,152 rows, m = 8, every row admitted, 4,096
  kept blocks), with the earlier chunking, one chunk and 2,048 chunks;
  this tree's kernel timed on the same inputs and held to it bitwise.
- ``ivf`` (A42): this tree's ``ivf_scan`` held to that one bitwise at
  ``IVF_SHAPES`` and at every path shape a ``chip_smoke.py`` log lists
  (``--shapes-from``), both timed at ``IVF_SHAPES``.
- ``fused`` (C4): that ``fused_scan.cu`` as it is and in variants
  without its offers to the top-k lists, without its chunk merge,
  without its loads of x, without both offers and loads, or with its list
  inserts counted (``--no-variants``: as it is only), pass 1 and the
  merge timed apart by device time at ``FUSED_SHAPES`` (t6's 8 x
  2,097,152 rows at d 128 and a shard's 262,144, every row admitted; a
  re-rank's 40 rows a query over 2,097,152); this tree's kernel timed on
  the same inputs, every launch of a call apart, paired with the earlier
  (earlier, this tree, this tree, earlier), and held to it bitwise (d2,
  pks, rows) there, at ``chip_smoke.FUSED_EDGE`` and at every fused path
  shape a smoke log lists.
- ``qhold`` (C4): this tree's quantized scan, whose threshold and select
  it shares with the fused scan, held bitwise to c4ac6b8's at g6's shape
  and at ``chip_smoke.ADC_EDGE``, and timed paired at g6.
- ``tune``: this tree's fused scan launch without its FMAs and without
  its copies of x, and the whole call at other ring depths and chunk
  counts than the wrapper's (each held bitwise to the wrapper's answer),
  at t6's and a shard's shape.
- ``graph`` (P21): that ``graph_search.cu`` as it is and in variants
  without the scoring's row loads, without its sort, without its merges
  (the walk then ends after one hop), expanding only the beam's entries
  not expanded before (exact) or with each part of a round stamped by
  clock64 (``--no-variants``: as it is only), timed by device time at the
  graph path's own inputs (the smoke's GRAPH store, a g6 batch of 8 as
  planned and widened to beam 128 over 12 hops); this tree's kernel
  stamped the same way, timed paired with the earlier (earlier, this
  tree, this tree, earlier) and held to it bitwise in all four outputs
  there, at ``chip_smoke.GRAPH_EDGE`` and at every graph-path shape a
  smoke log lists (random CSR inputs).

Inputs are drawn from ``--seed`` on the card (g6: uniform codes and
squared-normal LUT entries; fused: normal q and x, a pk permutation;
graph: ``chip_smoke.graph_case``).
Timers and the bitwise comparison are ``chip_smoke.py``'s.  Variants are
written to and built in ``src/repro_torch/kernels/_build/breakdown/``
(ignored by git).  Needs one CUDA card and ``nvcc``; exits non-zero
without them.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

G6_NQ, G6_ROWS, G6_M = 8, 2_097_152, 8

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# the earlier tree's launchers (src/repro_torch/kernels/build.py there)
QSCAN_ARGS = [_P] * 12 + [_I, _I, _L, _I, _I, _I, _L, _P]
IVF_ARGS = [_P, _P, _P, _I, _I, _I, _P]
PASS1, MERGE = "quantized_scan_pass1", "topk_merge_chunks"

# text patches of the earlier quantized_scan.cu / topk_list.cuh
OFFER = ("        offer(L, v, dist_s[warp * kSlice + rr], cp, cr, lane, wd, "
         "wp, wr);")
NO_OFFER = "        sink += dist_s[warp * kSlice + rr] + (float)(cp ^ cr);"
LIST_DECL = "  WarpList L;\n  list_init(L);"
STORE = "  list_store(L, part_d, part_p, part_r,"
GATHER = ("            acc = __fadd_rn(acc, lq[j * kCodes + my[j]]);   "
          "// in j order")
NO_GATHER = "            acc = __fadd_rn(acc, (float)my[j]);"
MASK = ("        const bool ok = in_range && mask[(q0 + qq) * n_mask + prow] "
        "!= 0;")
NO_MASK = "        const bool ok = in_range;"
SINK = [(LIST_DECL, LIST_DECL + "\n  float sink = 0.f;"),
        (STORE, "  if (sink == 1234.5f) part_d[0] = sink;\n" + STORE)]
INSERT = ("    if (key_less(bd, bp, br, wd, wp, wr)) {  // the same on every "
          "lane\n")
COUNTER = ("extern \"C\" unsigned long long breakdown_inserts(int reset) {\n"
           "  unsigned long long h = 0, z = 0;\n"
           "  cudaMemcpyFromSymbol(&h, g_inserts, sizeof(h));\n"
           "  if (reset) cudaMemcpyToSymbol(g_inserts, &z, sizeof(z));\n"
           "  return h;\n}\n")

VARIANTS = {
    "as is": ([], []),
    "no offers": ([(OFFER, NO_OFFER)] + SINK, []),
    "no LUT gathers": ([(GATHER, NO_GATHER)], []),
    "no mask reads": ([(MASK, NO_MASK)], []),
    "no offers, no gathers": ([(OFFER, NO_OFFER), (GATHER, NO_GATHER)]
                              + SINK, []),
    "inserts counted": ([], [("namespace {", "__device__ unsigned long long "
                              "g_inserts = 0;\n\nnamespace {", 1),
                             (INSERT, INSERT + "      if (lane == 0) "
                              "atomicAdd(&g_inserts, 1ull);\n", 1)]),
}

# ivf_scan shapes (nq, n, d) timed against the earlier kernel: the paths'
# most launched (chip_smoke.py prints them with their launch counts), the
# single-query ones up to 131,072 rows, and edge shapes of every launch path
IVF_SHAPES = [(2048, 512, 128), (8, 512, 128), (8, 1024, 128),
              (8, 2048, 128), (8, 4096, 128), (8, 8192, 128),
              (8, 16384, 128), (8, 32768, 128), (8, 131072, 128),
              (2048, 512, 16), (16384, 2048, 128), (2048, 1024, 128),
              (1, 1000, 100), (1, 128, 7), (8, 1537, 2), (9, 512, 128),
              (64, 2048, 16), (13, 700, 7), (2048, 4096, 128),
              (2056, 512, 128), (4272, 512, 128), (1024, 512, 128)]


def log(*a):
    print(*a, flush=True)


def patch(text: str, subs) -> str:
    for sub in subs:
        old, new = sub[0], sub[1]
        count = sub[2] if len(sub) > 2 else -1
        if old not in text:
            raise cs.SmokeFailure(f"patch target not found: {old[:60]!r}")
        text = text.replace(old, new, count)
    return text


def build(src_dir: Path, name: str, subs_cu, subs_h, out_dir: Path):
    """Write one variant of ``name``.cu (with its own topk_list.cuh) into
    ``out_dir`` and start nvcc on it."""
    from repro_torch.kernels import build as kb
    out_dir.mkdir(parents=True, exist_ok=True)
    cu = patch((src_dir / f"{name}.cu").read_text(), subs_cu)
    if subs_h:
        cu += "\n" + COUNTER
    (out_dir / f"{name}.cu").write_text(cu)
    for h in src_dir.glob("*.cuh"):
        text = h.read_text()
        if h.name == "topk_list.cuh":
            text = patch(text, subs_h)
        (out_dir / h.name).write_text(text)
    lib = out_dir / f"{name}.so"
    cmd = [kb.nvcc_path(), *kb.NVCC_FLAGS, "-o", str(lib),
           str(out_dir / f"{name}.cu")]
    return lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True)


def load(lib_path: Path, proc, what: str) -> ctypes.CDLL:
    text, _ = proc.communicate()
    if proc.returncode != 0:
        raise cs.SmokeFailure(f"nvcc failed for {what}:\n{text}")
    return ctypes.CDLL(str(lib_path))


def g6_inputs(seed: int):
    import torch
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    lut = torch.randn((G6_NQ, G6_M * 256), generator=g, device=dev) ** 2
    codes = torch.randint(0, 256, (G6_ROWS, G6_M), generator=g, device=dev,
                          dtype=torch.uint8)
    mask = torch.ones((G6_NQ, G6_ROWS), dtype=torch.uint8, device=dev)
    pks = torch.randperm(G6_ROWS, generator=g, device=dev).to(torch.int32)
    nkeep = G6_ROWS // 512
    keep = torch.arange(nkeep, dtype=torch.int32, device=dev)
    occ = torch.ones((G6_NQ // 8, nkeep), dtype=torch.int32, device=dev)
    return lut, codes, mask, pks, keep, occ


def qscan_breakdown(parent: Path, seed: int, work: Path) -> dict:
    import torch
    from repro_torch.kernels import build as kb
    from repro_torch.kernels import quantized_scan
    libs = {}
    for v, (lib, proc) in {v: build(parent, "quantized_scan", cu, h,
                                    work / f"qscan_{i}")
                           for i, (v, (cu, h)) in
                           enumerate(VARIANTS.items())}.items():
        libs[v] = load(lib, proc, f"variant {v}")
        libs[v].quantized_scan_topk_launch.argtypes = QSCAN_ARGS
        libs[v].quantized_scan_topk_launch.restype = _I
    args = g6_inputs(seed)
    lut, codes, mask, pks, keep, occ = args
    dev = lut.device
    nq, nkeep = G6_NQ, keep.shape[0]
    # the earlier launcher's shared-memory sum (its quantized_scan.py)
    smem = 8 * G6_M * 256 * 4 + 8 * 256 * 4 + 256 * G6_M + 8 * 256
    stream = torch.cuda.current_stream(dev).cuda_stream

    def caller(v, per, chunks):
        out = tuple(torch.empty((nq, 128), dtype=dt, device=dev)
                    for dt in (torch.float32, torch.int32, torch.int32))
        part = tuple(torch.empty((nq, chunks, 128), dtype=dt, device=dev)
                     for dt in (torch.float32, torch.int32, torch.int32))
        fn = libs[v].quantized_scan_topk_launch

        def call():
            err = fn(lut.data_ptr(), codes.data_ptr(), mask.data_ptr(),
                     pks.data_ptr(), keep.data_ptr(), occ.data_ptr(),
                     *(t.data_ptr() for t in part + out), nq, G6_M,
                     G6_ROWS, nkeep, per, chunks, smem, stream)
            if err:
                raise cs.SmokeFailure(f"variant {v} launch failed: {err}")
            return out
        return call

    per0, chunks0 = parent_chunking(nq // 8, nkeep, kb.sm_count(dev))
    grids = {f"{chunks0} chunks (as chunked)": (per0, chunks0),
             "1 chunk": (nkeep, 1), "2048 chunks": (2, 2048)}
    res = {}
    base = caller("as is", per0, chunks0)()
    torch.cuda.synchronize()
    for v in VARIANTS:
        for gname, (per, chunks) in grids.items():
            if v != "as is" and not gname.endswith("(as chunked)"):
                continue
            call = caller(v, per, chunks)
            out = call()
            torch.cuda.synchronize()
            if v in ("as is", "no mask reads", "inserts counted"):
                for x, y, what in zip(out, base, ("adc", "pks", "rows")):
                    cs.check(cs.same_bits(x, y),
                             f"variant {v} {gname}: {what} differ")
            reps, warm = (5, 1) if chunks == 1 else (20, 3)
            t = {k: cs.kernel_ms(call, k, reps, warm) for k in (PASS1, MERGE)}
            res[f"{v} / {gname}"] = t
            log(f"qscan {v} / {gname}: pass 1 {t[PASS1]:.4f} ms, merge "
                f"{t[MERGE]:.4f} ms device time")
            if v == "inserts counted":
                lib = libs[v]
                lib.breakdown_inserts.argtypes = [_I]
                lib.breakdown_inserts.restype = ctypes.c_ulonglong
                lib.breakdown_inserts(1)
                call()
                torch.cuda.synchronize()
                n = lib.breakdown_inserts(1)
                cands = nq * G6_ROWS
                log(f"qscan inserts at {gname}: {n} list inserts (pass 1 and "
                    f"merge) for {cands} candidates ({100 * n / cands:.2f} %)")
                res["inserts"] = n
    # this tree's kernel on the same inputs
    new = quantized_scan.quantized_scan_topk(*args)
    torch.cuda.synchronize()
    for x, y, what in zip(new, base, ("adc", "pks", "rows")):
        cs.check(cs.same_bits(x, y), f"this tree's quantized_scan_topk: "
                 f"{what} differ from the earlier kernel's")
    t_new = cs.kernel_ms(lambda: quantized_scan.quantized_scan_topk(*args),
                         None)
    e_new = cs.cuda_ms(lambda: quantized_scan.quantized_scan_topk(*args))
    e_old = cs.cuda_ms(caller("as is", per0, chunks0))
    log(f"qscan this tree: {t_new:.4f} ms device time ({e_new:.4f} ms a call "
        f"by CUDA events, the earlier kernel {e_old:.4f}); adc, pks and rows "
        f"bitwise equal to the earlier kernel's")
    res["this tree"] = t_new
    res["events"] = {"this tree": e_new, "earlier": e_old}
    return res


# ------------------------------------------------------------- fused scan

# the earlier fused scan's launcher and kernels (c4ac6b8's build.py and
# fused_scan.cu): pass 1 and the chunk merge of topk_list.cuh
FUSED_ARGS = [_P] * 12 + [_I, _I, _L, _I, _I, _I, _P]
F_PASS1 = "fused_scan_pass1"
# text patches of the earlier fused_scan.cu
F_OFFER = "        offer(L, v, dist_s[warp][rr], cp, cr, lane, wd, wp, wr);"
F_NO_OFFER = "        sink += dist_s[warp][rr] + (float)(cp ^ cr);"
F_XLOAD = ("          x_s[rr * (kDk + 1) + kk] = x[(row0 + rr) * d + k0 + "
           "kk];")
F_NO_XLOAD = "          x_s[rr * (kDk + 1) + kk] = (float)(rr - kk);"
F_MERGE = ("  return (int)launch_merge_chunks(part_d, part_p, part_r, out_d, "
           "out_p,\n                                  out_r, nq, n_chunks, "
           "s);")
F_NO_MERGE = "  return 0;"
F_VARIANTS = {
    "as is": ([], []),
    "no offers": ([(F_OFFER, F_NO_OFFER)] + SINK, []),
    "no merge": ([(F_MERGE, F_NO_MERGE)], []),
    "no x loads": ([(F_XLOAD, F_NO_XLOAD)], []),
    "no offers, no x loads": ([(F_OFFER, F_NO_OFFER), (F_XLOAD, F_NO_XLOAD)]
                              + SINK, []),
    "inserts counted": VARIANTS["inserts counted"],
}
# the breakdown's shapes: (queries, rows, d, admitted rows a query or None
# for every row)
FUSED_SHAPES = {"t6": (8, 2_097_152, 128, None),
                "shard": (8, 262_144, 128, None),
                "rerank": (8, 2_097_152, 128, 40)}


def parent_chunking(n_qtiles: int, nkeep: int, sms: int):
    """(kept blocks per chunk, chunks) of the earlier fused scan's pass 1
    (c4ac6b8's fused_scan.chunking: 4 blocks an SM over the query tiles)."""
    want = max(1, -(-sms * 4 // n_qtiles))
    per = max(1, -(-nkeep // min(want, nkeep)))
    return per, -(-nkeep // per)


def fused_shape_inputs(seed: int, nq: int, rows: int, d: int, per_query):
    """Wrapper inputs on the card: normal q and x, a pk permutation, and a
    mask admitting every row, or ``per_query`` random rows a query with
    the kept blocks and occupancy grid that ``ops`` would build."""
    import torch
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((nq, d), generator=g, device=dev)
    x = torch.randn((rows, d), generator=g, device=dev)
    pks = torch.randperm(rows, generator=g, device=dev).to(torch.int32)
    if per_query is None:
        mask = torch.ones((nq, rows), dtype=torch.uint8, device=dev)
    else:
        mask = torch.zeros((nq, rows), dtype=torch.uint8, device=dev)
        idx = torch.randint(0, rows, (nq, per_query), generator=g, device=dev)
        mask.scatter_(1, idx, 1)
    blk = mask.view(nq, -1, 512).any(dim=2)
    keep = torch.nonzero(blk.any(dim=0)).flatten().to(torch.int32)
    occ = blk[:, keep.long()].view(nq // 8, 8, -1).any(dim=1).to(torch.int32)
    return q, x, mask, pks, keep.contiguous(), occ.contiguous()


def fused_path_shapes(log_path: Path):
    """The fused scan inputs a ``chip_smoke.py`` log lists ("fused_scan
    path shape (nq, n, d, kept blocks, admitted pairs)") as (nq, rows, d,
    admitted rows a query)."""
    pat = re.compile(r"fused_scan path shape \((\d+), (\d+), (\d+), (\d+), "
                     r"(\d+)\)")
    out = set()
    for nq, n, d, nkeep, pairs in pat.findall(log_path.read_text()):
        nq, n, d, nkeep, pairs = map(int, (nq, n, d, nkeep, pairs))
        out.add((nq, n, d, None if pairs >= nq * n
                 else max(1, pairs // nq)))
    return sorted(out, key=str)


class ParentFused:
    """The earlier fused scan (one built variant), called on wrapper
    inputs with its own chunking."""

    def __init__(self, lib):
        self.fn = lib.fused_scan_topk_launch
        self.fn.argtypes = FUSED_ARGS
        self.fn.restype = _I

    def caller(self, args):
        import torch
        from repro_torch.kernels import build as kb
        q, x, mask, pks, keep, occ = args
        nq, d = q.shape
        nkeep = keep.shape[0]
        dev = q.device
        per, n = parent_chunking(nq // 8, nkeep, kb.sm_count(dev))
        out = tuple(torch.empty((nq, 128), dtype=t, device=dev)
                    for t in (torch.float32, torch.int32, torch.int32))
        part = tuple(torch.empty((nq, n, 128), dtype=t, device=dev)
                     for t in (torch.float32, torch.int32, torch.int32))
        stream = torch.cuda.current_stream(dev).cuda_stream

        def call():
            err = self.fn(*(t.data_ptr() for t in args),
                          *(t.data_ptr() for t in part + out), nq, d,
                          mask.shape[1], nkeep, per, n, stream)
            if err:
                raise cs.SmokeFailure(f"earlier fused scan launch: {err}")
            return out
        return call


def hold_fused(new, old, what: str) -> None:
    """This tree's fused scan answer against the earlier kernel's:
    d2, pks and rows bitwise."""
    for x, y, name in zip(new, old, ("d2", "pks", "rows")):
        cs.check(cs.same_bits(x, y), f"fused_scan_topk {what}: {name} differ "
                 f"from the earlier kernel's")


def fused_breakdown(parent: Path, seed: int, work: Path, extra=(),
                    variants=True) -> dict:
    """The breakdown of the earlier fused scan (every variant, or with
    ``variants`` false the earlier kernel as it is only), and this tree's
    kernel held against it bitwise and timed beside it."""
    import numpy as np
    import torch
    from repro_torch.kernels import fused_scan
    chosen = F_VARIANTS if variants else {"as is": F_VARIANTS["as is"]}
    procs = {v: build(parent, "fused_scan", cu, h, work / f"fused_{i}")
             for i, (v, (cu, h)) in enumerate(chosen.items())}
    libs = {v: load(lib, proc, f"fused variant {v}")
            for v, (lib, proc) in procs.items()}
    parents = {v: ParentFused(lib) for v, lib in libs.items()}
    res = {}
    for sname, (nq, rows, d, per_q) in FUSED_SHAPES.items():
        args = fused_shape_inputs(seed, nq, rows, d, per_q)
        nkeep = args[4].shape[0]
        pairs = int(args[2].bool().sum())
        base = parents["as is"].caller(args)()
        torch.cuda.synchronize()
        base = tuple(t.clone() for t in base)
        row = {}
        for v, p in parents.items():
            call = p.caller(args)
            out = call()
            torch.cuda.synchronize()
            if v in ("as is", "inserts counted"):
                hold_fused(out, base, f"variant {v} at {sname}")
            reps = 10 if rows >= 2_000_000 else 20
            names = (F_PASS1,) if v == "no merge" else (F_PASS1, MERGE)
            t = {k: cs.kernel_ms(call, k, reps, 2) for k in names}
            row[v] = t
            log(f"fused {sname} ({nq} x {rows} rows, d {d}, {nkeep} kept "
                f"blocks, {pairs} admitted pairs) {v}: "
                + ", ".join(f"{k} {ms:.4f} ms" for k, ms in t.items())
                + " device time")
            if v == "inserts counted":
                lib = libs[v]
                lib.breakdown_inserts.argtypes = [_I]
                lib.breakdown_inserts.restype = ctypes.c_ulonglong
                lib.breakdown_inserts(1)
                call()
                torch.cuda.synchronize()
                n = lib.breakdown_inserts(1)
                log(f"fused {sname} inserts: {n} list inserts (pass 1 and "
                    f"merge) for {pairs} candidates "
                    f"({100 * n / max(1, pairs):.2f} %)")
                row["inserts"] = n
        # this tree's kernel on the same inputs, paired with the earlier:
        # earlier, this tree, this tree, earlier
        new = fused_scan.fused_scan_topk(*args)
        torch.cuda.synchronize()
        hold_fused(new, base, f"this tree at {sname}")
        old_call = parents["as is"].caller(args)

        def new_call():
            return fused_scan.fused_scan_topk(*args)
        old_ms = [cs.kernel_ms(old_call, None)]
        parts = cs.kernel_parts(new_call)
        new_ms = [sum(parts.values()), cs.kernel_ms(new_call, None)]
        old_ms.append(cs.kernel_ms(old_call, None))
        e_new, e_old = cs.cuda_ms(new_call), cs.cuda_ms(old_call)
        row["this tree"] = {"ms": new_ms, "parts": parts, "events": e_new}
        row["earlier"] = {"ms": old_ms, "events": e_old}
        log(f"fused {sname} this tree: d2, pks and rows bitwise equal to the "
            f"earlier kernel's; device time earlier {old_ms[0]:.4f} / "
            f"{old_ms[1]:.4f} ms, this tree {new_ms[0]:.4f} / "
            f"{new_ms[1]:.4f} ms ("
            + ", ".join(f"{k} {v:.4f}" for k, v in parts.items())
            + f"); CUDA events earlier {e_old:.4f}, this tree {e_new:.4f} ms")
        res[sname] = row
        del args, base, new
        torch.cuda.empty_cache()
    # bitwise at the smoke's edge cases and at the paths' shapes
    rng = np.random.default_rng(seed)
    dev = torch.device("cuda")
    for nq, n, d, kind, dup in cs.FUSED_EDGE:
        args = cs.fused_inputs(rng, nq, n, d, dev, kind, dup)
        hold_fused(fused_scan.fused_scan_topk(*args),
                   parents["as is"].caller(args)(),
                   f"edge nq={nq} n={n} d={d} {kind} dup={dup}")
        log(f"fused edge nq={nq} n={n} d={d} {kind} dup={dup}: bitwise equal "
            f"to the earlier kernel")
    for nq, rows, d, per_q in extra:
        args = fused_shape_inputs(seed, nq, -(-rows // 512) * 512, d, per_q)
        hold_fused(fused_scan.fused_scan_topk(*args),
                   parents["as is"].caller(args)(),
                   f"path shape {(nq, rows, d, per_q)}")
        log(f"fused path shape nq={nq} rows={rows} d={d} admitted a query "
            f"{per_q or 'all'}: bitwise equal to the earlier kernel")
    res["held"] = {"edge": len(cs.FUSED_EDGE), "path shapes": len(extra)}
    return res


# text patches of this tree's fused_scan.cu: the scan without its FMAs
# (each staged tile still read, one add a row) or without its copies of x,
# each without candidates (what the unfilled ring holds, or distances
# without their products, pass no filter)
N_FMA = ("    accumulate(my_ring + sl * kStage, qb + m.kt * kDk, qs,\n"
         "               min(kDk, d - m.kt * kDk), r, dot, xn);")
N_NO_FMA = ("    xn[0] += my_ring[sl * kStage + r * kXs]\n"
            "             + my_ring[sl * kStage + (r + 16) * kXs];")
N_COPY = ("      copy_tile<kVec>(my_ring + sl * kStage, x, cur.row0, d, ft, "
          "lane);")
N_NO_COPY = "      (void)0;"
N_PASS = ("          const bool pass = ((ok >> (2 * i + h)) & 1u) && d2 <= "
          "thr[i];")
N_NO_PASS = ("          const bool pass = ((ok >> (2 * i + h)) & 1u) && d2 == "
             "1234.5f;")
N_VARIANTS = {"scan as is": [],
              "scan without FMAs": [(N_FMA, N_NO_FMA), (N_PASS, N_NO_PASS)],
              "scan without copies of x": [(N_COPY, N_NO_COPY),
                                           (N_PASS, N_NO_PASS)]}


def launch_new(lib, args, chunks: int):
    """This tree's fused scan launcher (of ``lib``) on wrapper inputs at a
    chosen chunk count; returns a caller."""
    import torch
    from repro_torch.kernels import fused_scan
    q, x, mask, pks, keep, occ = args
    nq, d = q.shape
    dev = q.device
    scratch = fused_scan.launch_scratch(nq, chunks, dev)
    out = fused_scan.launch_out(nq, dev)
    fn = lib.fused_scan_topk_launch
    stream = torch.cuda.current_stream(dev).cuda_stream

    def call():
        err = fn(*(t.data_ptr() for t in args),
                 *(t.data_ptr() for t in scratch + out), nq, d,
                 mask.shape[1], keep.shape[0], chunks,
                 fused_scan.smem_bytes(d), stream)
        if err:
            raise cs.SmokeFailure(f"fused scan launch at {chunks} chunks: "
                                  f"{err}")
        return out
    return call


def fused_tune(seed: int, work: Path) -> dict:
    """This tree's fused scan at t6's and a shard's shape: the scan launch
    without its FMAs and without its copies (what holds it), and the whole
    call at other chunk counts than the wrapper's (one and two waves of
    the two blocks an SM holds, 512), each bitwise against the wrapper's
    answer."""
    import torch
    from repro_torch.kernels import build as kb
    from repro_torch.kernels import fused_scan
    here = kb.CSRC
    procs = {v: build(here, "fused_scan", cu, [], work / f"new_{i}")
             for i, (v, cu) in enumerate(N_VARIANTS.items())}
    libs = {}
    for v, (lib, proc) in procs.items():
        load(lib, proc, v)
        libs[v] = kb._bind("fused_scan", lib)
    for ln in kb.BUILD_LOG.get("fused_scan", "").splitlines():
        if "registers" in ln or "spill" in ln or "Compiling" in ln:
            log(f"  fused_scan: {ln.strip()}")
    res = {}
    sms = kb.sm_count(torch.device("cuda"))
    for sname in ("t6", "shard"):
        nq, rows, d, per_q = FUSED_SHAPES[sname]
        args = fused_shape_inputs(seed, nq, rows, d, per_q)
        want = fused_scan.fused_scan_topk(*args)
        torch.cuda.synchronize()
        want = tuple(t.clone() for t in want)
        base = fused_scan.chunking(1, args[4].shape[0], sms)
        row = {}
        for v, lib in libs.items():
            call = launch_new(lib, args, base)
            ms = cs.kernel_ms(call, "fscan_scan")
            row[v] = ms
            log(f"fused {sname} {v}: fscan_scan {ms:.4f} ms device time")
        for ch in sorted({base // 2, base, min(512, 2 * base), 512}):
            call = launch_new(libs["scan as is"], args, ch)
            hold_fused(call(), want, f"{sname} at {ch} chunks")
            ms = cs.kernel_ms(call, None)
            scan = cs.kernel_ms(call, "fscan_scan")
            row[f"{ch} chunks"] = (ms, scan)
            log(f"fused {sname} at {ch} chunks: {ms:.4f} ms device time "
                f"(fscan_scan {scan:.4f}), bitwise equal to the wrapper's "
                f"answer")
        res[sname] = row
        del args
        torch.cuda.empty_cache()
    return res


def quantized_hold(parent: Path, seed: int, work: Path) -> dict:
    """This tree's quantized scan against the one of ``parent`` (c4ac6b8's,
    whose threshold and select this tree shares with the fused scan), both
    through this tree's wrapper: bitwise at g6's shape and at the smoke's
    quantized edge cases, timed paired at g6 (earlier, this tree, this
    tree, earlier)."""
    import numpy as np
    import torch
    from repro_torch.kernels import build as kb
    from repro_torch.kernels import ops, quantized_scan
    path, proc = build(parent, "quantized_scan", [], [], work / "qscan_c4")
    load(path, proc, "c4ac6b8's quantized_scan")
    theirs = kb._bind("quantized_scan", path)
    mine = kb.build_all(["quantized_scan"])["quantized_scan"]

    def run(lib, args):
        kb._libs["quantized_scan"] = lib
        return quantized_scan.quantized_scan_topk(*args)

    def both(args, what):
        new = run(mine, args)
        old = run(theirs, args)
        torch.cuda.synchronize()
        for x, y, name in zip(new, old, ("adc", "pks", "rows")):
            cs.check(cs.same_bits(x, y), f"quantized_scan_topk {what}: {name} "
                     f"differ from c4ac6b8's")
    try:
        rng = np.random.default_rng(seed)
        dev = torch.device("cuda")
        for nq, n, m, kind in cs.ADC_EDGE:
            q, codes, books, mask, pks = cs.adc_case(rng, nq, n, m, kind)
            a, _ = ops.quantized_kernel_args(ops.adc_lut(q, books), codes,
                                             mask, pks, dev)
            both(a, f"edge nq={nq} n={n} m={m} {kind}")
        args = g6_inputs(seed)
        both(args, "at g6")
        ms = {}
        for who, lib in (("earlier", theirs), ("this tree", mine),
                         ("this tree, again", mine),
                         ("earlier, again", theirs)):
            ms[who] = cs.kernel_ms(lambda: run(lib, args), None)
    finally:
        kb._libs["quantized_scan"] = mine
    log(f"qscan against c4ac6b8: adc, pks and rows bitwise equal at g6 and "
        f"at {len(cs.ADC_EDGE)} edge cases; device time at g6 "
        + ", ".join(f"{k} {v:.4f}" for k, v in ms.items()) + " ms")
    return ms


def path_shapes(log_path: Path):
    """The (nq, n, d) ivf_scan shapes a chip_smoke.py log lists as path
    shapes ("ivf_scan path shape (nq, d, n, d): N launches")."""
    pat = re.compile(r"ivf_scan path shape \((\d+), (\d+), (\d+), \d+\)")
    return sorted({(int(a), int(c), int(b))
                   for a, b, c in pat.findall(log_path.read_text())})


def ivf_compare(parent: Path, seed: int, work: Path, extra=()) -> dict:
    import numpy as np
    import torch
    from repro_torch.kernels import ivf_scan
    lib = load(*build(parent, "ivf_scan", [], [], work / "ivf_parent"),
               "the earlier ivf_scan")
    lib.ivf_scan_launch.argtypes = IVF_ARGS
    lib.ivf_scan_launch.restype = _I
    dev = torch.device("cuda")
    rng = np.random.default_rng(seed)
    res = {}
    shapes = list(IVF_SHAPES) + [s for s in extra if s not in IVF_SHAPES]
    log(f"ivf_scan: {len(shapes)} shapes, {len(extra)} of them from the "
        f"smoke log")
    for nq, n, d in shapes:
        q = rng.normal(size=(nq, d)).astype(np.float32)
        x = rng.normal(size=(n, d)).astype(np.float32)
        x[n - n // 3:] = 1e30             # host padding rows, as ops pads
        qt, xt = torch.from_numpy(q).to(dev), torch.from_numpy(x).to(dev)
        old = torch.empty((nq, n), dtype=torch.float32, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream

        def call_old():
            err = lib.ivf_scan_launch(qt.data_ptr(), xt.data_ptr(),
                                      old.data_ptr(), nq, n, d, stream)
            if err:
                raise cs.SmokeFailure(f"earlier ivf_scan launch failed: {err}")
            return old
        call_old()
        new = ivf_scan.ivf_scan(qt, xt)
        torch.cuda.synchronize()
        bad = int((new.view(torch.int32) != old.view(torch.int32)).sum())
        path = ivf_scan.launch_path(nq, n, d)
        cs.check(bad == 0, f"ivf_scan ({nq}x{d})x({n}x{d}), {path} path: "
                 f"{bad} elements differ from the earlier kernel's")
        if (nq, n, d) not in IVF_SHAPES:   # held bitwise, not timed
            res[f"{nq}x{n}x{d}"] = None
            log(f"ivf_scan ({nq}x{d})x({n}x{d}), {path} path: bitwise equal "
                f"to the earlier kernel")
            continue
        t_old = cs.kernel_ms(call_old, None)
        t_new = cs.kernel_ms(lambda: ivf_scan.ivf_scan(qt, xt), None)
        res[f"{nq}x{n}x{d}"] = (t_old, t_new)
        log(f"ivf_scan ({nq}x{d})x({n}x{d}), {path} path: bitwise equal to "
            f"the earlier kernel; device time earlier {t_old:.4f} ms, this "
            f"tree {t_new:.4f} ms")
    return res


# ---------------------------------------------------------------------------
# graph: 75ad3ab's beam search broken down, this tree's held to it
# ---------------------------------------------------------------------------

# the earlier tree's launcher (75ad3ab's build.py; that kernel, which
# reads visited words the caller has zeroed)
GRAPH_ARGS = [_P] * 10 + [_I, _I, _L, _I, _I, _I, _I, _I, _L, _P]
GRAPH_KERNEL = "graph_search_kernel"

# text patches of 75ad3ab's graph_search.cu: the scoring's global row loads
# replaced by a value of the row id; no sort of the fresh rows; no merges
# (the beams keep the seed, so the walk ends after one hop: a lower bound);
# the expansion cut to the beam's entries not expanded before (exact: its
# answer must equal the kernel's; rows up to 8,192, beams up to 128); and
# clock64 stamps of each part of a round, summed over the blocks
G_LOAD = "        const float diff = __fsub_rn(xr[j], L.q[j]);"
G_NO_LOAD = "        const float diff = __fsub_rn((float)(c & 7), L.q[j]);"
G_SORT = "  block_sort(L, n2);\n"
G_MERGES = ("  merge_beam(L, L.bd, L.bp, L.bi, beam, nc, false);\n"
            "  merge_beam(L, L.rd, L.rp, L.ri, beam, nc, true);\n")
G_DECL = "  __shared__ int nc_s;\n"
G_NEW_DECL = G_DECL + ("  __shared__ unsigned exp_s[256];\n"
                       "  __shared__ int new_s[128];\n"
                       "  for (int i = threadIdx.x; i < 256; i += kThreads) "
                       "exp_s[i] = 0u;\n")
G_HOP = ("    if (threadIdx.x == 0) nc_s = 0;\n"
         "    __syncthreads();\n"
         "    for (int t = threadIdx.x; t < beam * r_deg; t += kThreads) {\n"
         "      const int f = L.bi[t / r_deg];\n"
         "      if (f == kSentinel) continue;                 // dead "
         "frontier lane\n")
G_NEW_HOP = ("    if (threadIdx.x == 0) nc_s = 0;\n"
             "    for (int i = threadIdx.x; i < beam; i += kThreads) {\n"
             "      const int f = L.bi[i];\n"
             "      new_s[i] = 0;\n"
             "      if (f == kSentinel) continue;\n"
             "      const unsigned b = 1u << (f & 31);\n"
             "      new_s[i] = !(atomicOr(&exp_s[f >> 5], b) & b);\n"
             "    }\n"
             "    __syncthreads();\n"
             "    for (int t = threadIdx.x; t < beam * r_deg; "
             "t += kThreads) {\n"
             "      const int f = L.bi[t / r_deg];\n"
             "      if (f == kSentinel || !new_s[t / r_deg]) continue;\n")
STAMP = ("  {{ const long long t1 = clock64();\n"
         "    if (threadIdx.x == 0) atomicAdd(&g_phase[{k}], "
         "(unsigned long long)(t1 - t0));\n"
         "    t0 = t1; }}\n")
G_PHASES = [
    ("namespace {\n", "__device__ unsigned long long g_phase[8];\n\n"
     "namespace {\n", 1),
    ("  int n2 = 1;\n  while (n2 < nc) n2 <<= 1;\n",
     "  long long t0 = clock64();\n  int n2 = 1;\n"
     "  while (n2 < nc) n2 <<= 1;\n"),
    ("  __syncthreads();\n  block_sort(L, n2);\n"
     "  block_scan(L.cf, nc, warp_s);\n" + G_MERGES + "}\n",
     "  __syncthreads();\n" + STAMP.format(k=1) + "  block_sort(L, n2);\n"
     + STAMP.format(k=2) + "  block_scan(L.cf, nc, warp_s);\n"
     + STAMP.format(k=3) + G_MERGES + STAMP.format(k=4)
     + "  if (threadIdx.x == 0) {\n"
       "    atomicAdd(&g_phase[6], (unsigned long long)nc);\n"
       "    atomicAdd(&g_phase[7], 1ull);\n  }\n}\n"),
    ("  extern __shared__ float smem[];\n",
     "  const long long tk = clock64();\n  extern __shared__ float smem[];\n"),
    ("  for (int h = 0; h < hops; ++h) {\n",
     "  for (int h = 0; h < hops; ++h) {\n"
     "    const long long te = clock64();\n"),
    ("    __syncthreads();\n    const int nc = nc_s;\n",
     "    __syncthreads();\n    const int nc = nc_s;\n"
     "    if (threadIdx.x == 0)\n"
     "      atomicAdd(&g_phase[0], (unsigned long long)(clock64() - te));\n"),
    ("  for (int i = threadIdx.x; i < beam; i += kThreads) {\n"
     "    out_d[qrow * beam + i] = L.rd[i];\n",
     "  if (threadIdx.x == 0)\n"
     "    atomicAdd(&g_phase[5], (unsigned long long)(clock64() - tk));\n"
     "  for (int i = threadIdx.x; i < beam; i += kThreads) {\n"
     "    out_d[qrow * beam + i] = L.rd[i];\n"),
]
PHASE_READER = ("extern \"C\" int breakdown_phases(unsigned long long* out, "
                "int reset) {\n"
                "  cudaMemcpyFromSymbol(out, g_phase, 8 * sizeof(*out));\n"
                "  if (reset) {\n"
                "    const unsigned long long z[8] = {0};\n"
                "    cudaMemcpyToSymbol(g_phase, z, sizeof(z));\n  }\n"
                "  return (int)cudaGetLastError();\n}\n")
PHASES = ("expansion", "scoring", "sort", "scan", "merges")
G_VARIANTS = {
    "as is": [],
    "no row loads": [(G_LOAD, G_NO_LOAD)],
    "no sort": [(G_SORT, "")],
    "no merges": [(G_MERGES, "")],
    "new entries only": [(G_DECL, G_NEW_DECL), (G_HOP, G_NEW_HOP)],
    "phases timed": G_PHASES,
}
# variants whose answer must be the kernel's, bit for bit
G_EXACT = ("as is", "new entries only", "phases timed")

# text patches of this tree's graph_search.cu: clock64 stamps of each
# round's parts (slots 0-3), and its survivors, fresh rows, rounds and
# rounds of more than 32 survivors (slots 4-7), summed over the blocks
N_LOOP = ("  for (int h = 0; h <= hops && beam > 0; ++h) {   // beam 0: seeds "
          "only\n")
N_SCORE = ("    score_round(S, C, cur, x, pks, mask_q, d, beam, nc, tr, h == 0,"
           " vec);\n")
N_ROUND = N_SCORE + "    merge_round(S, C, cur, beam, C.ns);\n"
N_SORT = "    sort_survivors(S.rec, gm, gp, n2);\n"
N_PHASES = [
    ("namespace {\n", "__device__ unsigned long long g_phase[8];\n\n"
     "namespace {\n", 1),
    (N_LOOP, N_LOOP + "    long long t0 = clock64();\n"),
    (N_ROUND, STAMP.format(k=0)
     + N_SCORE + STAMP.format(k=1) + "    const int ns_seen = C.ns;\n"
     + "    merge_round(S, C, cur, beam, C.ns);\n"
     + STAMP.format(k=2)
     + "    if (threadIdx.x == 0) {\n"
       "      atomicAdd(&g_phase[4], (unsigned long long)ns_seen);\n"
       "      atomicAdd(&g_phase[5], (unsigned long long)nc);\n"
       "      atomicAdd(&g_phase[6], 1ull);\n"
       "      atomicAdd(&g_phase[7], (unsigned long long)(ns_seen > 32));"
       "\n    }\n"),
    (N_SORT, "    const long long ts = clock64();\n" + N_SORT
     + "    if (threadIdx.x == 0)\n"
       "      atomicAdd(&g_phase[3], "
       "(unsigned long long)(clock64() - ts));\n"),
]
N_PARTS = ("expansion", "gather and score", "sort and merge",
           "of which the sort")


def build_graph(src_dir: Path, subs, out_dir: Path, reader: bool):
    """Write one variant of ``src_dir``'s graph_search.cu (with the
    headers beside it) into ``out_dir`` and start nvcc on it."""
    from repro_torch.kernels import build as kb
    out_dir.mkdir(parents=True, exist_ok=True)
    cu = patch((src_dir / "graph_search.cu").read_text(), subs)
    if reader:
        cu += "\n" + PHASE_READER
    (out_dir / "graph_search.cu").write_text(cu)
    for h in src_dir.glob("*.cuh"):
        (out_dir / h.name).write_text(h.read_text())
    lib = out_dir / "graph_search.so"
    cmd = [kb.nvcc_path(), *kb.NVCC_FLAGS, "-o", str(lib),
           str(out_dir / "graph_search.cu")]
    return lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True)


class ParentGraph:
    """75ad3ab's beam search (one built variant), called on wrapper
    inputs as its wrapper called it: the visited words zeroed by a fill,
    then the kernel."""

    def __init__(self, lib):
        self.lib = lib
        self.fn = lib.graph_search_topk_launch
        self.fn.argtypes = GRAPH_ARGS
        self.fn.restype = _I

    def caller(self, a):
        import torch
        q, x, nbr, ent, mask, pks, beam, hops = a
        nq, d = q.shape
        n, r_deg = nbr.shape
        n_ent = ent.shape[1]
        cap = 1
        while cap < max(beam * r_deg, n_ent, 1):
            cap *= 2
        smem = 4 * (d + 9 * beam + 5 * cap + 1)
        dev = q.device
        out = tuple(torch.empty((nq, beam), dtype=t, device=dev)
                    for t in (torch.float32, torch.int32, torch.int32))
        vis = torch.empty((nq, n // 32), dtype=torch.int32, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream

        def call():
            vis.zero_()
            err = self.fn(*(t.data_ptr() for t in (q, x, nbr, ent, mask, pks)
                            + out + (vis,)), nq, d, n, r_deg, n_ent, beam,
                          hops, cap, smem, stream)
            if err:
                raise cs.SmokeFailure(f"earlier beam search launch: {err}")
            return out + (vis,)
        return call



def phase_clocks(lib, reset: bool):
    """The eight stamped counters of a variant built with PHASE_READER
    (zeroed after the read with ``reset``)."""
    buf = (ctypes.c_ulonglong * 8)()
    lib.breakdown_phases.argtypes = [ctypes.c_void_p, _I]
    lib.breakdown_phases.restype = _I
    err = lib.breakdown_phases(ctypes.addressof(buf), int(reset))
    if err:
        raise cs.SmokeFailure(f"reading the phase clocks: {err}")
    return list(buf)


def graph_path_inputs():
    """The beam search's inputs on the smoke's graph path: its GRAPH store
    (``chip_smoke.graph_path``: TRACY at d 128, 8,192 rows in 8 segments,
    fanout 32), one batch of 8 g6 queries at recall_target 0.95 as the
    planner plans it, and the same batch at the widened beam (128, 12
    hops).  Returns {"g6": args, "wide": args}, each (q, x, neighbours,
    entries, mask, pks, beam, hops) on the card."""
    import torch
    from repro_torch.core.executor import Executor
    from repro_torch.kernels import graph_search
    dev = torch.device("cuda")
    data = cs.TracyData(128, seed=3)
    store, ingest_s = cs.tracy_store(dev, data, cs.GRAPH_ROWS, "GRAPH",
                                     flush_rows=cs.GRAPH_FLUSH, fanout=32,
                                     quantize=False)
    log(f"graph store: {cs.GRAPH_ROWS} rows, ingest {ingest_s:.2f} s")
    ex = Executor(store)
    gt = cs.quantized_templates(cs.templates(data), cs.GRAPH_RECALL)
    made = [gt["g6"]()[0] for _ in range(8)]
    seen = []
    orig = graph_search.graph_search_topk

    def rec(*a):
        seen.append(a)
        return orig(*a)
    graph_search.graph_search_topk = rec
    try:
        ex.execute_many(made)
        plans = [ex.plan(m) for m in made]
        for p in plans:
            p.graph_beam, p.graph_hops = 128, 12
        ex.execute_many(made, plans)
    finally:
        graph_search.graph_search_topk = orig
    cs.check(len(seen) == 2, f"{len(seen)} beam searches for two batches")
    return {"g6": seen[0], "wide": seen[1]}


def graph_log_shapes(log_path: Path):
    """The (nq, d, n, R, entries, beam, hops) beam-search inputs a
    ``chip_smoke.py`` log lists ("graph_search path shape ...")."""
    pat = re.compile(r"graph_search path shape \(nq, d, n, R, entries, "
                     r"beam, hops\) \(([\d, ]+)\)")
    return sorted({tuple(int(v) for v in m.split(","))
                   for m in pat.findall(log_path.read_text())})


def hold_graph(new, old, what: str) -> None:
    """A beam-search answer against the earlier kernel's: d2, pks, rows
    and visited words bitwise."""
    for x, y, name in zip(new, old, ("d2", "pks", "rows", "visited words")):
        cs.check(cs.same_bits(x, y), f"graph_search_topk {what}: {name} "
                 f"differ from the earlier kernel's")


def tree_launch(fn, a, shared: bool):
    """A call of this tree's beam search through ``fn`` (its launcher, or
    a variant's) on wrapper inputs ``a``, laid out as the wrapper lays it
    out but with the visited words in shared memory or not as ``shared``
    says.  The call returns the four outputs."""
    import torch
    from repro_torch.kernels import build as kb
    from repro_torch.kernels import graph_search as gs
    q, x, nbr, ent, mask, pks, beam, hops = a
    nq, d = q.shape
    n, r_deg = nbr.shape
    n_ent = ent.shape[1]
    cap = gs.capacity(beam, r_deg, n_ent)
    rows = gs.tile_rows(d, beam, cap, kb.smem_per_block(q.device))
    smem = gs.smem_bytes(d, beam, cap, n // 32 if shared else 0, rows)
    out = tuple(torch.empty((nq, beam), dtype=t, device=q.device)
                for t in (torch.float32, torch.int32, torch.int32))
    vis = torch.empty((nq, n // 32), dtype=torch.int32, device=q.device)
    fn.argtypes = kb.SIGNATURES["graph_search"]["graph_search_topk_launch"]
    fn.restype = _I
    stream = torch.cuda.current_stream(q.device).cuda_stream

    def call():
        err = fn(*(t.data_ptr() for t in (q, x, nbr, ent, mask, pks) + out
                   + (vis,)), nq, d, n, r_deg, n_ent, beam, hops, cap, rows,
                 int(shared), smem, stream)
        if err:
            raise cs.SmokeFailure(f"this tree's beam search launch: {err}")
        return out + (vis,)
    return call


def tree_phases(lib, a, base, sname: str, call_ms: float) -> dict:
    """This tree's kernel with its rounds' parts stamped (``N_PHASES``),
    launched once as the wrapper launches it on inputs ``a``, held to
    ``base`` bitwise: each part's share of the stamped cycles and that
    share of ``call_ms``, and what the rounds held."""
    import torch
    from repro_torch.kernels import build as kb
    from repro_torch.kernels import graph_search as gs
    q, x, nbr, ent, mask, pks, beam, hops = a
    nq, d = q.shape
    n, r_deg = nbr.shape
    shared = gs.visited_path(n, d, beam, r_deg, ent.shape[1],
                             kb.smem_per_block(q.device)) == "shared"
    call = tree_launch(lib.graph_search_topk_launch, a, shared)
    phase_clocks(lib, True)
    out = call()
    torch.cuda.synchronize()
    hold_graph(out, base, f"this tree, stamped, at {sname}")
    ph = phase_clocks(lib, True)
    total = sum(ph[:3])
    parts = {k: ph[i] / total for i, k in enumerate(N_PARTS)}
    rounds = ph[6] / nq
    row = {"shares": parts, "rounds a query": rounds,
           "fresh a round": ph[5] / max(1, ph[6]),
           "survivors a round": ph[4] / max(1, ph[6]),
           "rounds of over 32 survivors a query": ph[7] / nq}
    log(f"graph {sname} this tree, stamped (bitwise equal): "
        + ", ".join(f"{k} {100 * v:.1f} % (~{v * call_ms * 1e3:.1f} us)"
                    for k, v in parts.items())
        + f"; {rounds:.2f} rounds a query, {row['fresh a round']:.1f} "
        f"fresh rows and {row['survivors a round']:.1f} survivors a round, "
        f"{row['rounds of over 32 survivors a query']:.2f} rounds a query "
        f"of more than 32 survivors")
    return row


def visited_pairing(a, base, sname: str) -> dict:
    """This tree's kernel with the visited words in shared memory (the
    wrapper's path at ``a``) and forced into global memory, both held to
    ``base`` bitwise, timed paired: shared, global, global, shared."""
    import torch
    from repro_torch.kernels import build as kb
    fn = kb.launcher("graph_search")
    sh, gl = tree_launch(fn, a, True), tree_launch(fn, a, False)
    for call, path in ((sh, "shared"), (gl, "global")):
        out = call()
        torch.cuda.synchronize()
        hold_graph(out, base, f"this tree, visited words in {path} memory, "
                              f"at {sname}")
    ms = {"shared": [cs.kernel_ms(sh, None)], "global": []}
    ms["global"] += [cs.kernel_ms(gl, None), cs.kernel_ms(gl, None)]
    ms["shared"].append(cs.kernel_ms(sh, None))
    gap = sum(ms["global"]) / sum(ms["shared"]) - 1
    log(f"graph {sname} this tree, visited words in shared / global memory "
        f"(bitwise equal): {ms['shared'][0]:.4f} / {ms['global'][0]:.4f} / "
        f"{ms['global'][1]:.4f} / {ms['shared'][1]:.4f} ms device time; "
        f"global {100 * gap:+.2f} %")
    return {"ms": ms, "global over shared": gap}


def graph_breakdown(parent: Path, seed: int, work: Path, extra=(),
                    variants=True) -> dict:
    """75ad3ab's beam search broken down at the graph path's g6 and
    widened-beam inputs (every variant, or with ``variants`` false as it
    is only), and this tree's kernel held to it bitwise in all four
    outputs there, at ``chip_smoke.GRAPH_EDGE`` and at every graph-path
    shape of a smoke log (random CSR inputs), and timed beside it."""
    import numpy as np
    import torch
    from repro_torch.kernels import graph_search
    chosen = G_VARIANTS if variants else {"as is": G_VARIANTS["as is"]}
    procs = {v: build_graph(parent, subs, work / f"graph_{i}",
                            v == "phases timed")
             for i, (v, subs) in enumerate(chosen.items())}
    from repro_torch.kernels import build as kb
    tree_lib = load(*build_graph(kb.CSRC, N_PHASES, work / "graph_tree",
                                 True), "this tree's beam search, stamped")
    parents = {v: ParentGraph(load(lib, proc, f"graph variant {v}"))
               for v, (lib, proc) in procs.items()}
    res = {}
    for sname, a in graph_path_inputs().items():
        q, x, nbr, ent, mask, pks, beam, hops = a
        shape = (f"{q.shape[0]} queries x {x.shape[0]} rows, d "
                 f"{x.shape[1]}, R {nbr.shape[1]}, {ent.shape[1]} entries, "
                 f"beam {beam}, {hops} hops")
        base = tuple(t.clone() for t in parents["as is"].caller(a)())
        torch.cuda.synchronize()
        gathered = int(cs.popcounts(base[3]).sum())
        row = {"shape": shape, "gathered": gathered}
        for v, p in parents.items():
            call = p.caller(a)
            if v == "phases timed":
                phase_clocks(p.lib, True)
            out = call()
            torch.cuda.synchronize()
            if v in G_EXACT:
                hold_graph(out, base, f"variant {v} at {sname}")
            if v == "phases timed":
                ph = phase_clocks(p.lib, True)
                total = ph[5]
                row["phases"] = {k: ph[i] / total
                                 for i, k in enumerate(PHASES)}
                row["fresh a round"] = ph[6] / max(1, ph[7])
                log(f"graph {sname} phases (share of the kernel's clock "
                    f"cycles, summed over {q.shape[0]} blocks): "
                    + ", ".join(f"{k} {100 * s:.1f} %"
                                for k, s in row["phases"].items())
                    + f"; {ph[6] / q.shape[0]:.1f} fresh rows a query in "
                    f"{ph[7] / q.shape[0]:.1f} scored rounds")
            k_ms = cs.kernel_ms(call, GRAPH_KERNEL)
            row[v] = k_ms
            log(f"graph {sname} ({shape}) {v}: {GRAPH_KERNEL} {k_ms:.4f} ms "
                f"device time")
        # this tree's wrapper on the same inputs, paired with the earlier
        # kernel and its fill: earlier, this tree, this tree, earlier
        new = graph_search.graph_search_topk(*a)
        torch.cuda.synchronize()
        hold_graph(new, base, f"this tree at {sname}")
        old_call = parents["as is"].caller(a)

        def new_call():
            return graph_search.graph_search_topk(*a)
        old_ms = [cs.kernel_ms(old_call, None)]
        new_ms = [cs.kernel_ms(new_call, None), cs.kernel_ms(new_call, None)]
        old_ms.append(cs.kernel_ms(old_call, None))
        e_new, e_old = cs.cuda_ms(new_call), cs.cuda_ms(old_call)
        row["this tree"] = {"ms": new_ms, "events": e_new}
        row["earlier"] = {"ms": old_ms, "events": e_old}
        log(f"graph {sname} this tree: d2, pks, rows and visited words "
            f"bitwise equal to the earlier kernel's ({gathered} rows "
            f"gathered); device time of every launch of a call: earlier "
            f"{old_ms[0]:.4f} / {old_ms[1]:.4f} ms (fill and kernel), this "
            f"tree {new_ms[0]:.4f} / {new_ms[1]:.4f} ms; CUDA events earlier "
            f"{e_old:.4f}, this tree {e_new:.4f} ms")
        row["this tree, stamped"] = tree_phases(tree_lib, a, base, sname,
                                                new_ms[0])
        if graph_search.visited_path(x.shape[0], x.shape[1], beam,
                                     nbr.shape[1], ent.shape[1],
                                     kb.smem_per_block(q.device)) \
                == "shared":
            row["visited words"] = visited_pairing(a, base, sname)
        res[sname] = row
    rng = np.random.default_rng(seed)
    dev = torch.device("cuda")
    cases = [(c, "edge") for c in cs.GRAPH_EDGE] + [
        ((nq, n, d, r_deg, beam, hops, n_ent, "floats"), "path shape")
        for nq, d, n, r_deg, n_ent, beam, hops in extra]
    for (nq, n, d, r_deg, beam, hops, n_ent, kind), what in cases:
        a = [torch.from_numpy(t).to(dev) for t in cs.graph_case(
            rng, nq, n, d, r_deg, min(n_ent, n), kind)] + [beam, hops]
        hold_graph(graph_search.graph_search_topk(*a),
                   parents["as is"].caller(a)(),
                   f"{what} nq={nq} n={n} d={d} R={r_deg} beam={beam} "
                   f"hops={hops} {kind}")
        log(f"graph {what} nq={nq} n={n} d={d} R={r_deg} beam={beam} "
            f"hops={hops} entries={n_ent} {kind}: bitwise equal to the "
            f"earlier kernel")
        del a
        torch.cuda.empty_cache()
    res["held"] = {"edge": len(cs.GRAPH_EDGE), "path shapes": len(extra)}
    return res


SECTIONS = ("qscan", "ivf", "fused", "qhold", "tune", "graph")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, default=None,
                    help="csrc/ directory of a42a644 (sections qscan, ivf)")
    ap.add_argument("--fused-parent", type=Path, default=None,
                    help="csrc/ directory of c4ac6b8 (sections fused, "
                         "qhold)")
    ap.add_argument("--graph-parent", type=Path, default=None,
                    help="csrc/ directory of 75ad3ab (section graph)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--only", default=",".join(SECTIONS),
                    help="comma-separated sections of " + ", ".join(SECTIONS))
    ap.add_argument("--no-variants", action="store_true",
                    help="sections fused and graph: time the earlier "
                         "kernel as it is only, not its variants")
    ap.add_argument("--shapes-from", type=Path, default=None,
                    help="a chip_smoke.py log: hold ivf_scan, the fused "
                         "scan and the beam search to the earlier kernels "
                         "at every path shape it lists too")
    args = ap.parse_args()
    only = set(args.only.split(","))
    if not only <= set(SECTIONS):
        ap.error(f"--only takes sections of {SECTIONS}")
    if only & {"qscan", "ivf"} and args.parent is None:
        ap.error("sections qscan and ivf need --parent")
    if only & {"fused", "qhold"} and args.fused_parent is None:
        ap.error("sections fused and qhold need --fused-parent")
    if "graph" in only and args.graph_parent is None:
        ap.error("section graph needs --graph-parent")
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    if not torch.cuda.is_available():
        print("kernel_breakdown.py: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import build as kb
    work = kb.BUILD_DIR / "breakdown"
    shutil.rmtree(work, ignore_errors=True)
    card = cs.card_line()
    log(card)
    kb.build_all()
    out = {"card": card}
    log_path = args.shapes_from
    try:
        if "qscan" in only:
            out["qscan"] = qscan_breakdown(args.parent, args.seed, work)
        if "ivf" in only:
            extra = path_shapes(log_path) if log_path else ()
            out["ivf"] = ivf_compare(args.parent, args.seed, work, extra)
        if "fused" in only:
            extra = fused_path_shapes(log_path) if log_path else ()
            out["fused"] = fused_breakdown(args.fused_parent, args.seed,
                                           work, extra, not args.no_variants)
        if "qhold" in only:
            out["qhold"] = quantized_hold(args.fused_parent, args.seed, work)
        if "tune" in only:
            out["tune"] = fused_tune(args.seed, work)
        if "graph" in only:
            extra = graph_log_shapes(log_path) if log_path else ()
            out["graph"] = graph_breakdown(args.graph_parent, args.seed,
                                           work, extra, not args.no_variants)
    except cs.SmokeFailure as e:
        print(f"kernel_breakdown.py: FAILED: {e}", file=sys.stderr)
        return 1
    log(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
