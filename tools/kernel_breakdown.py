#!/usr/bin/env python3
"""Break the earlier quantized scan down on the card, and hold this tree's
``quantized_scan`` and ``ivf_scan`` kernels against the earlier ones.

    python3 tools/kernel_breakdown.py --parent DIR [--shapes-from LOG]

``DIR`` is the ``src/repro_torch/kernels/csrc`` directory of the parent
commit (``a42a644``, whose quantized scan this tree replaced), unpacked
from ``git archive a42a644 src/repro_torch/kernels`` into a directory that
``.gitignore`` lists (``archive_check/``).  The patches below match that
commit's sources line for line, so the variants build from it alone.  The
script

1. builds that ``quantized_scan.cu`` as it is and in variants with one
   part taken out (the offers to the top-k lists, the LUT gathers, the
   mask reads, both the offers and the gathers) or with its list inserts
   counted, and times each variant's two launches (pass 1, the chunk
   merge) by device time at the shape of the quantized path's g6 batch (8
   queries x 2,097,152 rows, m = 8, every row admitted, 4,096 kept
   blocks), with the earlier chunking, one chunk and 2,048 chunks;
2. times this tree's kernel on the same inputs and holds its ADC values,
   pks and rows against the earlier kernel's, bitwise;
3. builds that ``ivf_scan.cu`` and holds this tree's kernel against it
   bitwise at ``IVF_SHAPES`` and at every path shape a ``chip_smoke.py``
   log lists (``--shapes-from``), timing both at ``IVF_SHAPES``.

The g6-shaped inputs are drawn from ``--seed`` on the card: uniform codes
and squared-normal LUT entries, so the ADC values are i.i.d. over rows (the
real g6 batch is timed by ``chip_smoke.py``).  Timers and the bitwise
comparison are ``chip_smoke.py``'s.  The variants are written to and built
in ``src/repro_torch/kernels/_build/breakdown/`` (ignored by git).  Needs
one CUDA card and ``nvcc``; exits non-zero without them.
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
    from repro_torch.kernels import fused_scan, quantized_scan
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

    per0, chunks0 = fused_scan.chunking(nq // 8, nkeep, dev)
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True, type=Path,
                    help="csrc/ directory of the earlier tree")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--only", choices=("qscan", "ivf"), default=None)
    ap.add_argument("--shapes-from", type=Path, default=None,
                    help="a chip_smoke.py log: hold ivf_scan to the earlier "
                         "kernel at every path shape it lists too")
    args = ap.parse_args()
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
    try:
        if args.only in (None, "qscan"):
            out["qscan"] = qscan_breakdown(args.parent, args.seed, work)
        if args.only in (None, "ivf"):
            extra = path_shapes(args.shapes_from) if args.shapes_from else ()
            out["ivf"] = ivf_compare(args.parent, args.seed, work, extra)
    except cs.SmokeFailure as e:
        print(f"kernel_breakdown.py: FAILED: {e}", file=sys.stderr)
        return 1
    log(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
