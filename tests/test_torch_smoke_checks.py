"""The answer checks of ``chip_smoke.py`` on the CPU: an answer ranked by
fp32 distances passes them, and a wrong answer fails them.

The smoke holds every NN answer on the card against a float64 brute force
at the fp32 rounding bound of the distance expansion (``round_bound``).
These tests show that the bound admits every answer that fp32 rounding
can give, and that it still catches a dropped neighbour at the density
and coordinate size of TRACY's spatial template t10 (2-d points in
[0, 100]^2, 19 % admitted by the text filter, 2,097,152 rows: about 40
admitted points per unit^2), where |q|^2 + |x|^2 is about 1e4 and the
10th nearest neighbour sits at d2 of about 0.08.
"""
from __future__ import annotations

import importlib.util
import types
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]


def _smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


cs = _smoke()
K = 10
DENSITY = 0.19 * 2_097_152 / 100.0 ** 2      # admitted points per unit^2


def _t10_case(rng):
    """Admitted points around a t10 query at t10's density: a 4 x 4
    window around q holds every point that can reach the top 10."""
    q = rng.uniform(10, 90, 2).astype(np.float32)
    n = rng.poisson(16 * DENSITY)
    x = (q + rng.uniform(-2, 2, (n, 2))).astype(np.float32)
    return q, x


def _fp32_d2(q, x):
    """d2 by the expansion in fp32, the kernels' formula."""
    qn = np.float32((q * q).sum(dtype=np.float32))
    xn = (x * x).sum(axis=1, dtype=np.float32)
    return (qn - np.float32(2) * (x @ q).astype(np.float32)) + xn


def _check(q, x, sel, f32):
    """Run the smoke's tie-aware check on the answer ``sel`` (rows of x,
    ranked) whose scores come from ``f32``, as the executor reports
    them (sqrt in fp32, squared back)."""
    x64, q64 = torch.from_numpy(x.astype(np.float64)), torch.from_numpy(
        q.astype(np.float64))
    pks = torch.arange(len(x))
    td, tp, _ = cs.exact_topk(q64, x64, None, pks, K)
    f = np.sqrt(np.maximum(f32[sel], 0)).astype(np.float64) ** 2
    rows = np.concatenate([sel, tp])
    ex = ((x64[rows] - q64) ** 2).sum(dim=1).numpy()
    m = float((q64 ** 2).sum()) + float((x64[rows] ** 2).sum(dim=1).max())
    tol = cs.round_bound(2, m, float(ex.max()))
    cs.tie_aware(f, sel, ex[:len(sel)], td, tp, tol)
    return tol / td[-1]


def _ranked(f32):
    return np.lexsort((np.arange(len(f32)), f32))


def test_t10_fp32_answers_pass_and_tolerance_is_small():
    rng = np.random.default_rng(0)
    power = []
    for _ in range(200):
        q, x = _t10_case(rng)
        f32 = _fp32_d2(q, x)
        power.append(_check(q, x, _ranked(f32)[:K], f32))
    # the bound is a few percent of the k-th d2, not of its order
    assert np.median(power) < 0.1


@pytest.mark.parametrize("drop", range(K - 2))
def test_t10_dropped_neighbour_is_caught(drop):
    """An answer that lost its rank-``drop`` neighbour (a skipped row or
    block) and took the 11th in its place fails the check."""
    rng = np.random.default_rng(1)
    caught = 0
    for _ in range(100):
        q, x = _t10_case(rng)
        f32 = _fp32_d2(q, x)
        sel = np.delete(_ranked(f32)[:K + 1], drop)
        try:
            _check(q, x, sel, f32)
        except cs.SmokeFailure:
            caught += 1
    assert caught >= 95, f"{caught} of 100 caught"


def test_embedding_answers_pass_and_misorder_is_caught():
    """d = 128, TRACY's topic-clustered embeddings: an fp32-ranked answer
    passes; swapping two neighbours of distinct d2 fails."""
    rng = np.random.default_rng(2)
    centre = rng.normal(size=128).astype(np.float32)
    x = (centre + 0.4 * rng.normal(size=(4000, 128))).astype(np.float32)
    q = (centre + 0.2 * rng.normal(size=128)).astype(np.float32)
    f32 = _fp32_d2(q, x)
    sel = _ranked(f32)[:K]
    assert _check(q, x, sel, f32) < 1e-3
    bad = sel.copy()
    bad[[2, 6]] = bad[[6, 2]]
    with pytest.raises(cs.SmokeFailure):
        _check(q, x, bad, f32)


def test_fused_compare_catches_a_wrong_kernel_answer():
    """The kernel-vs-plain comparison on the CPU (where the wrapper takes
    the plain version): equal answers pass; a kernel answer that skipped
    one admitted row fails."""
    from repro_torch.kernels import fused_scan
    rng = np.random.default_rng(3)
    args = cs.fused_inputs(rng, 8, 1100, 2, torch.device("cpu"), "sparse")
    plain, _ = cs.fused_plain(args)
    err, swaps, _ = cs.fused_compare(args, fused_scan.fused_scan_topk(*args),
                                     plain)
    assert err == 0.0 and swaps == 0
    d, p, i = (t.clone() for t in plain)
    qi = int(torch.isfinite(d).sum(dim=1).argmax())
    d[qi, :-1], p[qi, :-1], i[qi, :-1] = (d[qi, 1:].clone(), p[qi, 1:].clone(),
                                          i[qi, 1:].clone())
    with pytest.raises(cs.SmokeFailure):
        cs.fused_compare(args, (d, p, i), plain)


def _edge_case(kind, n=3000, d=32, nq=8):
    """One of the smoke's fused edge inputs on the CPU: the wrapper's
    arguments and the caller's rows (x, mask) behind them."""
    rng = np.random.default_rng(5)
    args = cs.fused_inputs(rng, nq, n, d, torch.device("cpu"), kind)
    return args, args[1][:n], args[2][:, :n].bool()


@pytest.mark.parametrize("kind", ["rerank", "few", "nan", "inf",
                                  "unsampled", "dup4"])
def test_fused_edge_inputs_hold_what_they_are_named_for(kind):
    """Each mask kind the redesigned scan's edge cases add builds what its
    name says: 40 rows a query; a query under 128 admitted rows and one
    with none; NaN rows every query admits; rows whose fp32 d2 overflows
    to +inf, every query admitting them; no row the witnesses sample
    (offsets 0-7 of a 32-row group); 4 distinct rows in all."""
    from repro_torch.kernels import ref
    args, x, mask = _edge_case(kind, n=65_536 if kind == "unsampled"
                               else 3000)
    per_q = mask.sum(dim=1)
    if kind == "rerank":
        assert (per_q == 40).all()
    elif kind == "few":
        assert per_q[1] == 50 and per_q[2] == 0 and (per_q[3:] > 128).all()
    elif kind == "nan":
        nan_rows = torch.isnan(x).any(dim=1).nonzero().flatten().tolist()
        assert nan_rows == [7, 1500] and mask[:, nan_rows].all()
        assert per_q[0] == 20
    elif kind == "inf":
        d2 = ref.ivf_scan_ref(args[0], x)
        over = torch.isposinf(d2).all(dim=0).nonzero().flatten().tolist()
        assert over == [3, 11] and mask[:, over].all()
        assert torch.isfinite(d2[:, 12:]).all() and per_q[0] == 60
    elif kind == "unsampled":
        rows = mask.any(dim=0).nonzero().flatten()
        assert ((rows % 32) >= 8).all() and (per_q > 10_000).all()
    else:
        assert len(torch.unique(x, dim=0)) <= 4


def test_fused_edge_list_reaches_the_new_design():
    """The smoke's fused edge cases take d = MAX_DIM (one scan block an
    SM), a d that is no multiple of 4 (4-byte copies), a re-rank mask
    over at least 262,144 rows, and each of the kinds above."""
    from repro_torch.kernels import fused_scan
    cases = cs.FUSED_EDGE
    assert any(c[2] == fused_scan.MAX_DIM for c in cases)
    assert any(c[2] % 4 for c in cases)
    assert any(c[3] == "rerank" and c[1] >= 262_144 for c in cases)
    assert {"few", "nan", "inf", "unsampled", "dup4", "sparse",
            "holes"} <= {c[3] for c in cases}
    # the unsampled case leaves every query without a witness (tau +inf)
    # and more admitted rows in each chunk than a region holds, on a card
    # of 132 SMs: every region overflows and is rescanned
    nq, n, d, kind, _ = next(c for c in cases if c[3] == "unsampled")
    mask = cs.fused_mask(np.random.default_rng(0), nq, n, kind)
    nkeep = n // fused_scan.BLOCK_N
    chunks = fused_scan.chunking(1, nkeep, 132)
    rows = np.arange(n)
    assert not mask[:, rows % 32 < fused_scan.SAMPLE_ROWS].any()
    for c in range(chunks):
        lo, hi = fused_scan.chunk_groups(c, chunks, nkeep)
        admitted = mask[:, lo * 32:hi * 32].sum(axis=1)
        assert (admitted > fused_scan.KMAX).all()


def test_fused_compare_holds_nan_and_inf_rows():
    """A NaN row never enters an answer and rows whose d2 overflowed
    follow the finite ones in pk order: the plain version's answers pass,
    an answer with the overflowed rows swapped or a NaN row in it
    fails."""
    from repro_torch.kernels import fused_scan
    args, x, mask = _edge_case("inf")
    plain, _ = cs.fused_plain(args)
    out = fused_scan.fused_scan_topk(*args)
    cs.fused_compare(args, out, plain)
    d, p, i = (t.clone() for t in out)
    assert torch.isfinite(d[0, :58]).all() and torch.isposinf(d[0, 58:]).all()
    pk3, pk11 = int(args[3][3]), int(args[3][11])
    assert p[0, 58:60].tolist() == sorted([pk3, pk11])
    assert (p[0, 60:] == fused_scan.SENTINEL).all()
    p[0, 58], p[0, 59] = p[0, 59].clone(), p[0, 58].clone()
    i[0, 58], i[0, 59] = i[0, 59].clone(), i[0, 58].clone()
    with pytest.raises(cs.SmokeFailure, match="overflowed"):
        cs.fused_compare(args, (d, p, i), plain)
    args, x, mask = _edge_case("nan")
    plain, _ = cs.fused_plain(args)
    out = fused_scan.fused_scan_topk(*args)
    cs.fused_compare(args, out, plain)
    d, p, i = (t.clone() for t in out)
    assert torch.isfinite(d[0, :18]).all() and torch.isinf(d[0, 18:]).all()
    d[0, 18], p[0, 18], i[0, 18] = float("nan"), int(args[3][7]), 7
    with pytest.raises(cs.SmokeFailure):
        cs.fused_compare(args, (d, p, i), plain)


def test_ivf_compare_holds_elements_to_the_rounding_bound():
    rng = np.random.default_rng(4)
    q = torch.from_numpy(rng.uniform(0, 100, (5, 2)).astype(np.float32))
    x = torch.from_numpy(rng.uniform(0, 100, (300, 2)).astype(np.float32))
    from repro_torch.kernels import ref
    plain = ref.ivf_scan_ref(q, x)
    assert cs.ivf_compare(q, x, plain.clone(), plain) == 0.0
    off = plain.clone()
    off[1, 7] += 0.05               # well above fp32 rounding at |x|^2 ~ 1e4
    with pytest.raises(cs.SmokeFailure):
        cs.ivf_compare(q, x, off, plain)


def test_same_bits_tells_one_ulp_apart():
    a = torch.tensor([1.0, float("inf"), float("nan")])
    assert cs.same_bits(a, a.clone())
    b = a.clone()
    b[0] = torch.nextafter(b[0], torch.tensor(2.0))
    assert not cs.same_bits(a, b)
    assert not cs.same_bits(a, a.double())
    assert cs.same_bits(torch.arange(5, dtype=torch.int32),
                        torch.arange(5, dtype=torch.int32))


def test_survivors_maps_the_rerank_bitmap_to_pks():
    """The survivor mask the smoke checks a quantized answer against is
    the re-rank's bitmap over packed rows, carried to pk space."""
    rng = np.random.default_rng(3)
    n = 1024
    pks = torch.from_numpy(rng.permutation(n).astype(np.int32))
    mt = torch.zeros((8, n), dtype=torch.uint8)
    rows = rng.choice(n, 40, replace=False)
    mt[2, torch.from_numpy(rows)] = 1
    adm = cs.survivors(torch.device("cpu"), (None, None, mt, pks, None, None),
                       2, n)
    assert sorted(torch.nonzero(adm).flatten().tolist()) == \
        sorted(pks[torch.from_numpy(rows)].tolist())


def test_quantized_templates_pair_each_draw_with_its_exact_twin():
    data = cs.TracyData(8, seed=4)
    data.batch(0, 50)
    data.finish()
    gt = cs.quantized_templates(cs.templates(data))
    for name in ("g6", "g8", "g13"):
        quant, exact, mask_fn, spec = gt[name]()
        assert quant.recall_target == cs.RECALL_TARGET
        assert exact.recall_target is None and quant.k == exact.k
        assert quant.where is exact.where
        np.testing.assert_array_equal(quant.ranks[0].q, exact.ranks[0].q)
        np.testing.assert_array_equal(spec[1], exact.ranks[0].q)
        assert (mask_fn is None) == (name == "g6")


def test_graph_templates_take_their_recall_target():
    data = cs.TracyData(8, seed=5)
    data.batch(0, 50)
    data.finish()
    gt = cs.quantized_templates(cs.templates(data), cs.GRAPH_RECALL)
    for name in ("g6", "g8", "g13"):
        quant, exact, _, _ = gt[name]()
        assert quant.recall_target == cs.GRAPH_RECALL == 0.95
        assert exact.recall_target is None


def test_popcounts_count_each_querys_visited_rows():
    vis = torch.zeros((3, 4), dtype=torch.int32)
    vis[0, 0] = 0b1011
    vis[1, 3] = -2 ** 31                    # bit 31 of the last word
    vis[2] = -1                             # every row of 128
    assert cs.popcounts(vis).tolist() == [3, 1, 128]


def test_graph_compare_catches_one_flipped_bit():
    out = [torch.tensor([[1.0, float("inf")]]),
           torch.tensor([[3, 2 ** 31 - 1]], dtype=torch.int32),
           torch.tensor([[5, 2 ** 31 - 1]], dtype=torch.int32),
           torch.tensor([[6]], dtype=torch.int32)]
    cs.graph_compare(out, [t.clone() for t in out], "same")
    for i in range(4):
        bad = [t.clone() for t in out]
        flat = bad[i].view(-1)
        if bad[i].dtype == torch.float32:
            flat[0] = torch.nextafter(flat[0], torch.tensor(2.0))
        else:
            flat[0] ^= 1
        with pytest.raises(cs.SmokeFailure):
            cs.graph_compare(out, bad, "one bit")


def test_merge_and_graph_cases_have_ties_pads_and_padding():
    rng = np.random.default_rng(6)
    d, ids = cs.merge_case(rng, 4, 3, 50, "ties")
    assert len(np.unique(d)) < d.size // 10          # many equal scores
    assert len(np.unique(ids)) == ids.size
    d, ids = cs.merge_case(rng, 4, 3, 50, "pads")
    assert np.isinf(d).any() and (ids[np.isinf(d)] == 2 ** 31 - 1).all()
    q, x, nbr, ent, mask, pks = cs.graph_case(rng, 8, 512, 16, 8, 5, "ints")
    assert (x == np.round(x)).all() and (nbr == -1).any()
    assert not mask[0].any() and len(np.unique(pks)) < 512
    assert (ent[0, 5:] == 2 ** 31 - 1).all() and ent.shape == (1, 8)
    q, x, nbr, ent, mask, pks = cs.graph_case(rng, 8, 512, 16, 8, 5, "nan")
    assert np.isnan(x).any(axis=1).sum() > 0 and not np.isnan(q).any()
    assert len(np.unique(pks)) == 512 and not mask[0].any()


def test_graph_edge_cases_stop_early_meet_nan_rows_and_take_both_paths():
    """The beam search's edge inputs as ``graph_edge_checks`` draws them:
    the walk of ``GRAPH_STOPS`` adds no row in its last hop (its plain
    answer is the same at one hop fewer), the NaN case's walk gathers NaN
    rows and returns none, ``GRAPH_SMEM_ROWS`` is the most rows whose
    visited words the wrapper keeps in shared memory at its shape, and
    2,097,152 rows take the global-memory path.  Other cases stage with
    4-byte copies (d % 4 != 0), end on a partial feature tile, seed more
    than 2,048 entries and stage fewer than 256 rows a tile."""
    from repro_torch.kernels import build, graph_search, ref
    rng = np.random.default_rng(3)              # graph_edge_checks' draws
    limit = build.smem_per_block("cpu")
    held = set()
    for case in cs.GRAPH_EDGE:
        nq, n, d, r_deg, beam, hops, n_ent, kind = case
        if n > 8192:
            break                               # the large cases come last
        args = [torch.from_numpy(a) for a in cs.graph_case(
            rng, nq, n, d, r_deg, n_ent, kind)]
        if case == cs.GRAPH_STOPS:
            full = ref.graph_search_topk_ref(*args, beam, hops)
            fewer = ref.graph_search_topk_ref(*args, beam, hops - 1)
            assert all(cs.same_bits(a, b) for a, b in zip(full, fewer))
            held.add("stops")
        if kind == "nan":
            x = args[1].numpy()
            nan_rows = np.flatnonzero(np.isnan(x).any(axis=1))
            assert 0 < len(nan_rows) < n // 8
            out = ref.graph_search_topk_ref(*args, beam, hops)
            vis = np.unpackbits(out[3].numpy().view(np.uint8), axis=1,
                                bitorder="little").astype(bool)
            assert vis[:, nan_rows].any()
            assert not np.isin(out[2].numpy(), nan_rows).any()
            held.add("nan")
    assert held == {"stops", "nan"}
    sizes = {c[1]: c for c in cs.GRAPH_EDGE}
    nq, n, d, r_deg, beam, hops, n_ent, kind = sizes[cs.GRAPH_SMEM_ROWS]
    assert cs.GRAPH_SMEM_ROWS == graph_search.max_shared_rows(
        d, beam, r_deg, max(8, n_ent), limit)
    nq, n, d, r_deg, beam, hops, n_ent, kind = sizes[2_097_152]
    assert graph_search.visited_path(n, d, beam, r_deg, max(8, n_ent),
                                     limit) == "global"
    assert list(sizes)[-2:] == [cs.GRAPH_SMEM_ROWS, 2_097_152]
    dims = [c[2] for c in cs.GRAPH_EDGE]
    assert any(d % 4 for d in dims) and any(d > 64 and d % 64 for d in dims)
    assert any(c[6] > 2048 for c in cs.GRAPH_EDGE)
    rows = {graph_search.tile_rows(d, beam, graph_search.capacity(
        beam, r_deg, max(8, n_ent)), limit)
        for _, _, d, r_deg, beam, _, n_ent, _ in cs.GRAPH_EDGE}
    assert 256 in rows and min(rows) < 256


def test_row_bound_takes_the_larger_of_bytes_and_operations():
    bound, by = cs.row_bound(cs.HBM_BYTES_PER_S * 1e-3, 0.0)
    assert by == "bytes" and bound == pytest.approx(1.0)
    bound, by = cs.row_bound(1.0, cs.FP32_FLOPS * 2e-3)
    assert by == "operations" and bound == pytest.approx(2.0)


def test_add_counts_accumulates_the_launches_since_the_reset():
    from repro_torch.kernels import graph_search, topk_merge
    total = dict.fromkeys(cs.SOURCES, 0)
    cs.reset_counts()
    topk_merge.batched_launches.add()
    graph_search.launches.add()
    graph_search.launches.add()
    c = cs.add_counts(total)
    assert c["batched_topk_merge"] == 1 and c["graph_search_topk"] == 2
    cs.reset_counts()
    cs.add_counts(total)
    assert total["graph_search_topk"] == 2 and total["topk_merge"] == 0
    assert sorted(cs.kernel_counts()) == sorted(cs.SOURCES)


def test_device_busy_is_the_union_of_device_intervals():
    """Overlapping and nested device events count once; host events not
    at all."""
    from torch.autograd import DeviceType

    def ev(a, b, dev=DeviceType.CUDA):
        return types.SimpleNamespace(
            device_type=dev, time_range=types.SimpleNamespace(start=a, end=b))
    prof = types.SimpleNamespace(events=lambda: [
        ev(0, 10), ev(5, 12), ev(6, 7), ev(20, 25), ev(0, 100,
                                                       DeviceType.CPU)])
    assert cs.device_busy_us(prof) == 17
    assert cs.device_busy_us(types.SimpleNamespace(events=lambda: [])) == 0


def test_span_ms_sums_the_named_kernels_per_call():
    """A kernel's device time per call from its trace spans: one name
    counts its own spans, a tuple sums its names', None every kernel but
    copies and fills; a named kernel that did not launch once a call
    fails the run."""
    spans = [("void qscan_scan<8>(float const*)", 40.0),
             ("void qscan_scan<8>(float const*)", 60.0),
             ("qscan_select(float const*)", 10.0),
             ("qscan_select(float const*)", 30.0),
             ("Memcpy HtoD (Pageable -> Device)", 500.0)]
    assert cs.span_ms(spans, "qscan_scan", 2) == pytest.approx(0.05)
    assert cs.span_ms(spans, ("qscan_scan", "qscan_select"), 2) == \
        pytest.approx(0.07)
    assert cs.span_ms(spans, None, 2) == pytest.approx(0.07)
    with pytest.raises(cs.SmokeFailure, match="launches of qscan_witness"):
        cs.span_ms(spans, ("qscan_scan", "qscan_witness"), 2)
    with pytest.raises(cs.SmokeFailure, match="not 3"):
        cs.span_ms(spans, "qscan_select", 3)


def _kernels_of(*names):
    """The __global__ kernels defined in the named csrc sources."""
    import re
    found = set()
    for name in names:
        src = (ROOT / "src/repro_torch/kernels/csrc" / name).read_text()
        found |= set(re.findall(
            r"__global__ void(?: __launch_bounds__\([^)]*\))?\s+(\w+)\(",
            src))
    return found


def test_quantized_stage_names_are_the_kernels_of_the_source():
    """Each name the smoke times the quantized scan by is a kernel of
    csrc/quantized_scan.cu or of the threshold and select it shares
    (csrc/scan_select.cuh), so the device-time check sees all of a call's
    launches."""
    assert set(cs.QSCAN_KERNELS) == _kernels_of("quantized_scan.cu",
                                                "scan_select.cuh")


def test_fused_stage_names_are_the_kernels_of_the_source():
    """The fused row's launches, timed apart and summed from one trace,
    are the kernels of csrc/fused_scan.cu and of the threshold and select
    it shares, no more and no fewer."""
    assert set(cs.FUSED_KERNELS) == _kernels_of("fused_scan.cu",
                                                "scan_select.cuh")
    assert len(cs.FUSED_KERNELS) == 4


def test_span_parts_times_each_launch_and_wants_no_other():
    """One trace gives each named launch's time per call; a span of the
    trace that is none of them (a fill, a memset, a copy) fails the run,
    so their sum is what a call costs the card."""
    spans = [("void (anonymous namespace)::fscan_witness<true>()", 4.0),
             ("(anonymous namespace)::topk_threshold()", 1.0),
             ("void (anonymous namespace)::fscan_scan<4, true>()", 40.0),
             ("(anonymous namespace)::topk_select()", 5.0)] * 2
    parts = cs.span_parts(spans, cs.FUSED_KERNELS, 2)
    assert parts == pytest.approx({"fscan_witness": 0.004,
                                   "topk_threshold": 0.001,
                                   "fscan_scan": 0.04,
                                   "topk_select": 0.005})
    assert sum(parts.values()) == pytest.approx(0.05)
    with pytest.raises(cs.SmokeFailure, match="also runs"):
        cs.span_parts(spans + [("Memset (Device)", 2.0)],
                      cs.FUSED_KERNELS, 2)
    with pytest.raises(cs.SmokeFailure, match="launches of fscan_scan"):
        cs.span_parts(spans[:6] + spans[7:], cs.FUSED_KERNELS, 2)


def test_ivf_edge_shapes_reach_every_launch_path():
    """The smoke's ivf_scan edge shapes take every launch path, with the
    query counts on both sides of the skinny path's 8, ragged row counts,
    the feature widths of the paths and 1e30 pad rows."""
    from repro_torch.kernels import ivf_scan
    assert cs.ivf_paths(cs.IVF_EDGE) == {"skinny", "wide", "wide-64"}
    assert cs.ivf_paths([(8, 512, 128)]) == {"skinny"}
    assert cs.ivf_paths([(2048, 512, 128)]) == {"wide"}
    assert cs.ivf_paths([(9, 512, 128)]) == {"wide-64"}
    nqs = {s[0] for s in cs.IVF_EDGE}
    assert {1, 8, 9, 64, 2048} <= nqs
    assert {2, 16, 128} <= {s[2] for s in cs.IVF_EDGE}
    assert any(s[1] % ivf_scan.BLOCK_N for s in cs.IVF_EDGE)
    assert any(s[3] for s in cs.IVF_EDGE)


def test_recorder_holds_every_path_shape_against_the_plain_version(
        monkeypatch):
    """The smoke's recorder holds the first call of every ivf_scan,
    bitmap_filter and pq_adc shape against the plain version, also past
    the shapes whose inputs it keeps for timing, and fails on a wrong
    output."""
    from repro_torch.kernels import (bitmap_filter, fused_scan, graph_search,
                                     ivf_scan, pq_adc, quantized_scan,
                                     topk_merge)
    for mod, name in ((fused_scan, "fused_scan_topk"),
                      (quantized_scan, "quantized_scan_topk"),
                      (ivf_scan, "ivf_scan"), (pq_adc, "pq_adc"),
                      (bitmap_filter, "bitmap_filter"),
                      (topk_merge, "batched_topk_merge"),
                      (graph_search, "graph_search_topk")):
        monkeypatch.setattr(mod, name, getattr(mod, name))   # restored after
    record = {}
    cs.install_recorder(record)
    rng = np.random.default_rng(7)
    for nq in range(1, 91):
        for _ in range(2):
            q = torch.from_numpy(rng.normal(size=(nq, 3)).astype(np.float32))
            x = torch.from_numpy(rng.normal(size=(40, 3)).astype(np.float32))
            ivf_scan.ivf_scan(q, x)
    codes = torch.from_numpy(rng.integers(0, 256, (50, 4), dtype=np.uint8))
    lut = torch.from_numpy(rng.normal(size=(4, 256)).astype(np.float32))
    pq_adc.pq_adc(codes, lut)
    cols = torch.from_numpy(rng.uniform(0, 1, (60, 2)).astype(np.float32))
    bitmap_filter.bitmap_filter(cols, torch.tensor([[0.2, 0.8], [0.1, 0.5]]))
    assert len(record["ivf_calls"]) == 90
    assert set(record["ivf_err"]) == set(record["ivf_calls"])
    assert set(record["ivf_err"].values()) == {0.0}
    assert len(record["ivf"]) == 64             # inputs kept for timing
    assert len(record["pq_err"]) == len(record["bitmap_err"]) == 1

    def wrong(q, x, orig=ivf_scan.ivf_scan):
        out = orig(q, x)
        out[0, 0] += 1.0
        return out
    monkeypatch.setattr(ivf_scan, "ivf_scan", wrong)
    cs.install_recorder(record)
    with pytest.raises(cs.SmokeFailure):
        ivf_scan.ivf_scan(torch.ones((2, 3)), torch.zeros((5, 3)))


def test_nan_adc_rows_never_enter_the_answer():
    """The smoke's NaN case: the plain quantized version returns rows
    whose ADC is NaN after its empty slots; ``nan_as_empty`` takes them as
    empty, which is what the Pallas kernel returns for a query whose every
    row is NaN (its running list starts with KMAX empty slots, and NaN
    orders after them).  The other queries' 128 best rows are finite, so
    the map leaves them as they are."""
    import jax.numpy as jnp
    from repro.kernels import quantized_scan as r_qs
    from repro_torch.kernels import fused_scan, ops, quantized_scan, ref
    rng = np.random.default_rng(1)
    q, codes, books, mask, pks = cs.adc_case(rng, 8, 1000, 8, "nan")
    lut = ops.adc_lut(q, books)
    assert np.isnan(lut[0]).all() and np.isnan(lut[1:, 0, :64]).all()
    args, _ = ops.quantized_kernel_args(lut, codes, mask, pks,
                                        torch.device("cpu"))
    plain = quantized_scan.plain(*args[:5])
    d, p, r = cs.nan_as_empty(*plain)
    assert torch.isnan(plain[0][0]).sum() > 0 and not torch.isnan(d).any()
    assert torch.isinf(d[0]).all()
    assert (p[0] == ref.SENTINEL).all() and (r[0] == ref.SENTINEL).all()
    for got, want in zip((d, p, r), plain):
        assert cs.same_bits(got[1:], want[1:])
    ck, mk, pk = fused_scan.compact(*args[1:5])
    occ = np.ones((1, ck.shape[0] // fused_scan.BLOCK_N), np.int32)
    wd, wp, wi = (np.array(a) for a in r_qs.quantized_scan_topk(
        jnp.asarray(lut[:8].reshape(8, -1)),
        jnp.asarray(ck.numpy().astype(np.int32)), jnp.asarray(mk.numpy()),
        jnp.asarray(pk.numpy()), jnp.asarray(occ), interpret=True))
    assert cs.same_bits(d[0], torch.from_numpy(wd[0]))
    assert np.array_equal(p[0].numpy(), wp[0])
    assert np.array_equal(r[0].numpy(), wi[0])


def test_kernel_ms_traces_again_when_a_trace_misses_launches(monkeypatch):
    """A trace that misses kernel records is taken again, up to three
    times; a kernel short of one launch a call in all three fails."""
    import torch.profiler
    from torch.autograd import DeviceType
    held = iter([14, 20, 19, 19, 19])

    class Trace:
        def __enter__(self):
            n = next(held)
            span = types.SimpleNamespace(start=0, end=5)
            self.ev = [types.SimpleNamespace(name="qscan_scan<8>",
                                             time_range=span,
                                             device_type=DeviceType.CUDA)
                       for _ in range(n)]
            return self

        def __exit__(self, *a):
            return False

        def events(self):
            return self.ev
    monkeypatch.setattr(torch.profiler, "profile", lambda **kw: Trace())
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    assert cs.kernel_ms(lambda: None, "qscan_scan", reps=20) == 0.005
    with pytest.raises(cs.SmokeFailure, match="19 launches"):
        cs.kernel_ms(lambda: None, "qscan_scan", reps=20)


@pytest.mark.parametrize("n,kind", [(1000, "empty"), (1000, "partial"),
                                    (1000, "every"), (5000, "nan"),
                                    (4099, "repeat")])
def test_list_edge_cases_are_held_bitwise(n, kind):
    """The smoke's edge cases of bitmap_filter's list entry point (at the
    sizes of ``LIST_EDGE``, every block at 1,000 points here) reach what
    they name, and ``hold_list`` passes the plain version's mask and
    catches one flipped row."""
    from repro_torch.kernels import bitmap_filter
    assert (n, kind) in cs.LIST_EDGE or kind == "every"
    assert (2_097_152, "every") in cs.LIST_EDGE
    a = cs.list_case(np.random.default_rng(0), n, kind, "cpu")
    cols, rows, blocks, bounds, n_out, br = a
    nb = -(-n // br)
    listed = set(blocks.tolist())
    assert {"empty": listed == set(), "partial": nb - 1 in listed and n % br,
            "every": listed == set(range(nb)),
            "nan": bool(torch.isnan(cols).any()),
            "repeat": {-1, nb} <= listed and len(blocks) > len(listed)}[kind]
    assert sorted(rows.tolist()) == list(range(n))
    out = bitmap_filter.bitmap_filter_blocks(*a)
    assert cs.hold_list((n, kind), a, out) == 0.0
    assert kind == "empty" or out.any()       # the rectangle's corners pass
    if out.numel():
        out[0] ^= 1
        with pytest.raises(cs.SmokeFailure, match="1 mask rows differ"):
            cs.hold_list((n, kind), a, out)


def test_recorder_holds_every_list_call_and_keeps_t2(monkeypatch):
    """The recorder keeps the first call of every list shape with its
    output, ``hold_pending`` holds them against the plain version after
    the timed batches, the last call of each template is kept for timing,
    and a wrong mask fails at the hold."""
    from repro_torch.kernels import bitmap_filter
    monkeypatch.setattr(bitmap_filter, "bitmap_filter_blocks",
                        bitmap_filter.bitmap_filter_blocks)
    record = {"template": "t2"}
    cs.install_recorder(record)
    rng = np.random.default_rng(3)
    for n, kind in [(1000, "partial"), (1000, "partial"), (5000, "nan")]:
        bitmap_filter.bitmap_filter_blocks(*cs.list_case(rng, n, kind, "cpu"))
    assert sum(record["blocks_calls"].values()) == 3
    assert record["blocks_err"] == {}               # nothing held yet
    assert set(record["blocks_pending"]) == set(record["blocks_calls"])
    cs.hold_pending(record)
    assert set(record["blocks_err"]) == set(record["blocks_calls"])
    assert record["blocks_pending"] == {}
    assert list(record["blocks"]) == ["t2"]
    assert record["blocks"]["t2"][0].shape == (5000, 2)

    def wrong(*a, orig=bitmap_filter.bitmap_filter_blocks):
        out = orig(*a)
        out[0] ^= 1
        return out
    monkeypatch.setattr(bitmap_filter, "bitmap_filter_blocks", wrong)
    cs.install_recorder(record)
    bitmap_filter.bitmap_filter_blocks(*cs.list_case(rng, 300, "every",
                                                     "cpu"))
    with pytest.raises(cs.SmokeFailure, match="differ from the plain"):
        cs.hold_pending(record)


def test_held_list_output_is_the_one_the_call_returned(monkeypatch):
    """A caller that writes into the returned mask after the call (as a
    host path may, on a CPU tensor) does not change what is held."""
    from repro_torch.kernels import bitmap_filter
    monkeypatch.setattr(bitmap_filter, "bitmap_filter_blocks",
                        bitmap_filter.bitmap_filter_blocks)
    record = {"template": None}
    cs.install_recorder(record)
    a = cs.list_case(np.random.default_rng(4), 1000, "partial", "cpu")
    out = bitmap_filter.bitmap_filter_blocks(*a)
    out ^= 1
    cs.hold_pending(record)
    assert list(record["blocks_err"].values()) == [0.0]


def _fake_probe(launch_list: int, launch_block: int):
    """A stand-in for ``ZOrderIndex.bitmap`` that lists the blocks the
    predicate names and makes the given launches of each entry point."""
    from repro_torch.kernels import bitmap_filter

    def bitmap(self, segment, predicate):
        self.last_blocks_read = predicate
        for _ in range(launch_list):
            bitmap_filter.launches.add()
            bitmap_filter.blocks_launches.add()
        for _ in range(launch_block):
            bitmap_filter.launches.add()
        return np.zeros(4, bool)
    return bitmap


@pytest.mark.parametrize("launch_list,launch_block,blocks,ok", [
    (1, 0, 454, True), (0, 0, 0, True), (2, 0, 454, False),
    (0, 0, 454, False), (1, 1, 454, False), (1, 0, 0, False),
    (0, 3, 3, False)])
def test_probe_counter_wants_one_list_launch_per_listing_probe(
        monkeypatch, launch_list, launch_block, blocks, ok):
    """``install_probe_counter`` counts the ``ZOrderIndex.bitmap`` calls
    that list a block and fails on one that does not make exactly one list
    launch (none when it lists nothing) or makes a per-block launch."""
    from repro_torch.core.index import spatial
    monkeypatch.setattr(spatial.ZOrderIndex, "bitmap",
                        _fake_probe(launch_list, launch_block))
    record = {}
    cs.install_probe_counter(record)
    cs.reset_counts()
    idx = spatial.ZOrderIndex()
    if not ok:
        with pytest.raises(cs.SmokeFailure, match="ZOrderIndex.bitmap"):
            idx.bitmap(None, blocks)
        return
    for _ in range(3):
        idx.bitmap(None, blocks)
    assert record["probes"] == (3 if blocks else 0)
    if blocks:
        cs.check_list_launches("t2", cs.counts(), record["probes"])


@pytest.mark.parametrize("list_launches,per_block,probes,ok", [
    (8, 0, 8, True), (192, 0, 192, True), (16, 0, 8, False),
    (8, 0, 16, False), (8, 1, 8, False), (0, 0, 0, False)])
def test_t2_check_wants_exactly_one_list_launch_per_probe(
        list_launches, per_block, probes, ok):
    """t2's check holds the list launches of a template's batches equal to
    the Z-order probes that listed a block, with no per-block launch: a
    probe that launched twice, or once per chunk of blocks, fails it."""
    delta = {cs.ENTRY: list_launches,
             "bitmap_filter": list_launches + per_block}
    if ok:
        cs.check_list_launches("t2", delta, probes)
    else:
        with pytest.raises(cs.SmokeFailure, match="Z-order probes"):
            cs.check_list_launches("t2", delta, probes)


@pytest.mark.parametrize("names,ok", [
    (["void at::native::vectorized_elementwise_kernel<4, "
      "at::native::FillFunctor<signed char>>"], True),
    (["Memset (Device)"], True), ([], False),
    (["Memset (Device)", "void other_kernel()"], False),
    (["void other_kernel()"], False)])
def test_zero_kernel_names_the_fill_beside_the_kernel(monkeypatch, names,
                                                      ok):
    """``zero_kernel`` finds the one fill a wrapper call runs beside its
    kernel (copies aside), and fails on none, on two, or on another
    kernel."""
    spans = [("void bitmap_filter_blocks_kernel(float const*)", 2.0),
             ("Memcpy HtoD (Pageable -> Device)", 1.0)] + [
        (n, 1.5) for n in names]
    monkeypatch.setattr(cs, "trace_spans", lambda fn, reps: spans)
    if ok:
        assert cs.zero_kernel(None, "bitmap_filter_blocks_kernel") == \
            names[0]
    else:
        with pytest.raises(cs.SmokeFailure, match="not one fill"):
            cs.zero_kernel(None, "bitmap_filter_blocks_kernel")


def test_bitmap_row_reports_both_entry_points(monkeypatch):
    """``measure_bitmap`` on a recorded list call (timers stubbed: they
    need the card): the row names both entry points' launches; its ``ms``
    is the mask's zeroing and the kernel together, held against the bound
    of the listed points and the whole mask; the kernel alone is held
    against what it reads and the rows it sets; and the op's parts."""
    from repro_torch.kernels import bitmap_filter
    fill = ("void at::native::vectorized_elementwise_kernel<4, "
            "at::native::FillFunctor<signed char>>")
    timed = {}

    def kernel_ms(fn, kernel, **kw):
        timed[kernel] = fn() is not None
        return 0.5 if isinstance(kernel, tuple) else 0.3
    monkeypatch.setattr(cs, "cuda_ms", lambda fn, **kw: fn() is None)
    monkeypatch.setattr(cs, "kernel_ms", kernel_ms)
    monkeypatch.setattr(cs, "trace_spans", lambda fn, reps: [
        ("void bitmap_filter_blocks_kernel(float const*)", 4.0 * reps),
        (fill, 1.0 * reps),
        ("Memcpy DtoH (Device -> Pageable)", 100.0 * reps)])
    a = cs.list_case(np.random.default_rng(5), 1000, "partial", "cpu")
    record = {"blocks": {"t2": a},
              "blocks_calls": {(1000, 2, 5, 1000): 1},
              "blocks_err": {(1000, 2, 5, 1000): 0.0},
              "bitmap_calls": {}, "bitmap_err": {}}
    orig = {"blocks": bitmap_filter.bitmap_filter_blocks,
            "bitmap": bitmap_filter.bitmap_filter}
    launches = {"bitmap_filter": 11, cs.ENTRY: 8}
    name, k_ms, p_ms, bound, by, lib, extra = cs.measure_bitmap(
        record, orig, launches, {})
    assert (name, k_ms, lib, by) == ("bitmap_filter", 0.5, None, "bytes")
    listed = 4 * 128 + 1000 - 7 * 128           # blocks 0, 2, 4, 6 and 7
    nbytes = listed * 12 + 4 * 5 + 16 + 1000
    assert bound == pytest.approx(nbytes / cs.HBM_BYTES_PER_S * 1e3)
    assert extra["entry_launches"] == {"bitmap_filter": 3, cs.ENTRY: 8}
    assert timed == {(fill, "bitmap_filter_blocks_kernel"): True,
                     "bitmap_filter_blocks_kernel": True,
                     "bitmap_filter_kernel": True}
    hits = int(bitmap_filter.bitmap_filter_blocks(*a).sum())
    assert extra["kernel_only_ms"] == 0.3
    assert extra["kernel_only_bound_ms"] == pytest.approx(
        (nbytes - 1000 + hits) / cs.HBM_BYTES_PER_S * 1e3)
    assert extra["op_device_ms"]["kernel"] == pytest.approx(0.004)
    assert extra["op_device_ms"]["memset"] == pytest.approx(0.001)
    assert extra["op_device_ms"]["copy_out"] == pytest.approx(0.1)
    assert extra["per_block_ms"] == 0.3
    record["blocks_calls"][(1, 2, 1, 1)] = 1       # a shape never held
    with pytest.raises(cs.SmokeFailure, match="not held"):
        cs.measure_bitmap(record, orig, launches, {})


# ---------------------------------------------------------------------------
# the continuous phase's checks
# ---------------------------------------------------------------------------

def _rows(n=1500, dim=16, seed=6):
    """A ``LiveRows`` mirror of n TRACY rows on the CPU, and the data."""
    data = cs.TracyData(dim, seed=seed)
    data.batch(0, n)
    data.finish()
    return cs.LiveRows(torch.device("cpu"), data.cols, n + 64), data


def _answer(pks, scores=None):
    return [types.SimpleNamespace(pk=int(p), score=float(s))
            for p, s in zip(pks, scores if scores is not None
                            else np.zeros(len(pks)))]


def _nn(rows, qv, k=10, adm=None):
    """The exact top-k as the executor reports it: fp32 d2, sqrt."""
    x = rows.xs[len(qv)].numpy().astype(np.float32)
    d2 = ((x - qv) ** 2).sum(axis=1, dtype=np.float32)
    ok = rows.live.copy() if adm is None else adm.copy()
    d2 = np.where(ok, d2, np.inf)
    top = np.lexsort((np.arange(len(d2)), d2))[:k]
    return _answer(top, np.sqrt(d2[top]))


def test_continuous_nn_check_passes_the_exact_answer_only():
    rows, data = _rows()
    qv = data.query_vec()
    query = cs.continuous_mix(data)[0][1]
    query.ranks[0] = type(query.ranks[0])("embedding", qv, 1.0)
    right = _nn(rows, qv)
    assert cs.hold_subscription("cpu", rows, query, right, right)[1:] == \
        (True, 0)
    dropped = right[:3] + right[4:] + _nn(rows, qv, k=11)[10:]
    with pytest.raises(cs.SmokeFailure):
        cs.hold_subscription("cpu", rows, query, dropped, right)
    # after a delete the deleted row may not answer; after an update the
    # row's new vector counts
    rows.delete([right[0].pk])
    with pytest.raises(cs.SmokeFailure):
        cs.hold_subscription("cpu", rows, query, right, right)
    far = {"embedding": np.full((1, 16), 50, np.float32),
           "coordinate": np.zeros((1, 2), np.float32),
           "time": np.zeros(1)}
    rows.write([right[1].pk], far)
    fresh = _nn(rows, qv)
    assert right[1].pk not in {r.pk for r in fresh}
    cs.hold_subscription("cpu", rows, query, fresh, fresh)
    with pytest.raises(cs.SmokeFailure):
        cs.hold_subscription("cpu", rows, query, fresh, right)


def test_continuous_filter_check_wants_the_exact_pk_set():
    from repro_torch.core import query as q
    rows, data = _rows()
    query = q.HybridQuery(where=q.And(q.Range("time", 100, 600),
                                      q.GeoWithin("coordinate",
                                                  (10, 10, 60, 60))))
    want = np.nonzero(rows.mask(query.where))[0]
    t, p = rows.time, rows.pts
    assert len(want) == int(((t >= 100) & (t <= 600) & (p[:, 0] >= 10)
                             & (p[:, 0] <= 60) & (p[:, 1] >= 10)
                             & (p[:, 1] <= 60) & rows.live).sum()) > 0
    right = _answer(want)
    assert cs.hold_subscription("cpu", rows, query, right, right) == \
        (0, True, 0)
    for wrong in (right[1:], right + _answer([1_500])):
        with pytest.raises(cs.SmokeFailure, match="differs"):
            cs.hold_subscription("cpu", rows, query, wrong, right)
        with pytest.raises(cs.SmokeFailure, match="fresh execute"):
            cs.hold_subscription("cpu", rows, query, right, wrong)
    rows.delete([int(want[0])])
    with pytest.raises(cs.SmokeFailure):
        cs.hold_subscription("cpu", rows, query, right, right)


def test_continuous_views_are_held_to_the_references_rule():
    """A spatial view's answer: its pks whose held point lies in the rect,
    live and passing the residual; it may miss the fresh answer only at
    pks whose held point is stale.  A vector view's: the exact top-k over
    its candidates."""
    from repro_torch.core import query as q
    from repro_torch.core.views.rewrite import Rewrite
    from repro_torch.core.views.view import SpatialRangeView, VectorNNView
    rows, data = _rows()
    rect = (20.0, 20.0, 50.0, 50.0)
    pred = q.GeoWithin("coordinate", rect)
    query = q.HybridQuery(where=q.And(q.Range("time", 0, 700), pred))
    view = SpatialRangeView("coordinate", (10, 10, 60, 60))
    inside = rows.mask(q.GeoWithin("coordinate", view.rect))
    view.insert_many(np.nonzero(inside)[0], rows.pts[inside])
    rw = Rewrite(spatial_view=view, spatial_pred=pred)
    want = set(np.nonzero(rows.mask(query.where))[0].tolist())
    # a row updated out of the rect: stale in the view, kept by it
    moved = sorted(want)[0]
    rows.write([moved], {"embedding": np.zeros((1, 16), np.float32),
                         "coordinate": np.asarray([[90, 90]], np.float32),
                         "time": np.asarray([5.0])})
    fresh = _answer(sorted(want - {moved}))
    by_view = _answer(sorted(want))
    assert cs.hold_subscription("cpu", rows, query, by_view, fresh, rw) == \
        (0, False, 1)
    with pytest.raises(cs.SmokeFailure, match="its points name"):
        cs.hold_subscription("cpu", rows, query, fresh, fresh, rw)
    # a view that lacks a row whose current point is in the rect
    lost = sorted(want)[1]
    del view.rows[lost]
    short = [r for r in by_view if r.pk != lost]
    with pytest.raises(cs.SmokeFailure, match="current point"):
        cs.hold_subscription("cpu", rows, query, short, fresh, rw)
    # a vector view that lacks the query's true nearest row
    qv = data.query_vec()
    nn = q.HybridQuery(ranks=[q.VectorRank("embedding", qv, 1.0)], k=10)
    exact = _nn(rows, qv)
    vview = VectorNNView("embedding", qv, 80, 1.0)
    x = rows.xs[16].numpy().astype(np.float32)
    keep = rows.live.copy()
    keep[exact[0].pk] = False
    vview.insert_many(np.nonzero(keep)[0], x[keep])
    cand = [pk for _, pk in vview.topk_for(qv, 40)]
    adm = np.zeros_like(rows.live)
    adm[cand] = True
    served = _nn(rows, qv, adm=adm & rows.live)
    vrw = Rewrite(vector_view=vview, vector_rank=nn.ranks[0])
    assert cs.hold_subscription("cpu", rows, nn, served, exact, vrw)[1] \
        is False
    with pytest.raises(cs.SmokeFailure):
        cs.hold_subscription("cpu", rows, nn, exact, exact, vrw)
    with pytest.raises(cs.SmokeFailure):
        cs.hold_subscription("cpu", rows, nn, served, exact)


def test_continuous_schedule_check():
    cs.check_schedule(1.0, True, True)
    cs.check_schedule(1.0, True, False)
    cs.check_schedule(None, True, True)
    cs.check_schedule(None, False, False)
    with pytest.raises(cs.SmokeFailure, match="SYNC"):
        cs.check_schedule(1.0, False, True)
    with pytest.raises(cs.SmokeFailure, match="ran without"):
        cs.check_schedule(None, True, False)
    with pytest.raises(cs.SmokeFailure, match="did not run"):
        cs.check_schedule(None, False, True)


def test_continuous_mix_is_the_benchmarks():
    _, data = _rows(n=10)
    mix = cs.continuous_mix(data)
    assert [i for i, _ in mix] == [1.0] * 12 + [None, None]
    assert [bool(x.ranks) for _, x in mix[:12]] == [True, False] * 6
    assert all(x.k == 10 for _, x in mix[:12:2])
    rects = [x.where.rect for _, x in mix[1:12:2]]
    assert all(abs(r[2] - r[0] - 12) < 1e-9 for r in rects)
    assert mix[12][1].ranks and mix[12][1].where.col == "time"
    t2 = mix[13][1].where.children
    assert t2[0].col == "time" and abs(t2[1].rect[2] - t2[1].rect[0]
                                       - 15) < 1e-9


def test_write_round_keeps_the_mirror_equal_to_the_table(monkeypatch):
    """A round of writes through a port table on the CPU leaves the
    mirror's live rows and points equal to what the table answers."""
    from repro_torch.core import query as q
    from repro_torch.core.api import Database
    from repro_torch.core.lsm import LSMConfig
    from repro_torch.core.types import Column, ColumnType, IndexKind, Schema
    monkeypatch.setattr(cs, "CONT_PUT", 300)
    monkeypatch.setattr(cs, "CONT_UPDATE", 40)
    monkeypatch.setattr(cs, "CONT_DELETE", 20)
    data = cs.TracyData(16, seed=7)
    db = Database(Schema([
        Column("embedding", ColumnType.VECTOR, dim=16, index=IndexKind.IVF),
        Column("coordinate", ColumnType.SPATIAL, index=IndexKind.ZORDER),
        Column("content", ColumnType.TEXT, index=IndexKind.INVERTED),
        Column("time", ColumnType.SCALAR, index=IndexKind.BTREE),
        Column("likes", ColumnType.SCALAR, index=IndexKind.BTREE)]),
        LSMConfig(flush_rows=512), device="cpu")
    t = db.table()
    t.put(*data.batch(0, 1000))
    t.flush()
    data.finish()
    rows = cs.LiveRows(torch.device("cpu"), data.cols, 1000 + 2 * 300)
    rng = np.random.default_rng(0)
    for _ in range(2):
        cs.write_round(t, rows, data, rng)
    assert rows.n == 1600 and int(rows.live.sum()) == 1600 - 40
    where = q.GeoWithin("coordinate", (0, 0, 100, 100))
    got = {r.pk: r.values["coordinate"] for r in
           t.query().where(where).all()}
    assert set(got) == set(np.nonzero(rows.mask(where))[0].tolist())
    for pk, pt in got.items():
        np.testing.assert_array_equal(pt, rows.pts[pk])
        np.testing.assert_array_equal(
            t.get(pk)["embedding"], rows.xs[16][pk].numpy().astype(
                np.float32))


def test_continuous_cache_hit_check():
    cs.check_cache_hits("fcache", 12, 12, False)
    cs.check_cache_hits("fcache", 0, 12, True)
    cs.check_cache_hits("none", 0, 12, False)
    cs.check_cache_hits("views", 0, 12, True)
    with pytest.raises(cs.SmokeFailure, match="no write before it"):
        cs.check_cache_hits("fcache", 11, 12, False)
    with pytest.raises(cs.SmokeFailure, match="after a write"):
        cs.check_cache_hits("fcache", 3, 12, True)
    with pytest.raises(cs.SmokeFailure, match="none: 1 cache hits"):
        cs.check_cache_hits("none", 1, 12, False)


@pytest.mark.parametrize("mode", ["none", "fcache"])
def test_schedule_and_cache_checks_pass_a_port_engine(monkeypatch, mode):
    """The smoke's tick structure on a port table on the CPU: the first
    tick, one after a round of writes, one with no write before it.  The
    engine's own runs and cache hits pass ``check_schedule`` and
    ``check_cache_hits`` at every tick."""
    from repro_torch.core.api import Database
    from repro_torch.core.lsm import LSMConfig
    from repro_torch.core.types import Column, ColumnType, IndexKind, Schema
    monkeypatch.setattr(cs, "CONT_PUT", 200)
    monkeypatch.setattr(cs, "CONT_UPDATE", 30)
    monkeypatch.setattr(cs, "CONT_DELETE", 10)
    data = cs.TracyData(16, seed=8)
    db = Database(Schema([
        Column("embedding", ColumnType.VECTOR, dim=16, index=IndexKind.IVF),
        Column("coordinate", ColumnType.SPATIAL, index=IndexKind.ZORDER),
        Column("content", ColumnType.TEXT, index=IndexKind.INVERTED),
        Column("time", ColumnType.SCALAR, index=IndexKind.BTREE),
        Column("likes", ColumnType.SCALAR, index=IndexKind.BTREE)]),
        LSMConfig(flush_rows=512), continuous_mode=mode, device="cpu")
    t = db.table()
    t.put(*data.batch(0, 800))
    t.flush()
    data.finish()
    rows = cs.LiveRows(torch.device("cpu"), data.cols, 800 + 200)
    mix = cs.continuous_mix(data)
    subs = [(i, cs.builder(t, x).subscribe(interval_s=i) if i is not None
             else cs.builder(t, x).subscribe(on_change=True))
            for i, x in mix]
    rng = np.random.default_rng(0)
    for tick, wrote in enumerate((True, True, False)):
        if tick == 1:
            cs.write_round(t, rows, data, rng)
        cached = t.engine.metrics["cache_hits"]
        out = db.advance(float(tick))[t.name]
        cs.check_cache_hits(mode, t.engine.metrics["cache_hits"] - cached,
                            12, wrote)
        for interval, sub in subs:
            cs.check_schedule(interval, sub.rid in out, wrote)
