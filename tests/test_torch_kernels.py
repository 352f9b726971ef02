"""Kernel parity: the port's plain PyTorch versions and kernel wrappers
(``repro_torch.kernels``) against the JAX package's Pallas kernels in
interpret mode and its ``kernels/ref.py`` oracles, and the port's
``kernels/ops.py`` on the CPU against the JAX package's default backend.

Tolerances: squared distances agree within ``1e-5 * (||q||^2 + ||x||^2)``
(fp32 expansion, summed in another order); masks, pks and rows agree
exactly away from ties; below ``HOST_FLOP_CUTOFF`` the CPU ops equal the
reference bitwise, and ``stats_snapshot()`` deltas always match exactly.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import bitmap_filter as r_bf
from repro.kernels import fused_scan as r_fs
from repro.kernels import ivf_scan as r_ivf
from repro.kernels import ops as r_ops
from repro.kernels import ref as r_ref
from repro_torch.kernels import bitmap_filter as p_bf
from repro_torch.kernels import fused_scan as p_fs
from repro_torch.kernels import ivf_scan as p_ivf
from repro_torch.kernels import ops as p_ops
from repro_torch.kernels import ref as p_ref

CPU = "cpu"


def d2_tol(q, x):
    """Elementwise tolerance for (nq, n) squared distances."""
    qn = (np.asarray(q, np.float64) ** 2).sum(1)[:, None]
    xn = (np.asarray(x, np.float64) ** 2).sum(1)[None, :]
    return 1e-5 * (qn + xn)


@pytest.fixture
def fresh_shapes():
    """Both packages' process-wide shape caches start empty, so the
    shape-miss counts of one call compare one to one."""
    r_ops._seen_shapes.clear()
    p_ops._seen_shapes.clear()
    yield


def _delta(snap, before):
    return tuple(a - b for a, b in zip(snap(), before))


# ---------------------------------------------------------------------------
# plain versions and wrappers vs Pallas (interpret) and the jnp oracles
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("nq,n,d,pad_rows", [(8, 512, 16, 0),
                                             (16, 1024, 64, 100),
                                             (8, 512, 7, 511)])
def test_ivf_scan_plain_matches_pallas(nq, n, d, pad_rows):
    rng = np.random.default_rng(1)
    q = rng.normal(size=(nq, d)).astype(np.float32)
    x = rng.normal(size=(n, d)).astype(np.float32)
    if pad_rows:                  # the host's 1e30 row padding
        x[n - pad_rows:] = 1e30
    want = np.asarray(r_ivf.ivf_scan(jnp.asarray(q), jnp.asarray(x),
                                     interpret=True))
    oracle = np.asarray(r_ref.ivf_scan_ref(jnp.asarray(q), jnp.asarray(x)))
    got = p_ivf.ivf_scan(torch.from_numpy(q), torch.from_numpy(x)).numpy()
    fin = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), fin)
    np.testing.assert_array_equal(np.isfinite(oracle), fin)
    tol = d2_tol(q, x)
    assert (np.abs(got[fin] - want[fin]) <= tol[fin]).all()
    assert (np.abs(got[fin] - oracle[fin]) <= tol[fin]).all()
    if pad_rows:
        assert np.isposinf(got[:, n - pad_rows:]).all()


def test_ivf_launch_path_rule():
    """The card takes the skinny path for at most 8 queries whose
    zero-padded rows (features rounded up to 16) fit 48 KB; else 128-row
    wide tiles, unless 64-row ones leave the busiest of 132 SMs less work
    (a 64-row tile counted 15 % dearer).  Every path computes the same
    operations."""
    lp = p_ivf.launch_path
    assert p_ivf.skinny_smem(8, 100) == 8 * 112 * 4
    assert lp(1, 512, 128) == "skinny" and lp(8, 512, 128) == "skinny"
    assert lp(8, 512, 1536) == "skinny"                  # 48 KB exactly
    assert lp(8, 512, 1537) == "wide-64"                 # 8 rows: 64-row tiles
    assert lp(1, 512, 12288) == "skinny" and lp(1, 512, 12289) != "skinny"
    # 2,048 x 512: 128 tiles of 128 rows, one an SM
    assert lp(2048, 512, 128) == "wide" and lp(2048, 512, 16) == "wide"
    # 2,056 rows make 17 tiles of 128 rows (136 tiles, a second wave on 4
    # SMs) but 33 of 64 (264 tiles, 2 an SM)
    assert lp(2056, 512, 128) == "wide-64"
    assert lp(1024, 512, 128) == "wide-64"               # 64 vs 128 tiles
    assert lp(9, 512, 128) == "wide-64"
    assert lp(16384, 512, 128) == "wide" and lp(16384, 2048, 128) == "wide"
    assert lp(2056, 512, 128, sms=136) == "wide"         # one wave again
    assert set(p_ivf.PATHS) == {"skinny", "wide", "wide-64"}


def test_ivf_wrapper_constants_are_the_sources():
    """The wrapper's shape rule reads the kernel's tiling from constants of
    its own; they must be csrc/ivf_scan.cu's, or the rule and the shared
    memory it checks would describe another kernel."""
    import re
    from pathlib import Path
    src = (Path(p_ivf.__file__).parent / "csrc" / "ivf_scan.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+)", src).group(1))
    assert p_ivf._K_SLICE == const("kBK")
    assert p_ivf._TILE_N == 16 * const("kTN")
    assert p_ivf.SKINNY_MAX_Q == const("kSkinnyQ")


@pytest.mark.parametrize("nq,n,d", [(1, 600, 2), (8, 512, 16),
                                    (8, 1537, 128), (9, 512, 128),
                                    (64, 700, 16), (2048, 512, 16)])
def test_ivf_scan_plain_matches_pallas_on_every_launch_path(nq, n, d):
    """At shapes of every launch path of the card, with 1e30 pad rows,
    the port's ivf_scan (plain version on the CPU) against the oracle and,
    where its tiling takes the shape, the Pallas kernel (interpret):
    within 1e-5 (||q||^2 + ||x||^2), pad rows +inf."""
    rng = np.random.default_rng(2)
    q = rng.normal(size=(nq, d)).astype(np.float32)
    x = rng.normal(size=(n, d)).astype(np.float32)
    x[n - n // 4:] = 1e30
    got = p_ivf.ivf_scan(torch.from_numpy(q), torch.from_numpy(x)).numpy()
    wants = [np.asarray(r_ref.ivf_scan_ref(jnp.asarray(q), jnp.asarray(x)))]
    if nq % 8 == 0 and n % 512 == 0:
        wants.append(np.asarray(r_ivf.ivf_scan(jnp.asarray(q), jnp.asarray(x),
                                               interpret=True)))
    tol = d2_tol(q, x)
    for want in wants:
        fin = np.isfinite(want)
        np.testing.assert_array_equal(np.isfinite(got), fin)
        assert (np.abs(got[fin] - want[fin]) <= tol[fin]).all()
    assert np.isposinf(got[:, n - n // 4:]).all()


@pytest.mark.parametrize("n,c", [(1024, 1), (2048, 2), (3072, 3)])
def test_bitmap_plain_matches_pallas(n, c):
    rng = np.random.default_rng(2)
    cols = rng.uniform(0, 10, (n, c)).astype(np.float32)
    cols[::37] = np.nan
    cols[::53, 0] = np.inf
    bounds = np.sort(rng.uniform(0, 10, (c, 2)), axis=1).astype(np.float32)
    bounds[0] = [-np.inf, 6.0]
    want = np.asarray(r_bf.bitmap_filter(jnp.asarray(cols),
                                         jnp.asarray(bounds),
                                         interpret=True)).astype(bool)
    oracle = np.asarray(r_ref.bitmap_filter_ref(jnp.asarray(cols),
                                                jnp.asarray(bounds)))
    got = p_bf.bitmap_filter(torch.from_numpy(cols), torch.from_numpy(bounds))
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy().astype(bool), want)
    np.testing.assert_array_equal(want, oracle)


def test_rect_filter_plain_matches_oracle():
    rng = np.random.default_rng(3)
    pts = rng.uniform(0, 10, (999, 2)).astype(np.float32)
    pts[::11] = [2.0, 3.0]                     # on the rectangle's corner
    rect = np.asarray([2.0, 3.0, 7.5, 8.0], np.float32)
    want = np.asarray(r_ref.rect_filter_ref(jnp.asarray(pts),
                                            jnp.asarray(rect)))
    got = p_ref.rect_filter_ref(torch.from_numpy(pts), torch.from_numpy(rect))
    np.testing.assert_array_equal(got.numpy(), want)


def _fused_case(nq, n, d, mask_kind, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(nq, d)).astype(np.float32)
    x = rng.normal(size=(n, d)).astype(np.float32)
    if mask_kind == "full":
        mask = np.ones((nq, n), bool)
    elif mask_kind == "partial":
        mask = rng.random((nq, n)) < 0.3
    elif mask_kind == "block_holes":   # whole blocks masked for all queries
        mask = np.ones((nq, n), bool)
        mask[:, :p_fs.BLOCK_N] = False
        mask[:, -p_fs.BLOCK_N // 2:] = False
    else:                              # "tile_empty": one query tile empty
        mask = rng.random((nq, n)) < 0.5
        mask[:p_fs.BLOCK_Q, n // 2:] = False
    pks = (rng.permutation(n).astype(np.int64) * 7 + 3)
    return q, x, mask, pks


def _wrapper_args(q, x, mask, pks):
    """Inputs as ops.fused_scan_topk hands them to the kernel wrapper."""
    return p_ops.fused_kernel_args(q, x, mask, pks, torch.device("cpu"))


@pytest.mark.parametrize("nq,n,d", [(8, 1024, 16), (16, 1000, 8)])
@pytest.mark.parametrize("mask_kind", ["full", "partial", "block_holes",
                                       "tile_empty"])
def test_fused_wrapper_matches_pallas(nq, n, d, mask_kind):
    """The port's wrapper (plain version over the kept blocks, read
    through their ids) against the Pallas kernel on the host-compacted
    matrix the JAX package builds."""
    q, x, mask, pks = _fused_case(nq, n, d, mask_kind)
    args, keep = _wrapper_args(q, x, mask, pks)
    gd, gp, gi = (t.numpy() for t in p_fs.fused_scan_topk(*args))
    BN = r_fs.BLOCK_N
    xp = args[1].numpy()
    mp = np.zeros((nq, xp.shape[0]), np.uint8)
    mp[:, :n] = mask
    xk = xp.reshape(-1, BN, d)[keep].reshape(-1, d)
    mk = mp.reshape(nq, -1, BN)[:, keep].reshape(nq, -1)
    pk = args[3].numpy().reshape(-1, BN)[keep].reshape(1, -1)
    occ = mk.reshape(nq // 8, 8, -1, BN).any(axis=(1, 3)).astype(np.int32)
    wd, wp, wi = (np.asarray(a) for a in r_fs.fused_scan_topk(
        jnp.asarray(q), jnp.asarray(xk), jnp.asarray(mk), jnp.asarray(pk),
        jnp.asarray(occ), interpret=True))
    od, op, oi = (np.asarray(a) for a in r_ref.fused_topk_ref(
        jnp.asarray(q), jnp.asarray(xk), jnp.asarray(mk), jnp.asarray(pk),
        k=r_fs.KMAX))
    fin = np.isfinite(wd)
    np.testing.assert_array_equal(np.isfinite(gd), fin)
    tol = 1e-5 * ((q.astype(np.float64) ** 2).sum(1)[:, None]
                  + (x.astype(np.float64) ** 2).sum(1).max())
    tol = np.broadcast_to(tol, wd.shape)
    assert (np.abs(gd - wd)[fin] <= tol[fin]).all()
    np.testing.assert_array_equal(gp, wp)
    np.testing.assert_array_equal(gi, wi)
    np.testing.assert_array_equal(wp, op)
    np.testing.assert_array_equal(wi, oi)


def test_fused_wrapper_orders_ties_by_pk():
    """Equal d2 with distinct pks come back in pk order, then row."""
    q = np.zeros((8, 4), np.float32)
    x = np.ones((700, 4), np.float32)           # every row at d2 = 4
    mask = np.ones((8, 700), bool)
    pks = np.arange(700)[::-1].astype(np.int64) * 2
    args, _ = _wrapper_args(q, x, mask, pks)
    gd, gp, gi = (t.numpy() for t in p_fs.fused_scan_topk(*args))
    assert (gd == 4.0).all()
    np.testing.assert_array_equal(gp[0], np.sort(pks)[:p_fs.KMAX])
    np.testing.assert_array_equal(gi[0], np.arange(699, 699 - p_fs.KMAX, -1))


def test_fused_wrapper_empty_slots():
    q, x, mask, pks = _fused_case(8, 600, 4, "partial")
    mask[:] = False
    mask[2, [5, 9]] = True                      # k above the candidates
    args, _ = _wrapper_args(q, x, mask, pks)
    gd, gp, gi = (t.numpy() for t in p_fs.fused_scan_topk(*args))
    assert np.isfinite(gd[2, :2]).all() and np.isinf(gd[2, 2:]).all()
    assert (gp[2, 2:] == p_fs.SENTINEL).all()
    assert (gi[2, 2:] == p_fs.SENTINEL).all()
    assert np.isinf(gd[[0, 1, 3]]).all()
    assert sorted(gi[2, :2].tolist()) == [5, 9]


@pytest.mark.parametrize("n_qtiles,nkeep,sms", [
    (1, 4096, 132), (1, 512, 132), (1, 303, 132), (1, 1, 132), (1, 3, 132),
    (2, 4096, 132), (256, 4096, 132), (1, 100_000, 132), (3, 4096, 16)])
def test_fused_chunking_covers_every_group(n_qtiles, nkeep, sms):
    """The scan's grid: the kept blocks' 32-row groups in contiguous
    chunks of sizes that differ by at most one, every group in exactly
    one, no chunk empty, at most MAX_CHUNKS (the launcher's limit), two
    blocks an SM over the query tiles and, with enough groups, the
    MIN_CHUNKS a tile needs for KMAX witnesses; the witnesses sample about
    1/32 of the rows; the scratch has the shapes the launcher writes."""
    groups = nkeep * p_fs.BLOCK_N // p_fs.GROUP_ROWS
    chunks = p_fs.chunking(n_qtiles, nkeep, sms)
    assert 1 <= chunks <= min(p_fs.MAX_CHUNKS, groups)
    spans = [p_fs.chunk_groups(c, chunks, nkeep) for c in range(chunks)]
    assert spans[0][0] == 0 and spans[-1][1] == groups
    assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))
    sizes = [hi - lo for lo, hi in spans]
    assert min(sizes) >= 1 and max(sizes) - min(sizes) <= 1
    if groups >= p_fs.MIN_CHUNKS:
        assert chunks * p_fs.WITNESSES >= p_fs.KMAX
    want = max(p_fs.MIN_CHUNKS, -(-2 * sms // n_qtiles))   # 2 blocks an SM
    assert chunks == min(want, p_fs.MAX_CHUNKS, groups)
    sample = p_fs.witness_rows(nkeep, chunks)
    most = p_fs.SAMPLE_ROWS * p_fs.SAMPLE_GROUPS        # rows a chunk
    rows = nkeep * p_fs.BLOCK_N
    if groups <= chunks * p_fs.SAMPLE_EVERY * p_fs.SAMPLE_GROUPS:
        # one group in 8, rounded up a chunk
        assert rows / 32 <= sample <= rows / 32 + chunks * p_fs.SAMPLE_ROWS
    assert sample <= chunks * most
    nq = 8 * n_qtiles
    scratch = p_fs.launch_scratch(nq, chunks, torch.device("cpu"))
    cap = chunks * p_fs.KMAX
    assert [tuple(t.shape) for t in scratch] == [
        (nq, chunks * p_fs.WITNESSES), (nq,), (nq, cap), (nq, cap),
        (nq, cap), (nq, cap), (nq,)]
    assert [t.dtype for t in scratch] == [torch.int32, torch.float32,
                                          torch.float32, torch.int32,
                                          torch.float32, torch.int32,
                                          torch.int32]


def test_fused_wrapper_constants_are_the_sources():
    """The wrapper sizes the grid, the scratch and the scan's shared memory
    from constants of its own; they must be csrc/fused_scan.cu's, or the
    launcher would refuse the launch (its smem check) or the buffers would
    not be what the kernels write."""
    import re
    from pathlib import Path
    src = (Path(p_fs.__file__).parent / "csrc" / "fused_scan.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+)", src).group(1))
    assert p_fs.GROUP_ROWS == const("kRows")
    assert p_fs._TILE == const("kDk")
    assert p_fs.WITNESSES == const("kWit")
    assert p_fs.MAX_CHUNKS == const("kMaxChunks")
    assert p_fs.SLOTS == const("kSlots")
    assert p_fs._BLOCKS_PER_SM == const("kScanBlocks")
    assert (p_fs.SAMPLE_ROWS, p_fs.SAMPLE_EVERY, p_fs.SAMPLE_GROUPS) == (
        const("kSampleRows"), const("kSampleEvery"), const("kSampleGroups"))
    assert p_fs._WARPS == const("kThreads") // 32
    assert p_fs.MIN_CHUNKS * p_fs.WITNESSES >= p_fs.KMAX
    # the query tile's padded stride: odd in float4s, never below d
    for d in (1, 2, 4, 7, 8, 37, 128, 4096):
        qs = p_fs.q_stride(d)
        assert qs >= d and qs % 4 == 0 and (qs // 4) % 2 == 1
    assert p_fs.smem_bytes(128) == (8 * 132 * 4 + 8 * 2 * (32 * 36 * 4)
                                    + 8 * 2 * 16 + 8 * 2 * 32 + 32 + 64)


def test_fused_wrapper_refuses_a_d_the_card_cannot_hold(monkeypatch):
    """The query tile and each warp's ring sit in the scan's shared memory:
    two scan blocks fit an SM at TRACY's d = 128, one block still fits at
    d = MAX_DIM, a d past the card's per-block limit raises ValueError
    (here on a card that allows less than d = 4096 needs), and d > MAX_DIM
    is refused on every device, never a quiet fallback."""
    from repro_torch.kernels import build as p_build
    limit = p_build.smem_per_block("cpu")
    assert 2 * (p_fs.smem_bytes(128) + 1024) <= 233_472     # an SM's 228 KB
    assert p_fs.smem_bytes(p_fs.MAX_DIM) <= limit < p_fs.smem_bytes(5120)

    def args(d):
        return (torch.zeros((8, d)), torch.zeros((512, d)),
                torch.ones((8, 512), dtype=torch.uint8),
                torch.zeros(512, dtype=torch.int32),
                torch.zeros(1, dtype=torch.int32),
                torch.ones((1, 1), dtype=torch.int32))
    with pytest.raises(ValueError, match="shapes"):
        p_fs.fused_scan_topk(*args(p_fs.MAX_DIM + 1))
    monkeypatch.setattr(p_build, "smem_per_block",
                        lambda dev: p_fs.smem_bytes(p_fs.MAX_DIM) - 1)
    with pytest.raises(ValueError, match="shared memory"):
        p_fs.fused_scan_topk(*args(p_fs.MAX_DIM))
    d, _, _ = p_fs.fused_scan_topk(*args(16))             # plain version
    assert d.shape == (8, p_fs.KMAX)


# ---------------------------------------------------------------------------
# ops on the CPU vs the JAX package's default backend
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("nq,n,d", [(3, 700, 16),       # host path
                                    (1, 45, 128),        # centroid probe
                                    (40, 1500, 96)])     # plain-version path
def test_l2_distances_parity(fresh_shapes, nq, n, d):
    rng = np.random.default_rng(4)
    q = rng.normal(size=(nq, d)).astype(np.float32)
    x = rng.normal(size=(n, d)).astype(np.float32)
    b0 = r_ops.stats_snapshot()
    want = r_ops.l2_distances(q, x, use_pallas=False)
    rd = _delta(r_ops.stats_snapshot, b0)
    b1 = p_ops.stats_snapshot()
    got = p_ops.l2_distances(q, x, device=CPU)
    assert _delta(p_ops.stats_snapshot, b1) == rd
    if nq * n * d < p_ops.HOST_FLOP_CUTOFF:
        np.testing.assert_array_equal(got, want)
    else:
        assert (np.abs(got - want) <= d2_tol(q, x)).all()


def test_assign_nearest_and_block_topk_parity(fresh_shapes):
    rng = np.random.default_rng(5)
    x = rng.normal(size=(3000, 16)).astype(np.float32)
    c = rng.normal(size=(54, 16)).astype(np.float32)
    np.testing.assert_array_equal(
        p_ops.assign_nearest(x, c, device=CPU), r_ops.assign_nearest(x, c))
    q = rng.normal(size=16).astype(np.float32)
    for k in (1, 10, 3000):
        gd, gi = p_ops.block_topk(q, x, k, device=CPU)
        wd, wi = r_ops.block_topk(q, x, k, use_pallas=False)
        np.testing.assert_array_equal(gd, wd)
        np.testing.assert_array_equal(gi, wi)


@pytest.mark.parametrize("n,c", [(5000, 1), (3000, 2),      # host path
                                 (2_100_000, 2)])           # plain version
def test_range_bitmap_parity(fresh_shapes, n, c):
    rng = np.random.default_rng(6)
    cols = rng.uniform(0, 10, (n, c)).astype(np.float32)
    cols[::41] = np.nan
    bounds = np.sort(rng.uniform(0, 10, (c, 2)), axis=1)
    b0 = r_ops.stats_snapshot()
    want = r_ops.range_bitmap(cols, bounds, use_pallas=False)
    rd = _delta(r_ops.stats_snapshot, b0)
    b1 = p_ops.stats_snapshot()
    got = p_ops.range_bitmap(cols, bounds, device=CPU)
    assert _delta(p_ops.stats_snapshot, b1) == rd
    assert got.dtype == bool
    np.testing.assert_array_equal(got, want)
    if c == 2:
        rect = (bounds[0, 0], bounds[1, 0], bounds[0, 1], bounds[1, 1])
        np.testing.assert_array_equal(
            p_ops.rect_filter(cols, rect, device=CPU),
            r_ops.rect_filter(cols, rect, use_pallas=False))


def _tie_aware_rows(gd, gr, wd, wr, tol):
    """Rows agree except where a d2 ties the k-th within ``tol``."""
    for qi in range(len(wd)):
        fin = np.isfinite(wd[qi])
        np.testing.assert_array_equal(np.isfinite(gd[qi]), fin)
        assert (np.abs(gd[qi][fin] - wd[qi][fin]) <= tol[qi]).all()
        only = set(gr[qi][fin].tolist()) ^ set(wr[qi][fin].tolist())
        if only:
            kth = wd[qi][fin][-1]
            d_of = dict(zip(gr[qi][fin].tolist(), gd[qi][fin]))
            d_of.update(zip(wr[qi][fin].tolist(), wd[qi][fin]))
            assert all(abs(d_of[r] - kth) <= tol[qi] for r in only)


@pytest.mark.parametrize("case", ["ragged", "ties", "all_masked",
                                  "few_candidates", "above_cutoff"])
def test_fused_scan_topk_parity(fresh_shapes, case):
    rng = np.random.default_rng(7)
    nq, n, d, k = {"ragged": (5, 1300, 16, 10), "ties": (3, 900, 8, 20),
                   "all_masked": (9, 700, 4, 10),
                   "few_candidates": (4, 800, 16, 50),
                   "above_cutoff": (12, 9000, 48, 10)}[case]
    q = rng.normal(size=(nq, d)).astype(np.float32)
    x = rng.normal(size=(n, d)).astype(np.float32)
    pks = rng.permutation(n).astype(np.int64) * 5
    mask = rng.random((nq, n)) < 0.4
    if case == "ties":                  # duplicated rows, distinct pks
        x[1::2] = x[0::2][:len(x[1::2])]
    elif case == "all_masked":
        mask[:] = False
    elif case == "few_candidates":
        mask[:] = False
        mask[1, rng.choice(n, 7, replace=False)] = True
    b0 = r_ops.stats_snapshot()
    wd, wr = r_ops.fused_scan_topk(q, x, mask, pks, k, use_pallas=False)
    rd = _delta(r_ops.stats_snapshot, b0)
    b1 = p_ops.stats_snapshot()
    gd, gr = p_ops.fused_scan_topk(q, x, mask, pks, k, device=CPU)
    assert _delta(p_ops.stats_snapshot, b1) == rd
    if case != "above_cutoff":
        np.testing.assert_array_equal(gd, wd)
        np.testing.assert_array_equal(gr, wr)
    else:
        tol = 1e-5 * ((q.astype(np.float64) ** 2).sum(1)
                      + (x.astype(np.float64) ** 2).sum(1).max())
        _tie_aware_rows(gd, gr, wd, wr, tol)


# ---------------------------------------------------------------------------
# the card's host-side path (padding, kept blocks, occupancy, row mapping)
# against the JAX package's Pallas branch; on CPU tensors the wrappers take
# their plain versions, so only the kernels themselves are left to the card
# ---------------------------------------------------------------------------

HOST = torch.device("cpu")


@pytest.mark.parametrize("nq,n,d", [(3, 700, 16), (9, 1100, 128)])
def test_card_path_l2_matches_pallas_branch(fresh_shapes, nq, n, d):
    rng = np.random.default_rng(9)
    q = rng.normal(size=(nq, d)).astype(np.float32)
    x = rng.normal(size=(n, d)).astype(np.float32)
    b0 = r_ops.stats_snapshot()
    want = r_ops.l2_distances(q, x, use_pallas=True)
    rd = _delta(r_ops.stats_snapshot, b0)
    b1 = p_ops.stats_snapshot()
    got = p_ops._l2_kernel(q, x, HOST)
    assert _delta(p_ops.stats_snapshot, b1) == rd
    assert got.shape == want.shape
    assert (np.abs(got - want) <= d2_tol(q, x)).all()


def test_card_path_bitmap_matches_pallas_branch(fresh_shapes):
    rng = np.random.default_rng(10)
    cols = rng.uniform(0, 10, (1500, 2)).astype(np.float32)
    cols[::13] = np.nan
    bounds = np.asarray([[1.0, 6.0], [2.5, 9.0]], np.float32)
    b0 = r_ops.stats_snapshot()
    want = r_ops.range_bitmap(cols, bounds, use_pallas=True)
    rd = _delta(r_ops.stats_snapshot, b0)
    b1 = p_ops.stats_snapshot()
    got = p_ops._bitmap_kernel(cols, bounds, HOST)
    assert _delta(p_ops.stats_snapshot, b1) == rd
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("case", ["ragged", "block_holes", "few_candidates",
                                  "ties"])
def test_card_path_fused_matches_pallas_branch(fresh_shapes, case):
    rng = np.random.default_rng(11)
    nq, n, d, k = (5, 1300, 16, 10) if case != "block_holes" \
        else (11, 2600, 8, 25)
    q = rng.normal(size=(nq, d)).astype(np.float32)
    x = rng.normal(size=(n, d)).astype(np.float32)
    pks = rng.permutation(n).astype(np.int64) * 3
    mask = rng.random((nq, n)) < 0.3
    if case == "block_holes":
        mask[:, 512:1536] = False
    elif case == "few_candidates":
        mask[:] = False
        mask[2, [3, 700, 1299]] = True
    elif case == "ties":
        x[1::2] = x[0::2][:len(x[1::2])]
    b0 = r_ops.stats_snapshot()
    wd, wr = r_ops.fused_scan_topk(q, x, mask, pks, k, use_pallas=True)
    rd = _delta(r_ops.stats_snapshot, b0)
    b1 = p_ops.stats_snapshot()
    gd, gr = p_ops._fused_kernel(q, x, mask, pks, k, HOST)
    assert _delta(p_ops.stats_snapshot, b1) == rd
    assert gd.shape == wd.shape == (nq, k)
    tol = 1e-5 * ((q.astype(np.float64) ** 2).sum(1)
                  + (x.astype(np.float64) ** 2).sum(1).max())
    _tie_aware_rows(gd, gr, wd, wr, tol)
    if case != "ties":
        np.testing.assert_array_equal(gr, wr)


# ---------------------------------------------------------------------------
# device rules
# ---------------------------------------------------------------------------

def test_ops_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x = np.ones((4, 3), np.float32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        p_ops.l2_distances(x, x)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        p_ops.range_bitmap(x[:, :1], np.asarray([[0.0, 1.0]]))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        p_ops.fused_scan_topk(x, x, np.ones((4, 4), bool), np.arange(4), 2)


@pytest.mark.gpu
def test_kernels_match_plain_versions_on_the_card():
    """Each hand-written kernel against its plain version on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    dev = torch.device("cuda")
    rng = np.random.default_rng(8)
    q = torch.from_numpy(rng.normal(size=(13, 40)).astype(np.float32)).to(dev)
    x = torch.from_numpy(rng.normal(size=(999, 40)).astype(np.float32)).to(dev)
    got = p_ivf.ivf_scan(q, x).cpu().numpy()
    want = p_ref.ivf_scan_ref(q, x).cpu().numpy()
    assert (np.abs(got - want) <= d2_tol(q.cpu(), x.cpu())).all()
    cols = x[:, :3].contiguous()
    bounds = torch.tensor([[-1.0, 1.0], [-0.5, 2.0], [0.0, 9.0]], device=dev)
    np.testing.assert_array_equal(
        p_bf.bitmap_filter(cols, bounds).cpu().numpy().astype(bool),
        p_ref.bitmap_filter_ref(cols, bounds).cpu().numpy())
    qn, xn, mask, pks = _fused_case(16, 1500, 24, "partial")
    args, _ = _wrapper_args(qn, xn, mask, pks)
    cpu = [t.numpy() for t in p_fs.fused_scan_topk(*args)]
    card = [t.cpu().numpy() for t in
            p_fs.fused_scan_topk(*(a.to(dev) for a in args))]
    tol = 1e-5 * ((qn.astype(np.float64) ** 2).sum(1)[:, None]
                  + (xn.astype(np.float64) ** 2).sum(1).max())
    fin = np.isfinite(cpu[0])
    assert (np.abs(card[0] - cpu[0])[fin]
            <= np.broadcast_to(tol, fin.shape)[fin]).all()
    np.testing.assert_array_equal(card[1], cpu[1])


@pytest.mark.gpu
@pytest.mark.parametrize("kind,n,d", [("partial", 20_000, 24),
                                      ("rerank", 65_536, 32),
                                      ("dup4", 65_536, 16),
                                      ("nan", 3000, 32), ("inf", 3000, 32),
                                      ("unsampled", 262_144, 24),
                                      ("few", 5000, 37)])
def test_fused_kernel_matches_plain_version_on_the_card(kind, n, d):
    """The fused scan's kernel against its plain version on the card at
    small shapes, held as ``chip_smoke.py`` holds it (tie-aware against
    float64 at the fp32 rounding bound, NaN rows never in an answer, rows
    whose d2 overflows after the finite ones in pk order): a dense mask,
    a re-rank's 40 rows a query, ties at the threshold, NaN and +inf rows,
    a mask the witnesses never sample (full regions rescanned) and a
    query under 128 admitted rows, at d % 4 != 0 too."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    import importlib.util
    from pathlib import Path
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    rng = np.random.default_rng(9)
    args = cs.fused_inputs(rng, 8, n, d, torch.device("cuda"), kind,
                           kind == "partial")
    out = p_fs.fused_scan_topk(*args)
    plain, _ = cs.fused_plain(args)
    cs.fused_compare(args, out, plain)
