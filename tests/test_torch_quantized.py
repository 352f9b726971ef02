"""Quantized dispatch and the IVF-PQ index in the port, against the JAX
package: the ADC plain versions and wrappers against the Pallas kernels
(interpret mode) and ``kernels/ref.py`` oracles, the CPU ops against the
default backend, the card path's host logic against the Pallas branch,
recall-targeted TRACY templates through ``Executor.execute_many``, and a
PQ-IVF store fed one put/update/delete stream.

Tolerances: none.  ADC values are fp32 sums over j in order on both sides
(the Pallas one-hot contraction adds one exact term per j), so ADC
distances, pks and rows agree bitwise; below ``HOST_FLOP_CUTOFF`` every
engine answer is host numpy on both sides, so pk, score, ``ExecStats``
and plan text agree exactly, as do ``stats_snapshot()`` deltas.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks import tracy
from repro.core.executor import Executor as RExecutor
from repro.core.lsm import LSMConfig as RConfig
from repro.core.lsm import LSMStore as RStore
from repro.core.optimizer import planner as r_planner
from repro.core import query as rq
from repro.core.types import Column as RColumn
from repro.core.types import ColumnType as RType
from repro.core.types import IndexKind as RKind
from repro.core.types import Schema as RSchema
from repro.kernels import fused_scan as r_fs
from repro.kernels import ops as r_ops
from repro.kernels import pq_adc as r_pq
from repro.kernels import quantized_scan as r_qs
from repro.kernels import ref as r_ref
from repro_torch import convert
from repro_torch.core.executor import Executor as PExecutor
from repro_torch.core.lsm import LSMConfig as PConfig
from repro_torch.core.lsm import LSMStore as PStore
from repro_torch.core.optimizer import planner as p_planner
from repro_torch.core import query as pq
from repro_torch.core import quantize as p_qz
from repro_torch.core import segment as p_seg
from repro_torch.core.types import Column as PColumn
from repro_torch.core.types import ColumnType as PType
from repro_torch.core.types import IndexKind as PKind
from repro_torch.core.types import Schema as PSchema
from repro_torch.kernels import build as p_build
from repro_torch.kernels import fused_scan as p_fs
from repro_torch.kernels import ops as p_ops
from repro_torch.kernels import pq_adc as p_pq
from repro_torch.kernels import quantized_scan as p_qs
from repro_torch.kernels import ref as p_ref
from conftest import make_batch
from test_torch_query import assert_same, export, port_schema, to_port
from test_torch_store import feed, stream

HOST = torch.device("cpu")
BN = r_fs.BLOCK_N


@pytest.fixture
def fresh_shapes():
    """Both packages' process-wide shape caches start empty, so the
    shape-miss counts of one call compare one to one."""
    r_ops._seen_shapes.clear()
    p_ops._seen_shapes.clear()
    yield


def _delta(snap, before):
    return tuple(a - b for a, b in zip(snap(), before))


def _bits(a):
    return np.ascontiguousarray(a, np.float32).view(np.uint32)


def _make_pq(n, d, m, seed=0):
    """Random codes + codebooks shaped like a quantized rank column."""
    rng = np.random.default_rng(seed)
    codebooks = rng.normal(size=(m, 256, d // m)).astype(np.float32)
    codes = rng.integers(0, 256, (n, m), dtype=np.uint8)
    return codes, codebooks


def _mask(rng, nq, n, kind):
    if kind == "full":
        return np.ones((nq, n), bool)
    if kind == "partial":
        return rng.random((nq, n)) < 0.3
    if kind == "block_holes":          # whole blocks masked for every query
        mask = np.ones((nq, n), bool)
        mask[:, :BN] = False
        mask[:, -BN // 2:] = False
        return mask
    mask = rng.random((nq, n)) < 0.5   # "tile_empty": one query tile empty
    mask[:r_fs.BLOCK_Q, n // 2:] = False
    return mask


# ---------------------------------------------------------------------------
# kernel level: the wrappers' plain versions vs Pallas and the jnp oracles
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("nq,n,m", [(8, 1024, 8), (8, 1536, 16),
                                    (16, 1024, 4), (16, 1300, 8)])
@pytest.mark.parametrize("mask_kind", ["full", "partial", "block_holes",
                                       "tile_empty"])
def test_kernel_matches_ref(nq, n, m, mask_kind):
    """The port's wrapper (plain version over the kept blocks, read
    through their ids) against the Pallas kernel on the host-compacted
    matrix the JAX package builds, and against the oracle: bitwise."""
    rng = np.random.default_rng(0)
    q = rng.normal(size=(nq, 4 * m)).astype(np.float32)
    codes, books = _make_pq(n, 4 * m, m, seed=1)
    mask = _mask(rng, nq, n, mask_kind)
    pks = np.arange(n, dtype=np.int64) * 7 + 3
    lut = p_ops.adc_lut(q, books)
    np.testing.assert_array_equal(_bits(lut), _bits(r_ops.adc_lut(q, books)))
    args, keep = p_ops.quantized_kernel_args(lut, codes, mask, pks, HOST)
    gd, gp, gi = (t.numpy() for t in p_qs.quantized_scan_topk(*args))
    ck, mk, pk = (t.numpy() for t in p_fs.compact(*args[1:5]))
    occ = mk.reshape(nq // 8, 8, -1, BN).any(axis=(1, 3)).astype(np.int32)
    wd, wp, wi = (np.asarray(a) for a in r_qs.quantized_scan_topk(
        jnp.asarray(lut.reshape(nq, m * 256)), jnp.asarray(ck.astype(np.int32)),
        jnp.asarray(mk), jnp.asarray(pk), jnp.asarray(occ), interpret=True))
    od, op, oi = (np.asarray(a) for a in r_ref.quantized_topk_ref(
        jnp.asarray(lut), jnp.asarray(ck.astype(np.int32)), jnp.asarray(mk),
        jnp.asarray(pk), k=r_fs.KMAX))
    np.testing.assert_array_equal(_bits(gd), _bits(wd))
    np.testing.assert_array_equal(_bits(wd), _bits(od))
    for got, want, oracle in ((gp, wp, op), (gi, wi, oi)):
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(want, oracle)


def test_kernel_tie_break_by_pk():
    """Duplicate codes give bitwise-equal ADC distances: within every run
    of equal distances the winners ascend by pk."""
    rng = np.random.default_rng(1)
    m, n = 8, 1100
    codes, books = _make_pq(8, 4 * m, m, seed=2)
    x = codes[rng.integers(0, 8, n)]                    # 8 distinct rows
    pks = rng.permutation(n).astype(np.int64) * 5 + 2
    q = rng.normal(size=(8, 4 * m)).astype(np.float32)
    args, _ = p_ops.quantized_kernel_args(p_ops.adc_lut(q, books), x,
                                          np.ones((8, n), bool), pks, HOST)
    kd, kp, _ = (t.numpy() for t in p_qs.quantized_scan_topk(*args))
    ties = 0
    for qi in range(8):
        for i in range(1, r_fs.KMAX):
            if kd[qi, i] == kd[qi, i - 1]:
                ties += 1
                assert kp[qi, i] > kp[qi, i - 1]
    assert ties > 100


@pytest.mark.parametrize("n,m", [(512, 4), (1024, 8), (512, 16), (700, 8)])
def test_pq_adc_kernel_matches_ref(n, m):
    rng = np.random.default_rng(1)
    codes = rng.integers(0, 256, (n, m)).astype(np.uint8)
    lut = (rng.normal(size=(m, 256)) ** 2).astype(np.float32)
    got = p_pq.pq_adc(torch.from_numpy(codes), torch.from_numpy(lut)).numpy()
    oracle = np.asarray(r_ref.pq_adc_ref(jnp.asarray(codes.astype(np.int32)),
                                         jnp.asarray(lut)))
    np.testing.assert_array_equal(_bits(got), _bits(oracle))
    if n % BN == 0:
        want = np.asarray(r_pq.pq_adc(jnp.asarray(codes.astype(np.int32)),
                                      jnp.asarray(lut), interpret=True))
        np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("n_qtiles,nkeep,sms", [
    (1, 4096, 132), (1, 2, 132), (1, 70, 132), (8, 4096, 132),
    (256, 4096, 132), (256, 130, 132), (1, 100_000, 132), (3, 4096, 16)])
def test_quantized_chunking_covers_every_kept_block(n_qtiles, nkeep, sms):
    """The scan's grid: every kept block in exactly one chunk, no chunk
    empty, at most MAX_CHUNKS (the launcher's limit), about 3 blocks an SM
    over the query tiles and, with enough kept blocks, the MIN_CHUNKS a
    tile needs for KMAX witnesses."""
    per, chunks = p_qs.chunking(n_qtiles, nkeep, sms)
    assert per * chunks >= nkeep > per * (chunks - 1)
    assert 1 <= chunks <= p_qs.MAX_CHUNKS
    if nkeep >= p_qs.MIN_CHUNKS:
        assert chunks * p_qs.WITNESSES >= r_fs.KMAX
        assert chunks >= min(p_qs.MAX_CHUNKS, 3 * sms // n_qtiles,
                             nkeep) // 2
    nq = 8 * n_qtiles
    scratch = p_qs.launch_scratch(nq, chunks, 8, HOST)
    assert [tuple(t.shape) for t in scratch] == [
        (nq, chunks * p_qs.WITNESSES), (nq,), (nq, 8 * 256),
        (nq, chunks * r_fs.KMAX), (nq, chunks * r_fs.KMAX),
        (nq, chunks * r_fs.KMAX), (nq, chunks * r_fs.KMAX), (nq,)]


def test_quantized_wrapper_constants_are_the_sources():
    """The wrapper sizes the launch's scratch from constants of its own;
    they must be csrc/quantized_scan.cu's, or the witness buffer or the
    chunk count would not be what the kernel writes and reads."""
    import re
    from pathlib import Path
    src = (Path(p_qs.__file__).parent / "csrc" / "quantized_scan.cu"
           ).read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+)", src).group(1))
    assert p_qs.WITNESSES == const("kWit")
    assert p_qs.MAX_CHUNKS == const("kMaxChunks")
    assert p_qs.MIN_CHUNKS * p_qs.WITNESSES >= r_fs.KMAX
    assert p_qs._WARPS == const("kThreads") // 32


@pytest.mark.parametrize("kind", ["dup", "partial"])
def test_kernel_matches_ref_across_many_kept_blocks(kind):
    """At 128 kept blocks (the card splits them into 64 chunks and filters
    by a witness threshold; duplicate codes put many rows at it) the
    wrapper's plain version against the oracle: bitwise."""
    rng = np.random.default_rng(3)
    nq, n, m = 8, 65_536, 8
    q = rng.normal(size=(nq, 4 * m)).astype(np.float32)
    codes, books = _make_pq(n, 4 * m, m, seed=4)
    if kind == "dup":
        codes = codes[rng.integers(0, 16, n)]
    mask = rng.random((nq, n)) < (1.0 if kind == "dup" else 0.3)
    pks = rng.permutation(n).astype(np.int64) * 3 + 1
    lut = p_ops.adc_lut(q, books)
    args, keep = p_ops.quantized_kernel_args(lut, codes, mask, pks, HOST)
    assert len(keep) == n // BN
    gd, gp, gi = (t.numpy() for t in p_qs.quantized_scan_topk(*args))
    ck, mk, pk = (t.numpy() for t in p_fs.compact(*args[1:5]))
    od, op, oi = (np.asarray(a) for a in r_ref.quantized_topk_ref(
        jnp.asarray(lut), jnp.asarray(ck.astype(np.int32)), jnp.asarray(mk),
        jnp.asarray(pk), k=r_fs.KMAX))
    np.testing.assert_array_equal(_bits(gd), _bits(od))
    np.testing.assert_array_equal(gp, op)
    np.testing.assert_array_equal(gi, oi)
    if kind == "dup":
        assert (gd[:, 1:] == gd[:, :-1]).sum() > 100


def test_wrappers_refuse_an_m_the_card_cannot_hold():
    """The tile's LUTs live in shared memory: an m past the card's limit
    raises ValueError on every device, never a quiet fallback."""
    limit = p_build.smem_per_block("cpu")
    assert limit == p_build.SM90_SMEM_OPTIN
    assert p_qs.smem_bytes(26) <= limit < p_qs.smem_bytes(27)
    m = 27
    lut = torch.zeros((8, m * 256))
    codes = torch.zeros((512, m), dtype=torch.uint8)
    with pytest.raises(ValueError, match="shared memory"):
        p_qs.quantized_scan_topk(
            lut, codes, torch.ones((8, 512), dtype=torch.uint8),
            torch.zeros(512, dtype=torch.int32),
            torch.zeros(1, dtype=torch.int32),
            torch.ones((1, 1), dtype=torch.int32))
    with pytest.raises(ValueError, match="shared memory"):
        p_pq.pq_adc(torch.zeros((4, 300), dtype=torch.uint8),
                    torch.zeros((300, 256)))


# ---------------------------------------------------------------------------
# ops on the CPU vs the default backend, and the card path's host logic vs
# the Pallas branch
# ---------------------------------------------------------------------------

def _brute_adc(q, codes, books, mask, pks, k):
    """(adc, row) float64 oracle: smallest ADC distance per query over
    admitted rows, ties by (adc, pk)."""
    lut = r_ops.adc_lut(q, books).astype(np.float64)
    adc = np.zeros((len(q), len(codes)))
    for j in range(codes.shape[1]):
        adc += lut[:, j, :][:, codes[:, j].astype(np.int64)]
    out = []
    for qi in range(len(q)):
        dd = np.where(mask[qi], adc[qi], np.inf)
        order = np.lexsort((pks, dd))[:k]
        out.append(order[np.isfinite(dd[order])])
    return out


@pytest.mark.parametrize("k", [1, 10, 128])
@pytest.mark.parametrize("nq,n,m", [(1, 700, 8), (5, 1400, 16), (9, 130, 4)])
def test_ops_quantized_matches_bruteforce_ragged(fresh_shapes, nq, n, m, k):
    """Both port paths (the CPU simulation and the card path's host logic
    over the plain version) against the reference's two backends, bitwise
    with equal dispatch accounting, and against a float64 brute force."""
    rng = np.random.default_rng(2)
    q = rng.normal(size=(nq, 4 * m)).astype(np.float32)
    codes, books = _make_pq(n, 4 * m, m, seed=3)
    mask = rng.random((nq, n)) < 0.4
    mask[0, :] = False                                # all-masked query
    if nq > 1:
        mask[1, :] = True                             # full bitmap
    pks = np.arange(n, dtype=np.int64) * 3 + 11
    want = _brute_adc(q, codes, books, mask, pks, k)
    for up in (False, True):
        b0 = r_ops.stats_snapshot()
        wd, wr = r_ops.quantized_scan_topk(q, codes, books, mask, pks, k,
                                           use_pallas=up)
        rd = _delta(r_ops.stats_snapshot, b0)
        b1 = p_ops.stats_snapshot()
        if up:
            gd, gr = p_ops._quantized_kernel(p_ops.adc_lut(q, books), codes,
                                             mask, pks, k, HOST)
        else:
            gd, gr = p_ops.quantized_scan_topk(q, codes, books, mask, pks, k,
                                               device="cpu")
        assert _delta(p_ops.stats_snapshot, b1) == rd
        np.testing.assert_array_equal(_bits(gd), _bits(wd))
        np.testing.assert_array_equal(gr, wr)
        assert gd.shape == gr.shape == (nq, k)
        for qi in range(nq):
            np.testing.assert_array_equal(gr[qi][gr[qi] >= 0], want[qi])
            assert (gr[qi][len(want[qi]):] == -1).all()
            assert np.isinf(gd[qi][len(want[qi]):]).all()


@pytest.mark.parametrize("case", ["ragged", "block_holes", "few_candidates",
                                  "ties", "device_codes"])
def test_card_path_quantized_matches_pallas_branch(fresh_shapes, case):
    """Run with the plain version, the card path's host logic keeps the
    Pallas branch's blocks, maps rows back as it does and charges the same
    dispatch (bytes, shape key); codes and pks may be the device-resident
    tensors of a pack."""
    rng = np.random.default_rng(11)
    nq, n, m, k = (11, 2600, 8, 25) if case == "block_holes" \
        else (5, 1300, 16, 40)
    q = rng.normal(size=(nq, 4 * m)).astype(np.float32)
    codes, books = _make_pq(n, 4 * m, m, seed=4)
    pks = rng.permutation(n).astype(np.int64) * 3
    mask = rng.random((nq, n)) < 0.3
    if case == "block_holes":
        mask[:, 512:1536] = False
    elif case == "few_candidates":
        mask[:] = False
        mask[2, [3, 700, 1299]] = True
    elif case == "ties":
        codes[1::2] = codes[0::2][:len(codes[1::2])]
    b0 = r_ops.stats_snapshot()
    wd, wr = r_ops.quantized_scan_topk(q, codes, books, mask, pks, k,
                                       use_pallas=True)
    rd = _delta(r_ops.stats_snapshot, b0)
    lut = p_ops.adc_lut(q, books)
    c_in, p_in = codes, pks
    if case == "device_codes":
        c_in = torch.zeros((-(-n // BN) * BN, m), dtype=torch.uint8)
        c_in[:n] = torch.from_numpy(codes)
        p_in = torch.full((len(c_in),), 2**31 - 1, dtype=torch.int32)
        p_in[:n] = torch.from_numpy(pks.astype(np.int32))
    _, keep = p_ops.quantized_kernel_args(lut, c_in, mask, p_in, HOST)
    mp = np.zeros((nq, -(-n // BN) * BN), bool)
    mp[:, :n] = mask
    np.testing.assert_array_equal(
        keep, np.nonzero(mp.reshape(nq, -1, BN).any(axis=(0, 2)))[0])
    b1 = p_ops.stats_snapshot()
    gd, gr = p_ops._quantized_kernel(lut, c_in, mask, p_in, k, HOST)
    assert _delta(p_ops.stats_snapshot, b1) == rd
    np.testing.assert_array_equal(_bits(gd), _bits(wd))
    np.testing.assert_array_equal(gr, wr)


def test_ops_quantized_empty_inputs(fresh_shapes):
    codes, books = _make_pq(200, 32, 8, seed=4)
    q = np.zeros((2, 32), np.float32)
    pks = np.arange(200, dtype=np.int64)
    b0 = p_ops.stats_snapshot()
    _, rows = p_ops.quantized_scan_topk(q, codes, books,
                                        np.zeros((2, 200), bool), pks, 5,
                                        device="cpu")
    assert (rows == -1).all()
    _, rows = p_ops.quantized_scan_topk(
        q, np.zeros((0, 8), np.uint8), books, np.zeros((2, 0), bool),
        np.zeros(0, np.int64), 5, device="cpu")
    assert rows.shape == (2, 5) and (rows == -1).all()
    # nothing admitted: nothing dispatched, as in the reference
    assert _delta(p_ops.stats_snapshot, b0) == (0, 0, 0)


@pytest.mark.parametrize("n,m", [(700, 8), (2_000_000, 4)])
def test_pq_adc_distances_parity(fresh_shapes, n, m):
    """Host path (bitwise) and plain-version path (bitwise: both sum in j
    order) against the default backend, with equal accounting."""
    rng = np.random.default_rng(6)
    codes, books = _make_pq(n, 4 * m, m, seed=6)
    qv = rng.normal(size=4 * m).astype(np.float32)
    b0 = r_ops.stats_snapshot()
    want = r_ops.pq_adc_distances(qv, codes, books, use_pallas=False)
    rd = _delta(r_ops.stats_snapshot, b0)
    b1 = p_ops.stats_snapshot()
    got = p_ops.pq_adc_distances(qv, codes, books, device="cpu")
    assert _delta(p_ops.stats_snapshot, b1) == rd
    np.testing.assert_array_equal(_bits(got), _bits(want))


def test_pq_adc_padding_charged_once(fresh_shapes, monkeypatch):
    """The plain-version path and the card path pad the code matrix
    through the shared ``_pad_codes``, so their dispatch accounting
    (shape key and bytes) is the reference's whichever ran."""
    rng = np.random.default_rng(5)
    n, m = 700, 8                                     # odd n: real padding
    codes, books = _make_pq(n, 32, m, seed=5)
    qv = rng.normal(size=32).astype(np.float32)
    monkeypatch.setattr(p_ops, "HOST_FLOP_CUTOFF", 0)
    monkeypatch.setattr(r_ops, "HOST_FLOP_CUTOFF", 0)
    got = []
    for call in (lambda: p_ops.pq_adc_distances(qv, codes, books,
                                                device="cpu"),
                 lambda: p_ops._pq_adc_kernel(
                     codes, ((books - qv.reshape(m, 4)[:, None, :]) ** 2)
                     .sum(axis=2), HOST),
                 lambda: r_ops.pq_adc_distances(qv, codes, books,
                                                use_pallas=True)):
        snap = r_ops.stats_snapshot if len(got) == 2 else \
            p_ops.stats_snapshot
        b = snap()
        out = call()
        got.append((_delta(snap, b)[:2], out))
    assert got[0][0] == got[1][0] == got[2][0]
    assert got[0][0][1] == 4 * len(p_ops._pad_codes(codes, BN))
    for _, out in got[1:]:
        np.testing.assert_array_equal(_bits(out), _bits(got[0][1]))
    padded = p_ops._pad_codes(codes, BN)
    assert padded.dtype == np.uint8 and len(padded) % BN == 0


# ---------------------------------------------------------------------------
# engine level: recall-targeted TRACY templates through execute_many
# ---------------------------------------------------------------------------

CFG = tracy.TracyConfig(n_rows=1200, dim=32, seed=7, flush_rows=300,
                        fanout=64, pq_m=16)          # dsub=2 books


def _port_config(cfg):
    return PConfig(flush_rows=cfg.flush_rows, fanout=cfg.fanout,
                   pq_m=cfg.pq_m)


@pytest.fixture(scope="module")
def tracy_stores():
    ref, data = tracy.build_store(CFG)
    port = PStore(port_schema(CFG.dim), _port_config(CFG), device="cpu")
    replay = tracy.TracyData(CFG)           # the same seeded put stream
    done = 0
    while done < CFG.n_rows:
        n = min(CFG.flush_rows, 2048, CFG.n_rows - done)
        port.put(*replay.batch(n))
        done += n
    port.flush()
    converted = convert.store_from_arrays(
        port_schema(CFG.dim), [export(s) for s in ref.segments],
        _port_config(CFG), device="cpu", unique_pks=ref.unique_pks)
    return ref, data, {"put_stream": port, "converted": converted}


def _draw(data, seed, name, recall_target, n=8):
    """n reference queries of template ``name`` from a seeded draw."""
    data.rng = np.random.default_rng(seed)
    fns = dict(tracy.make_graph_templates(data, recall_target=recall_target))
    return [fns[name]() for _ in range(n)]


def _fresh():
    r_ops._seen_shapes.clear()
    p_ops._seen_shapes.clear()


@pytest.mark.parametrize("source", ["put_stream", "converted"])
@pytest.mark.parametrize("name", ["g6", "g8", "g13"])
def test_quantized_template_parity(tracy_stores, source, name):
    """pk, score, ExecStats (bytes_scanned at m bytes a row, rerank_rows,
    plan text) and plain EXPLAIN equal the reference's at
    recall_target=0.9, batched and solo."""
    ref, data, ports = tracy_stores
    r_ex, p_ex = RExecutor(ref), PExecutor(ports[source])
    rqs = _draw(data, 40, name, 0.9)
    pqs = [to_port(x) for x in rqs]
    _fresh()
    batch = p_ex.execute_many(pqs)
    assert_same(r_ex.execute_many(rqs), batch)
    _fresh()
    assert_same([r_ex.execute(rqs[0])], [p_ex.execute(pqs[0])])
    for r_q, p_q in zip(rqs[:2], pqs[:2]):
        r_plan, p_plan = r_ex.plan(r_q), p_ex.plan(p_q)
        assert (p_plan.kind, p_plan.quantized, p_plan.refine) == \
            (r_plan.kind, r_plan.quantized, r_plan.refine)
        assert p_plan.describe() == r_plan.describe()       # plain EXPLAIN
    st = batch[0][1]
    if name != "g8":
        assert "dispatch=quantized(pq m=16, refine=4)" in st.plan
        assert "QuantizedScanTopK" in st.plan
        assert st.rerank_rows > 0
        assert st.bytes_scanned == 16 * st.rows_scanned      # m bytes a row


def _results(pairs):
    return [[(r.pk, float(r.score)) for r in rows] for rows, _ in pairs]


@pytest.mark.parametrize("source", ["put_stream", "converted"])
def test_quantized_bitwise_identical_at_high_refine(tracy_stores, source):
    """With refine*k = 120 survivors the quantized answers equal the exact
    dispatch bitwise, in the port as in the reference."""
    ref, data, ports = tracy_stores
    p_ex = PExecutor(ports[source])
    r_ex = RExecutor(ref)
    for ti in range(3):
        rqa = _draw(data, 60 + ti, "g6", 0.9, n=4)
        rqb = _draw(data, 60 + ti, "g6", None, n=4)
        qa, qb = [to_port(x) for x in rqa], [to_port(x) for x in rqb]
        plans = [p_ex.plan(x) for x in qa]
        assert all(p.quantized for p in plans)
        for p in plans:
            p.refine = 12                            # k' = 120 <= KMAX
        quant = p_ex.execute_many(qa, plans=plans)
        exact = p_ex.execute_many(qb)
        assert _results(quant) == _results(exact)
        r_plans = [r_ex.plan(x) for x in rqa]
        for p in r_plans:
            p.refine = 12
        assert _results(quant) == _results(r_ex.execute_many(rqa,
                                                             plans=r_plans))
        for (_, sq), (_, se) in zip(quant, exact):
            assert sq.rerank_rows > 0 and se.rerank_rows == 0
            assert 0 < sq.bytes_scanned < se.bytes_scanned


def test_quantized_spatial_rank_plans_exact(tracy_stores):
    """A spatial rank column has no PQ codes: no quantized dispatch."""
    ref, _, ports = tracy_stores
    for ex, mod in ((PExecutor(ports["put_stream"]), pq),
                    (RExecutor(ref), rq)):
        sq = mod.HybridQuery(ranks=[mod.SpatialRank("coordinate", (5., 5.),
                                                    1.0)],
                             k=5, recall_target=0.9)
        assert not ex.plan(sq).quantized


def test_mixed_codebooks_fall_back_to_the_exact_scan():
    """One segment re-encoded under a foreign codebook set: the planner
    still picks the quantized dispatch (one m), ``pack_quantized`` refuses
    the mixed books and the operator scans exactly — in both packages,
    with equal answers and stats, on a put-stream and a converted store."""
    cfg = tracy.TracyConfig(n_rows=900, dim=32, seed=3, flush_rows=300,
                            fanout=64, pq_m=16)
    ref, data = tracy.build_store(cfg)
    port = PStore(port_schema(cfg.dim), _port_config(cfg), device="cpu")
    replay = tracy.TracyData(cfg)
    for _ in range(3):
        port.put(*replay.batch(300))
    port.flush()
    from repro.core import quantize as r_qz
    seg_r, seg_p = ref.segments[1], port.segments[1]
    vecs = np.asarray(seg_r.columns["embedding"], np.float32)
    seg_r.quantized["embedding"] = r_qz.quantize_column(vecs, m=16, seed=99)
    seg_p.quantized["embedding"] = p_qz.quantize_column(vecs, m=16, seed=99)
    seg_r.content_gen += 1
    seg_p.content_gen += 1
    converted = convert.store_from_arrays(
        port_schema(cfg.dim), [export(s) for s in ref.segments],
        _port_config(cfg), device="cpu", unique_pks=ref.unique_pks)
    rqs = _draw(data, 5, "g6", 0.9, n=4)
    r_out = RExecutor(ref).execute_many(rqs)
    assert "dispatch=quantized" in r_out[0][1].plan
    assert r_out[0][1].rerank_rows == 0              # exact fallback
    for store in (port, converted):
        assert p_seg.pack_quantized(store.segments, "embedding",
                                    HOST) is None
        _fresh()
        out = PExecutor(store).execute_many([to_port(x) for x in rqs])
        r_ops._seen_shapes.clear()
        assert_same(RExecutor(ref).execute_many(rqs), out)


def test_g6_recall_at_128d_matches_the_reference():
    """At the smoke's widths (128-d, pq_m 8) the quantized answers are the
    reference's, query by query, and so is their recall against the exact
    dispatch: what ``chip_smoke.py`` prints as recall is the codebooks'
    at this data, not the port's.  One query at a time keeps every
    distance below HOST_FLOP_CUTOFF (bitwise on both sides); run with -s
    to see the recall."""
    cfg = tracy.TracyConfig(n_rows=8192, dim=128, seed=7, flush_rows=2048,
                            fanout=4, pq_m=8)
    ref, data = tracy.build_store(cfg)
    port = PStore(port_schema(cfg.dim), _port_config(cfg), device="cpu")
    replay = tracy.TracyData(cfg)
    for _ in range(cfg.n_rows // 2048):
        port.put(*replay.batch(2048))
    port.flush()
    r_ex, p_ex = RExecutor(ref), PExecutor(port)
    quant = _draw(data, 5, "g6", 0.9, n=16)
    exact = _draw(data, 5, "g6", None, n=16)
    hits = 0
    for qa, qb in zip(quant, exact):
        _fresh()
        got = p_ex.execute(to_port(qa))
        assert_same([r_ex.execute(qa)], [got])
        assert "dispatch=quantized(pq m=8, refine=4)" in got[1].plan
        want = {r.pk for r in p_ex.execute(to_port(qb))[0]}
        hits += len({r.pk for r in got[0]} & want)
    print(f"g6 recall@10 at 128-d, pq_m 8, {cfg.n_rows} rows, 16 queries: "
          f"{hits / 160:.4f} (port and reference alike)")


def test_g6_recall_at_65536_rows_matches_the_reference():
    """At 65,536 rows, eight times the store above, recall@10 of g6 falls
    the same way in both packages, and each quantized answer holds the
    reference's pks in the reference's order.  Its scores agree within
    1e-5 of the score, not bitwise: the exact re-rank is now above
    HOST_FLOP_CUTOFF, where each package expands the distance through its
    own fp32 matrix product.  Run with -s to see the recall."""
    cfg = tracy.TracyConfig(n_rows=65536, dim=128, seed=7, flush_rows=2048,
                            fanout=4, pq_m=8)
    ref, data = tracy.build_store(cfg)
    port = PStore(port_schema(cfg.dim), _port_config(cfg), device="cpu")
    replay = tracy.TracyData(cfg)
    for _ in range(cfg.n_rows // 2048):
        port.put(*replay.batch(2048))
    port.flush()
    r_ex, p_ex = RExecutor(ref), PExecutor(port)
    quant = _draw(data, 5, "g6", 0.9, n=16)
    exact = _draw(data, 5, "g6", None, n=16)
    hits = {"reference": 0, "port": 0}
    for qa, qb in zip(quant, exact):
        _fresh()
        r_got = r_ex.execute(qa)
        p_got = p_ex.execute(to_port(qa))
        assert "dispatch=quantized(pq m=8, refine=4)" in p_got[1].plan
        assert [r.pk for r in p_got[0]] == [r.pk for r in r_got[0]]
        for a, b in zip(p_got[0], r_got[0]):
            assert abs(a.score - b.score) <= 1e-5 * abs(b.score)
        for name, ex, got, qq in (("reference", r_ex, r_got, qb),
                                  ("port", p_ex, p_got, to_port(qb))):
            want = {r.pk for r in ex.execute(qq)[0]}
            hits[name] += len({r.pk for r in got[0]} & want)
    assert hits["port"] == hits["reference"]
    print(f"g6 recall@10 at 128-d, pq_m 8, {cfg.n_rows} rows, 16 queries: "
          f"{hits['port'] / 160:.4f} (port and reference alike)")


# ---------------------------------------------------------------------------
# store level: a PQ-IVF store fed one put/update/delete stream
# ---------------------------------------------------------------------------

PQ_COLS = [("embedding", "VECTOR", 16, "PQIVF"),
           ("coordinate", "SPATIAL", 0, "ZORDER"),
           ("content", "TEXT", 0, "INVERTED"), ("time", "SCALAR", 0, "BTREE")]


def _pq_schemas():
    r = RSchema([RColumn(n, RType[t], dim=d, index=RKind[k])
                 for n, t, d, k in PQ_COLS])
    p = PSchema([PColumn(n, PType[t], dim=d, index=PKind[k])
                 for n, t, d, k in PQ_COLS])
    return r, p


@pytest.fixture(scope="module")
def pqivf_stores():
    rs, ps = _pq_schemas()
    ref = RStore(rs, RConfig(flush_rows=512, fanout=4, pq_m=4))
    port = PStore(ps, PConfig(flush_rows=512, fanout=4, pq_m=4),
                  device="cpu")
    ops = stream()
    feed(ref, ops)
    feed(port, ops)
    ref.flush()
    port.flush()
    return ref, port


def test_pqivf_store_layout_and_index_arrays(pqivf_stores):
    ref, port = pqivf_stores
    assert [(s.level, s.n_rows) for s in port.segments] == \
        [(s.level, s.n_rows) for s in ref.segments]
    assert port.metrics["compactions"] >= 1
    assert any(s.level >= 1 for s in port.segments)
    for rs, ps in zip(ref.segments, port.segments):
        np.testing.assert_array_equal(ps.pk, rs.pk)
        ra = rs.indexes["embedding"].to_arrays()
        pa = ps.indexes["embedding"].to_arrays()
        assert sorted(pa) == sorted(ra) and "codes" in pa \
            and "codebooks" in pa
        for key in ra:
            np.testing.assert_array_equal(pa[key], ra[key], err_msg=key)


def test_pqivf_merge_donates_codebooks():
    """Compaction keeps a part's codebooks bitwise (no retrain) and
    re-encodes the merged vectors under them, in posting-list order."""
    _, ps = _pq_schemas()
    rng = np.random.default_rng(21)
    store = PStore(ps, PConfig(flush_rows=150, fanout=3), device="cpu")
    for lo in (0, 150):
        store.put(*make_batch(rng, 150, pk_start=lo))
    part_books = [s.indexes["embedding"].codebooks.copy()
                  for s in store.segments]
    assert len(part_books) == 2
    store.put(*make_batch(rng, 150, pk_start=300))       # trips the fanout
    merged = [s for s in store.segments if s.level >= 1]
    assert len(merged) == 1 and store.metrics["index_merges"] > 0
    idx = merged[0].indexes["embedding"]
    assert any(np.array_equal(idx.codebooks, b) for b in part_books)
    vecs = np.asarray(merged[0].columns["embedding"],
                      np.float32)[idx.post_rows]
    m, _, dsub = idx.codebooks.shape
    expect = np.stack(
        [p_ops.assign_nearest(vecs[:, j * dsub:(j + 1) * dsub],
                              idx.codebooks[j], device="cpu")
         for j in range(m)], axis=1).astype(np.uint8)
    np.testing.assert_array_equal(idx.codes, expect)


@pytest.mark.parametrize("source", ["put_stream", "converted"])
@pytest.mark.parametrize("filtered", [False, True])
def test_pqivf_postfilter_nn_parity(pqivf_stores, source, filtered):
    """Forced ``postfilter_nn`` plans (the IVF-PQ probe: ADC over the
    probed lists, exact re-rank) answer as the reference does."""
    ref, port = pqivf_stores
    if source == "converted":
        _, ps = _pq_schemas()
        port = convert.store_from_arrays(
            ps, [export(s) for s in ref.segments],
            PConfig(flush_rows=512, fanout=4, pq_m=4), device="cpu",
            unique_pks=ref.unique_pks)
    rng = np.random.default_rng(1)
    r_ex, p_ex = RExecutor(ref), PExecutor(port)
    for _ in range(4):
        qv = rng.normal(size=16).astype(np.float32)
        where = [rq.Range("time", 0, 60)] if filtered else []
        ranks = [rq.VectorRank("embedding", qv, 1.0)]
        r_query = rq.HybridQuery(where=where or None, ranks=ranks, k=10)
        p_query = to_port(r_query)
        r_plan = r_planner.Plan(kind="postfilter_nn", residual=where,
                                ranks=ranks, k=10)
        p_plan = p_planner.Plan(kind="postfilter_nn",
                                residual=[to_port(w) for w in where],
                                ranks=list(p_query.ranks), k=10)
        _fresh()
        got = p_ex.execute(p_query, plan=p_plan)
        assert_same([r_ex.execute(r_query, plan=r_plan)], [got])
        assert len(got[0]) == 10


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.mark.gpu
def test_adc_kernels_match_plain_versions_on_the_card():
    """Each ADC kernel against its plain version on the card, bitwise."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    dev = torch.device("cuda")
    rng = np.random.default_rng(8)
    for nq, n, m in ((16, 1500, 8), (8, 513, 16), (3, 1, 4)):
        q = rng.normal(size=(nq, 4 * m)).astype(np.float32)
        codes, books = _make_pq(n, 4 * m, m, seed=9)
        mask = rng.random((nq, n)) < 0.5
        mask[0, 0] = True                     # a block is kept (n = 1 too)
        pks = rng.permutation(n).astype(np.int64)
        args, _ = p_ops.quantized_kernel_args(p_ops.adc_lut(q, books), codes,
                                              mask, pks, dev)
        card = [t.cpu().numpy() for t in p_qs.quantized_scan_topk(*args)]
        plain = [t.cpu().numpy() for t in p_qs.plain(*args[:5])]
        for a, b in zip(card, plain):
            np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32))
        ct = torch.from_numpy(codes).to(dev)
        lut = torch.from_numpy(
            (rng.normal(size=(m, 256)) ** 2).astype(np.float32)).to(dev)
        np.testing.assert_array_equal(
            _bits(p_pq.pq_adc(ct, lut).cpu().numpy()),
            _bits(p_ref.pq_adc_ref(ct, lut).cpu().numpy()))
