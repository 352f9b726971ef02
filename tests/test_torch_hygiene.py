"""Hygiene of the port: ``repro_torch`` imports neither JAX nor the JAX
package, and its entry points run on the card unless asked for the CPU."""
import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core.lsm import LSMStore
from repro_torch.core.types import Column, ColumnType, IndexKind, Schema
from repro_torch.kernels import bitmap_filter, fused_scan, graph_search
from repro_torch.kernels import ivf_scan, ops, pq_adc, quantized_scan
from repro_torch.kernels import topk_merge

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported_roots(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield node.lineno, a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, (node.module or "").split(".")[0]


def test_port_sources_import_no_jax_and_no_reference():
    files = sorted(PORT.rglob("*.py"))
    assert len(files) > 30
    bad = []
    for f in files:
        tree = ast.parse(f.read_text(), filename=str(f))
        bad += [f"{f.relative_to(ROOT)}:{ln} imports {mod}"
                for ln, mod in _imported_roots(tree) if mod in FORBIDDEN]
        # no attribute access on a name `jax` either (jax.numpy etc.)
        bad += [f"{f.relative_to(ROOT)}:{n.lineno} uses jax.*"
                for n in ast.walk(tree) if isinstance(n, ast.Attribute)
                and isinstance(n.value, ast.Name) and n.value.id == "jax"]
    assert not bad, "\n".join(bad)


def test_importing_the_slice_loads_no_jax_or_reference():
    code = ("import sys\n"
            "import repro_torch.core.executor, repro_torch.core.lsm\n"
            "import repro_torch.core.api, repro_torch.core.manifest\n"
            "import repro_torch.core.nra, repro_torch.convert\n"
            "import repro_torch.core.shards, repro_torch.core.index.graph\n"
            "import repro_torch.analysis.plan_validator\n"
            "import repro_torch.kernels.ops, repro_torch.obs\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]\n"
            "print(','.join(bad))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == ""


def _no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_store_raises_without_a_card(monkeypatch):
    from repro_torch.core.api import Database
    from repro_torch.core.shards import ShardRouter
    _no_card(monkeypatch)
    schema = Schema([Column("v", ColumnType.VECTOR, dim=4,
                            index=IndexKind.IVF)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LSMStore(schema)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ShardRouter(schema, n_shards=2)
    assert LSMStore(schema, device="cpu").device.type == "cpu"
    router = ShardRouter(schema, n_shards=2, device="cpu")
    assert {sh.device.type for sh in router.shards} == {"cpu"}
    for shards in (1, 2):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Database(schema, shards=shards)
        db = Database(schema, shards=shards, device="cpu")
        assert db.table().store.device.type == "cpu"


def test_ops_raise_without_a_card(monkeypatch):
    _no_card(monkeypatch)
    x = np.ones((3, 2), np.float32)
    books = np.zeros((2, 256, 1), np.float32)
    codes = np.zeros((3, 2), np.uint8)
    for call in (lambda: ops.l2_distances(x, x),
                 lambda: ops.assign_nearest(x, x),
                 lambda: ops.rect_filter(x, (0, 0, 1, 1)),
                 lambda: ops.range_bitmap(x, np.zeros((2, 2))),
                 lambda: ops.pq_adc_distances(x[0], codes, books),
                 lambda: ops.quantized_scan_topk(x, codes, books,
                                                 np.ones((3, 3), bool),
                                                 np.arange(3), 2),
                 lambda: ops.merge_topk_batch(np.ones((1, 2, 2)),
                                              np.ones((1, 2, 2)), 2),
                 lambda: ops.merge_topk(np.ones((2, 2)), np.ones((2, 2)), 2),
                 lambda: ops.graph_search_topk(
                     x, x, np.zeros((3, 2), np.int32), np.arange(1),
                     np.ones((3, 3), bool), np.arange(3), 4, 2)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert ops.l2_distances(x, x, device="cpu").shape == (3, 3)


def test_unported_paths_raise():
    """Durability is not ported: a store or a router given a path, the
    router's snapshot, fault arming and acknowledgement frontiers, and the
    facade's ``Database(path=...)``, ``snapshot`` and ``restore`` raise and
    name the ROADMAP item.  (``IndexKind.GRAPH`` builds now.)"""
    from repro_torch.core.api import Database
    from repro_torch.core.index import GraphIndex, default_index_factory
    from repro_torch.core.lsm import LSMConfig
    from repro_torch.core.shards import ShardRouter
    assert isinstance(default_index_factory(Column(
        "v", ColumnType.VECTOR, dim=4, index=IndexKind.GRAPH)), GraphIndex)
    schema = Schema([Column("t", ColumnType.SCALAR)])
    with pytest.raises(NotImplementedError, match="item 6"):
        LSMStore(schema, LSMConfig(path="somewhere"), device="cpu")
    with pytest.raises(NotImplementedError, match="item 6"):
        ShardRouter(schema, LSMConfig(path="somewhere"), device="cpu")
    router = ShardRouter(schema, device="cpu")
    db = Database(schema, device="cpu")
    for call in (lambda: router.snapshot("somewhere"),
                 lambda: router.set_faults(None),
                 router.durable_seqnos,
                 lambda: Database(schema, path="somewhere", device="cpu"),
                 lambda: Database(path="somewhere"),
                 lambda: Database.restore("somewhere"),
                 lambda: db.snapshot("somewhere")):
        with pytest.raises(NotImplementedError, match="item 6"):
            call()


@pytest.mark.gpu
def test_wrappers_launch_on_the_card_and_count():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    dev = torch.device("cuda")
    counts = (ivf_scan.launches, bitmap_filter.launches,
              quantized_scan.launches, pq_adc.launches,
              topk_merge.batched_launches, topk_merge.launches,
              graph_search.launches)
    before = [c.value for c in counts]
    q = torch.ones((8, 4), device=dev)
    ivf_scan.ivf_scan(q, q)
    bitmap_filter.bitmap_filter(q, torch.zeros((4, 2), device=dev))
    codes = torch.zeros((512, 2), dtype=torch.uint8, device=dev)
    pq_adc.pq_adc(codes, torch.ones((2, 256), device=dev))
    quantized_scan.quantized_scan_topk(
        torch.ones((8, 512), device=dev), codes,
        torch.ones((8, 512), dtype=torch.uint8, device=dev),
        torch.arange(512, dtype=torch.int32, device=dev),
        torch.zeros(1, dtype=torch.int32, device=dev),
        torch.ones((1, 1), dtype=torch.int32, device=dev))
    topk_merge.batched_topk_merge(
        torch.ones((2, 3, 4), device=dev),
        torch.zeros((2, 3, 4), dtype=torch.int32, device=dev), 5)
    topk_merge.topk_merge(torch.ones((3, 4), device=dev),
                          torch.zeros((3, 4), dtype=torch.int64, device=dev),
                          5)
    graph_search.graph_search_topk(
        torch.ones((8, 4), device=dev), torch.ones((64, 4), device=dev),
        torch.full((64, 2), -1, dtype=torch.int32, device=dev),
        torch.zeros((1, 8), dtype=torch.int32, device=dev),
        torch.ones((8, 64), dtype=torch.uint8, device=dev),
        torch.arange(64, dtype=torch.int32, device=dev)[None], 4, 2)
    torch.cuda.synchronize()
    assert [c.value for c in counts] == [b + 1 for b in before]
    assert fused_scan.launches.value >= 0


def test_cpu_tensors_take_the_plain_versions_without_counting():
    counts = (ivf_scan.launches, bitmap_filter.launches, fused_scan.launches,
              quantized_scan.launches, pq_adc.launches,
              topk_merge.batched_launches, topk_merge.launches,
              graph_search.launches)
    before = [c.value for c in counts]
    q = torch.ones((8, 4))
    ivf_scan.ivf_scan(q, q)
    bitmap_filter.bitmap_filter(q, torch.zeros((4, 2)))
    codes = torch.zeros((512, 2), dtype=torch.uint8)
    pq_adc.pq_adc(codes, torch.ones((2, 256)))
    quantized_scan.quantized_scan_topk(
        torch.ones((8, 512)), codes, torch.ones((8, 512), dtype=torch.uint8),
        torch.arange(512, dtype=torch.int32),
        torch.zeros(1, dtype=torch.int32), torch.ones((1, 1), dtype=torch.int32))
    topk_merge.batched_topk_merge(torch.ones((2, 3, 4)),
                                  torch.zeros((2, 3, 4), dtype=torch.int32), 5)
    topk_merge.topk_merge(torch.ones((3, 4)),
                          torch.zeros((3, 4), dtype=torch.int64), 5)
    graph_search.graph_search_topk(
        torch.ones((8, 4)), torch.ones((64, 4)),
        torch.full((64, 2), -1, dtype=torch.int32),
        torch.zeros((1, 8), dtype=torch.int32),
        torch.ones((8, 64), dtype=torch.uint8),
        torch.arange(64, dtype=torch.int32)[None], 4, 2)
    assert [c.value for c in counts] == before


def test_new_wrappers_raise_for_a_device_without_a_kernel():
    """The ADC, merge and beam-search wrappers launch for a CUDA tensor,
    take the plain version for a CPU tensor and refuse any other device:
    no quiet fallback."""
    codes = torch.zeros((512, 2), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        pq_adc.pq_adc(codes, torch.ones((2, 256), device="meta"))
    with pytest.raises(ValueError, match="no kernel"):
        quantized_scan.quantized_scan_topk(
            torch.ones((8, 512), device="meta"), codes,
            torch.ones((8, 512), dtype=torch.uint8, device="meta"),
            torch.zeros(512, dtype=torch.int32, device="meta"),
            torch.zeros(1, dtype=torch.int32, device="meta"),
            torch.ones((1, 1), dtype=torch.int32, device="meta"))
    meta = {"device": "meta"}
    with pytest.raises(ValueError, match="no kernel"):
        topk_merge.batched_topk_merge(
            torch.ones((2, 3, 4), **meta),
            torch.zeros((2, 3, 4), dtype=torch.int32, **meta), 5)
    with pytest.raises(ValueError, match="no kernel"):
        topk_merge.topk_merge(torch.ones((3, 4), **meta),
                              torch.zeros((3, 4), dtype=torch.int64, **meta),
                              5)
    with pytest.raises(ValueError, match="no kernel"):
        graph_search.graph_search_topk(
            torch.ones((8, 4), **meta), torch.ones((64, 4), **meta),
            torch.full((64, 2), -1, dtype=torch.int32, **meta),
            torch.zeros((1, 8), dtype=torch.int32, **meta),
            torch.ones((8, 64), dtype=torch.uint8, **meta),
            torch.zeros((1, 64), dtype=torch.int32, **meta), 4, 2)
