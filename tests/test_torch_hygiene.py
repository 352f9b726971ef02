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
from repro_torch.kernels import bitmap_filter, fused_scan, ivf_scan
from repro_torch.kernels import ops, pq_adc, quantized_scan

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
            "import repro_torch.core.nra, repro_torch.convert\n"
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
    _no_card(monkeypatch)
    schema = Schema([Column("v", ColumnType.VECTOR, dim=4,
                            index=IndexKind.IVF)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LSMStore(schema)
    assert LSMStore(schema, device="cpu").device.type == "cpu"


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
                                                 np.arange(3), 2)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert ops.l2_distances(x, x, device="cpu").shape == (3, 3)


def test_unported_paths_raise():
    from repro_torch.core.index import default_index_factory
    from repro_torch.core.lsm import LSMConfig
    for kind in (IndexKind.GRAPH,):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            default_index_factory(Column("v", ColumnType.VECTOR, dim=4,
                                         index=kind))
    schema = Schema([Column("t", ColumnType.SCALAR)])
    with pytest.raises(NotImplementedError, match="item 9"):
        LSMStore(schema, LSMConfig(path="somewhere"), device="cpu")


@pytest.mark.gpu
def test_wrappers_launch_on_the_card_and_count():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    dev = torch.device("cuda")
    kernels = (ivf_scan, bitmap_filter, quantized_scan, pq_adc)
    before = [k.launches.value for k in kernels]
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
    torch.cuda.synchronize()
    assert [k.launches.value for k in kernels] == [b + 1 for b in before]
    assert fused_scan.launches.value >= 0


def test_cpu_tensors_take_the_plain_versions_without_counting():
    kernels = (ivf_scan, bitmap_filter, fused_scan, quantized_scan, pq_adc)
    before = [k.launches.value for k in kernels]
    q = torch.ones((8, 4))
    ivf_scan.ivf_scan(q, q)
    bitmap_filter.bitmap_filter(q, torch.zeros((4, 2)))
    codes = torch.zeros((512, 2), dtype=torch.uint8)
    pq_adc.pq_adc(codes, torch.ones((2, 256)))
    quantized_scan.quantized_scan_topk(
        torch.ones((8, 512)), codes, torch.ones((8, 512), dtype=torch.uint8),
        torch.arange(512, dtype=torch.int32),
        torch.zeros(1, dtype=torch.int32), torch.ones((1, 1), dtype=torch.int32))
    assert [k.launches.value for k in kernels] == before


def test_new_wrappers_raise_for_a_device_without_a_kernel():
    """The ADC wrappers launch for a CUDA tensor, take the plain version
    for a CPU tensor and refuse any other device: no quiet fallback."""
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
