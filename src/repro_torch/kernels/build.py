"""Build and load the hand-written CUDA kernels under ``csrc/``.

Each ``csrc/<name>.cu`` exposes plain C launchers (``SIGNATURES``) and
is compiled by ``nvcc`` for ``sm_90a`` into its own shared library,
loaded with ``ctypes``; ``csrc/*.cuh`` are headers the sources share.  Builds happen
at first use (or all at once, in parallel, through ``build_all``) into
``_build/`` next to this file, named by a hash of the source, the headers
and the flags so an edited source is rebuilt.  Nothing is built or
imported when the package is imported: the CPU tests import every module
of the port on a machine without ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List

_HERE = Path(__file__).resolve().parent
CSRC = _HERE / "csrc"
BUILD_DIR = _HERE / "_build"
SOURCES = ("fused_scan", "ivf_scan", "bitmap_filter", "quantized_scan",
           "pq_adc", "topk_merge", "graph_search")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
# C signatures of each library's launchers (every one returns a
# cudaError_t as int)
SIGNATURES = {
    "fused_scan": {"fused_scan_topk_launch":
                   [_P] * 16 + [_I, _I, _L, _I, _I, _L, _P]},
    "ivf_scan": {"ivf_scan_launch": [_P, _P, _P, _I, _I, _I, _I, _L, _P]},
    "bitmap_filter": {"bitmap_filter_launch":
                      [_P, _P, _P, _L, _I, _I, _P],
                      "bitmap_filter_blocks_launch":
                      [_P] * 5 + [_L, _I, _I, _I, _L, _I, _P]},
    "quantized_scan": {"quantized_scan_topk_launch":
                       [_P] * 17 + [_I, _I, _L, _I, _I, _I, _L, _P]},
    "pq_adc": {"pq_adc_launch": [_P, _P, _P, _L, _I, _P]},
    "topk_merge": {"batched_topk_merge_launch":
                   [_P, _P, _P, _P, _I, _L, _I, _L, _P],
                   "topk_merge_launch":
                   [_P, _P, _P, _P, _L, _I, _I, _L, _P]},
    "graph_search": {"graph_search_topk_launch":
                     [_P] * 10 + [_I, _I, _L] + [_I] * 7 + [_L, _P]},
}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
BUILD_LOG: Dict[str, str] = {}     # name -> nvcc's ptxas report


class LaunchCount:
    """Launches of one hand-written kernel: its wrapper adds one each time
    the kernel is launched, and nowhere else."""

    def __init__(self) -> None:
        self._n = 0
        self._lock = threading.Lock()

    def add(self) -> None:
        with self._lock:
            self._n += 1

    @property
    def value(self) -> int:
        return self._n

    def reset(self) -> None:
        with self._lock:
            self._n = 0


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels "
                       "are built from csrc/ at first use")


def _target(name: str) -> Path:
    """The library of ``name``, named by a hash of its source, the shared
    headers and the flags."""
    src = (CSRC / f"{name}.cu").read_bytes()
    src += b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    tag = hashlib.sha1(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"{name}-{tag}.so"


def _compile(name: str, out: Path):
    """Start ``nvcc`` for one source; returns (process, temp path)."""
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp


def _bind(name: str, path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    for fn_name, argtypes in SIGNATURES[name].items():
        fn = getattr(lib, fn_name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def build_all(names: List[str] = None) -> Dict[str, ctypes.CDLL]:
    """Compile every missing library at once (one ``nvcc`` per source,
    all started together) and load them."""
    names = list(names or SOURCES)
    with _lock:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        todo = [n for n in names if n not in _libs]
        procs = {n: _compile(n, _target(n)) for n in todo
                 if not _target(n).exists()}
        failed = []
        for n, (proc, tmp) in procs.items():
            log, _ = proc.communicate()     # wait for every build
            BUILD_LOG[n] = log
            if proc.returncode != 0:
                failed.append(f"nvcc failed for {n}.cu:\n{log}")
            else:
                os.replace(tmp, _target(n))
        if failed:
            raise RuntimeError("\n".join(failed))
        for n in todo:
            _libs[n] = _bind(n, _target(n))
        return {n: _libs[n] for n in names}


def launcher(name: str, fn: str = None):
    """The C launcher ``fn`` of library ``name`` (by default its only
    one), building the library on first use."""
    lib = _libs.get(name) or build_all([name])[name]
    if fn is None:
        (fn,) = SIGNATURES[name]
    return getattr(lib, fn)


# Shared memory one block may opt in to on compute capability 9.0, the
# only architecture the kernels are built for (``-arch=sm_90a``).
SM90_SMEM_OPTIN = 232_448


def smem_per_block(device) -> int:
    """Dynamic shared memory one block may opt in to on ``device``: the
    wrappers refuse a launch that needs more.  A CPU tensor takes the
    sm_90 value, so the plain path refuses what the card would."""
    import torch
    device = torch.device(device)
    if device.type != "cuda":
        return SM90_SMEM_OPTIN
    return torch.cuda.get_device_properties(
        device).shared_memory_per_block_optin


def sm_count(device) -> int:
    """Streaming multiprocessors of ``device``: the wrappers size their
    grids from it."""
    import torch
    return torch.cuda.get_device_properties(device).multi_processor_count


def check(err: int, name: str) -> None:
    """Raise if a launch was refused: a refused launch never runs, and
    ``torch.cuda.synchronize()`` would not report it."""
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError_t {err}")
