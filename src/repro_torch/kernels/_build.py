"""Build the CUDA sources in ``csrc/`` into one shared library and load it.

``nvcc`` compiles every ``.cu`` file in one call for ``sm_90a`` into
``_build/libsa_kernels_<hash>.so``, the hash taken over the sources and the
flags, so an edit rebuilds and an unchanged tree reuses the library.  The
build runs at first use, never at import: the CPU tests import every
module of the package and have no ``nvcc``.  The library has a plain C
interface and is bound with ``ctypes``.

No ``--use_fast_math``: Schwefel's ``sin(sqrt|x|)`` needs the IEEE
``sinf``.  ``-fmad=false`` keeps products and sums rounded one by one, as
PyTorch's elementwise ops round them.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

CSRC = Path(__file__).parent / "csrc"
BUILD_DIR = Path(__file__).parent / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_U = ctypes.c_uint32
_F = ctypes.c_float
_SIGNATURES = {
    "sa_metropolis_sweep": [_P, _P, _P, _P, _I, _P, _U, _P, _U, _P, _F, _P, _P,
                            _P, _I, _I, _I, _I, _I, _P, _P],
    "sa_argmin_reduce": [_P, _I, _I, _I, _P, _I, _P, _P, _P],
    "sa_qap_sweep": [_P, _P, _P, _P, _P, _I, _I, _P, _F, _P, _U, _P, _U, _P,
                     _P, _I, _I, _I, _I, _P],
    "sa_qap_max_n": [],
}

_lib = None
build_seconds = None  # wall time of the build (or load) in this process
#: nvcc builds and ctypes.CDLL loads in this process (the service's
#: telemetry reads it as ``sa_kernel_builds_total``).
builds_and_loads = 0


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    cus, cuhs = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in cus + cuhs:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"libsa_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library unless the one for these sources exists."""
    global builds_and_loads
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cus, _ = _sources()
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *map(str, cus)]
    builds_and_loads += 1
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n"
                f"{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, out)  # atomic: a reader never sees a partial .so
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib, build_seconds, builds_and_loads
    if _lib is None:
        t0 = time.perf_counter()
        handle = ctypes.CDLL(str(build()))
        builds_and_loads += 1
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = handle
        build_seconds = time.perf_counter() - t0
    return _lib


def check(rc: int, name: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {rc}")
