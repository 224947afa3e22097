"""Builds and loads the port's CUDA kernels.

The sources under `lbm_tpu_torch/csrc/` are compiled at first use with nvcc
into a shared library with a plain C interface (route (b): no PyTorch
headers, so a build takes seconds), under `build/lbm_tpu_torch/` beside the
package, and loaded with ctypes. The library's name carries a hash of the
source and the flags, so an edited source is rebuilt. Nothing here runs at
import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "lbm_tpu_torch"

# -fmad=false: every product and sum rounds on its own, as in collide_fields.
# The plain version on CUDA still differs by about 1e-6 relative in float32,
# since PyTorch divides by a Python scalar as a multiply by its reciprocal.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-fmad=false")

_P = ctypes.c_void_p
_I = ctypes.c_int
_D = ctypes.c_double
_SCALARS = [_I] * 12 + [_D, _D, _D, _P]  # ny .. accel_row, omega, w1, w2, stream
SIGNATURES = {
    "d2q9_kstep_f32": [_P] * 5 + _SCALARS,
    "d2q9_kstep_f64": [_P] * 5 + _SCALARS,
    "d2q9_kstep_inplace_f32": [_P] * 4 + [_I] + [_P] * 4 + _SCALARS,
    "d2q9_kstep_inplace_f64": [_P] * 4 + [_I] + [_P] * 4 + _SCALARS,
}

SOURCE = CSRC_DIR / "d2q9_kstep.cu"
_LIB: ctypes.CDLL | None = None


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError("nvcc not found (on PATH or under $CUDA_HOME/bin): "
                       "the CUDA kernels cannot be built")


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{SOURCE.stem}_{digest}.so"


def build() -> Path:
    """Compile csrc/d2q9_kstep.cu unless its current library exists;
    returns the library's path."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, str(SOURCE)]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed ({res.returncode}): {' '.join(cmd)}\n"
                               f"{res.stdout}{res.stderr}")
        os.replace(tmp, out)  # atomic: a concurrent build never sees half a file
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def load() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build()))
        for fn, argtypes in SIGNATURES.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        _LIB = lib
    return _LIB
