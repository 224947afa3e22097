"""Builds and loads the port's CUDA kernels.

Each source under `lbm_tpu_torch/csrc/` is compiled at first use with nvcc
into a shared library of its own with a plain C interface (no PyTorch
headers, so a build takes seconds), under `build/lbm_tpu_torch/`
beside the package, and loaded with ctypes. A library's name carries a hash
of its source, the headers of `csrc/` and the flags, so an edited source is
rebuilt and the others are not. Nothing here runs at import time.
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
_U = ctypes.c_uint
_D = ctypes.c_double
# d2q9_kstep.cu and d2q9_manual.cu: ny .. accel_row, mode, omega, w1, w2, stream
_D2Q9_SCALARS = [_I] * 13 + [_D, _D, _D, _P]
# d3q19_kstep.cu: nz .. accel_plane, six collision coefficients, stream
_D3Q19_SCALARS = [_I] * 14 + [_D] * 6 + [_P]
# d3q19_blocked.cu: mode, path, nz .. tile, threads, k .. accel_plane, six
# coefficients, stream
_D3Q19_BLOCKED_SCALARS = [_I] * 17 + [_D] * 6 + [_P]
# stencil.cu: image, interior, out, then c, h, w and each kernel's own ints
_STENCIL_K = [_P] * 3 + [_I] * 7 + [_P]
# the resident entries: image, interior, out, xrow, xcol, then c .. num_passes,
# k, tag0, threads, stream (blur_resident_opt.cu's take h0 and w0 too)
_STENCIL_RESIDENT = [_P] * 5 + [_I] * 7 + [_U, _I, _P]
_BLUR_RESIDENT_OPT = [_P] * 5 + [_I] * 9 + [_U, _I, _P]
# argument types of every C entry point, by source (the file's stem)
SIGNATURES = {
    "d2q9_kstep": {  # ... partials, tot, path, then the scalars
        "d2q9_kstep_f32": [_P] * 5 + [_I] + _D2Q9_SCALARS,
        "d2q9_kstep_f64": [_P] * 5 + [_I] + _D2Q9_SCALARS,
        "d2q9_kstep_inplace_f32": [_P] * 4 + [_I] + [_P] * 4 + [_I] + _D2Q9_SCALARS,
        "d2q9_kstep_inplace_f64": [_P] * 4 + [_I] + [_P] * 4 + [_I] + _D2Q9_SCALARS,
        "d2q9_kstep_blocks": [_I] * 6,
    },
    "d2q9_manual": {  # ... partials, tot, path, then the scalars
        "d2q9_manual_f32": [_P] * 5 + [_I] + _D2Q9_SCALARS,
        "d2q9_manual_f64": [_P] * 5 + [_I] + _D2Q9_SCALARS,
        "d2q9_manual_blocks": [_I] * 8,
    },
    "copy_floor": {
        "copy_floor_run": [_P] * 4,  # plan: 10 ints (ops/copy_floor.py)
        "copy_floor_tma_blocks": [_I] * 5,
    },
    "overlap_probe": {
        "overlap_auto": [_P] * 4 + [_I] * 10 + [_P],
        "overlap_manual": [_P] * 2 + [_I] * 10 + [_P],
        "overlap_auto_blocks": [_I] * 4,
        "overlap_manual_blocks": [_I] * 6,
    },
    "d3q19_kstep": {
        "d3q19_kstep_f32": [_P] * 6 + _D3Q19_SCALARS,
        "d3q19_kstep_f64": [_P] * 6 + _D3Q19_SCALARS,
        "d3q19_kstep_inplace_f32": [_P] * 4 + _D3Q19_SCALARS,
        "d3q19_kstep_inplace_f64": [_P] * 4 + _D3Q19_SCALARS,
    },
    "d3q19_blocked": {
        "d3q19_blocked_f32": [_P] * 5 + _D3Q19_BLOCKED_SCALARS,
        "d3q19_blocked_f64": [_P] * 5 + _D3Q19_BLOCKED_SCALARS,
        "d3q19_blocked_inplace_f32": [_P] * 6 + _D3Q19_BLOCKED_SCALARS,
        "d3q19_blocked_inplace_f64": [_P] * 6 + _D3Q19_BLOCKED_SCALARS,
    },
    "stencil": {
        "stencil_step_f32": [_P] * 3 + [_I] * 3 + [_P],
        "stencil_step_bf16": [_P] * 3 + [_I] * 3 + [_P],
        "stencil_k_f32": _STENCIL_K,
        "stencil_k_bf16": _STENCIL_K,
        "stencil_resident_f32": _STENCIL_RESIDENT,
        "stencil_resident_bf16": _STENCIL_RESIDENT,
    },
    "blur_resident_opt": {
        f"blur_resident_opt_{instance}_{io}": _BLUR_RESIDENT_OPT
        for instance in ("v0", "v2", "v3", "v4", "v5", "v6", "v7") for io in ("f32", "bf16")
    },
}

_LIBS: dict[str, ctypes.CDLL] = {}


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


def source_path(name: str) -> Path:
    if name not in SIGNATURES:
        raise ValueError(f"unknown kernel source {name!r}; choose from {sorted(SIGNATURES)}")
    return CSRC_DIR / f"{name}.cu"


def library_path(name: str) -> Path:
    source = source_path(name)
    headers = b"".join(h.read_bytes() for h in sorted(CSRC_DIR.glob("*.cuh")))
    digest = hashlib.sha256(source.read_bytes() + headers
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}_{digest}.so"


def _start_build(name: str):
    """Start nvcc on csrc/<name>.cu unless its current library exists.
    Returns (library path, temporary output, running process or None)."""
    out = library_path(name)
    if out.exists():
        return out, None, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, str(source_path(name))]
    try:
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    except BaseException:
        os.unlink(tmp)
        raise
    return out, tmp, proc


def _finish_build(out: Path, tmp: str | None, proc) -> Path:
    if proc is None:
        return out
    try:
        stdout, stderr = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(proc.args)}\n"
                               f"{stdout}{stderr}")
        os.replace(tmp, out)  # atomic: a concurrent build never sees half a file
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def build(name: str) -> Path:
    """Compile csrc/<name>.cu unless its current library exists; returns the
    library's path."""
    return _finish_build(*_start_build(name))


def build_all() -> dict[str, Path]:
    """Compile every source that needs it, one nvcc each, all started
    together. Returns {source name: library path}."""
    started = {name: _start_build(name) for name in SIGNATURES}
    paths, errors = {}, []
    for name, job in started.items():  # wait for every process before raising
        try:
            paths[name] = _finish_build(*job)
        except RuntimeError as err:
            errors.append(str(err))
    if errors:
        raise RuntimeError("\n".join(errors))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build(name)))
        for fn, argtypes in SIGNATURES[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        _LIBS[name] = lib
    return lib
