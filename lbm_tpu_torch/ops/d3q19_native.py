"""ctypes bindings for the native serial D3Q19 engine (native/d3q19_serial.cpp).

The counterpart of `lbm_tpu.ops.d3q19_native` and the 3-D sibling of
`d2q9_native`: the independent host oracle of the D3Q19 engines, in the
'paired' grouping of `ops/d3q19.py`. Runs on the host and never consults
CUDA; numpy and ctypes only.
"""

from __future__ import annotations

import ctypes

import numpy as np

from ..utils import native_io
from .d2q9_native import host_array

_F64P = ctypes.POINTER(ctypes.c_double)
_F32P = ctypes.POINTER(ctypes.c_float)
_U8P = ctypes.POINTER(ctypes.c_ubyte)


def _engine_lib():
    nio = native_io.load()
    if nio is None:
        return None
    lib = nio._lib
    if not getattr(lib, "_d3q19_typed", False):
        for suffix, fp, ct in (("f64", _F64P, ctypes.c_double),
                               ("f32", _F32P, ctypes.c_float)):
            fn = getattr(lib, f"d3q19_run_{suffix}")
            fn.restype = None
            fn.argtypes = [fp, fp, _U8P, ctypes.c_long, ctypes.c_long,
                           ctypes.c_long, ctypes.c_long, ct, ct, ct,
                           ctypes.c_long, _F64P]
        lib._d3q19_typed = True
    return lib


def available() -> bool:
    return _engine_lib() is not None


def require():
    """The engine's library, or RuntimeError naming why it cannot build."""
    lib = _engine_lib()
    if lib is None:
        raise RuntimeError(
            "native D3Q19 engine unavailable: it is built from native/*.cpp with g++ into "
            f"{native_io.BUILD_DIR} on first use (needs a C++ toolchain); use --engine torch "
            f"otherwise ({native_io.last_build_error})")
    return lib


def run(f: np.ndarray, mask: np.ndarray, *, num_steps: int, omega: float,
        density: float, accel: float, accel_plane: int) -> np.ndarray:
    """`num_steps` timesteps in place on `f` (contiguous (19, nz, ny, nx));
    returns the per-step tot_u (float64). Chunked calls are bit-identical to
    one combined call."""
    if not isinstance(f, np.ndarray):
        raise TypeError(f"the native engine advances a numpy array in place, not {type(f)}; "
                        "simulate() takes a tensor")
    if f.dtype == np.float64:
        suffix, fp = "f64", _F64P
    elif f.dtype == np.float32:
        suffix, fp = "f32", _F32P
    else:
        raise ValueError(f"native engine supports float32/float64, not {f.dtype}")
    if f.ndim != 4 or f.shape[0] != 19 or f.shape[1:] != np.shape(mask):
        raise ValueError(f"f shape {f.shape} does not match mask {np.shape(mask)}")
    if not f.flags.c_contiguous:
        raise ValueError("f must be C-contiguous (it is advanced in place)")
    lib = require()
    obs = np.ascontiguousarray(mask, np.uint8)
    scratch = np.empty_like(f)
    tot_u = np.empty(num_steps, np.float64)
    getattr(lib, f"d3q19_run_{suffix}")(
        f.ctypes.data_as(fp), scratch.ctypes.data_as(fp),
        obs.ctypes.data_as(_U8P), f.shape[1], f.shape[2], f.shape[3],
        num_steps, omega, density, accel, accel_plane,
        tot_u.ctypes.data_as(_F64P))
    return tot_u


def simulate(nz: int, ny: int, nx: int, *, num_steps: int,
             omega: float = 1.85, density: float = 0.1, accel: float = 0.005,
             obstacle_mask=None, dtype=np.float64):
    """The contract of `ops.d3q19.simulate` (walls at z = 0 and nz-1 by
    default, the accelerated plane at nz-2) on the native engine, from the
    state at rest. Returns (f_final, av_vels) as numpy arrays, av_vels
    divided in the state's type and returned as float64."""
    from . import d3q19_lattice

    f = d3q19_lattice.initial_distributions(nz, ny, nx, density, np.dtype(dtype).type)
    if obstacle_mask is None:
        obstacle_mask = np.zeros((nz, ny, nx), bool)
        obstacle_mask[0] = True
        obstacle_mask[-1] = True
    mask = np.asarray(host_array(obstacle_mask), bool)
    tot = run(f, mask, num_steps=num_steps, omega=omega, density=density,
              accel=accel, accel_plane=nz - 2)
    num_free = f.dtype.type((~mask).sum())
    return f, (tot.astype(f.dtype) / num_free).astype(np.float64)
