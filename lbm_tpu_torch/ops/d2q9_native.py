"""ctypes bindings for the native serial D2Q9 engine (native/d2q9_serial.cpp).

The counterpart of `lbm_tpu.ops.d2q9_native`: the independent host oracle,
a plain serial C++ loop with the expression grouping of `ops/d2q9.py` (so
float32 runs land in the same rounding class as the other engines), built
with the native I/O library (`utils.native_io`). It runs on the host:
choosing it is asking for the host, so it never consults CUDA. numpy and
ctypes only; a torch tensor handed to `simulate` is copied to a numpy array
on the host once, at entry. Raises RuntimeError when the library cannot be
built (`available()` lets callers and tests skip).
"""

from __future__ import annotations

import ctypes

import numpy as np

from ..core.params import Params
from ..utils import native_io

_F64P = ctypes.POINTER(ctypes.c_double)
_F32P = ctypes.POINTER(ctypes.c_float)
_U8P = ctypes.POINTER(ctypes.c_ubyte)


def _engine_lib():
    nio = native_io.load()
    if nio is None:
        return None
    lib = nio._lib
    if not getattr(lib, "_d2q9_typed", False):
        for suffix, fp, ct in (("f64", _F64P, ctypes.c_double),
                               ("f32", _F32P, ctypes.c_float)):
            run = getattr(lib, f"d2q9_run_{suffix}")
            run.restype = None
            run.argtypes = [fp, fp, _U8P, ctypes.c_long, ctypes.c_long,
                            ctypes.c_long, ct, ct, ct, ctypes.c_long, _F64P]
            fa = getattr(lib, f"d2q9_first_accelerate_{suffix}")
            fa.restype = None
            fa.argtypes = [fp, _U8P, ctypes.c_long, ctypes.c_long,
                           ctypes.c_long, ct, ct]
        lib._d2q9_typed = True
    return lib


def available() -> bool:
    return _engine_lib() is not None


def require():
    """The engine's library, or RuntimeError naming why it cannot build."""
    lib = _engine_lib()
    if lib is None:
        raise RuntimeError(
            "native D2Q9 engine unavailable: it is built from native/*.cpp with g++ into "
            f"{native_io.BUILD_DIR} on first use (needs a C++ toolchain); use --engine torch "
            f"otherwise ({native_io.last_build_error})")
    return lib


def _check(f, mask):
    if not isinstance(f, np.ndarray):
        raise TypeError(f"the native engine advances a numpy array in place, not {type(f)}; "
                        "simulate() takes a tensor")
    if f.dtype == np.float64:
        suffix, fp = "f64", _F64P
    elif f.dtype == np.float32:
        suffix, fp = "f32", _F32P
    else:
        raise ValueError(f"native engine supports float32/float64, not {f.dtype}")
    if f.ndim != 3 or f.shape[0] != 9 or f.shape[1:] != np.shape(mask):
        raise ValueError(f"f shape {f.shape} does not match mask {np.shape(mask)}")
    if not f.flags.c_contiguous:
        raise ValueError("f must be C-contiguous (it is advanced in place)")
    return suffix, fp


def first_accelerate(f: np.ndarray, mask: np.ndarray, *, accel_row: int,
                     accel_w1: float, accel_w2: float) -> None:
    """In-place guarded acceleration of `accel_row` (f: contiguous (9, ny, nx))."""
    suffix, fp = _check(f, mask)
    lib = require()
    obs = np.ascontiguousarray(mask, np.uint8)
    getattr(lib, f"d2q9_first_accelerate_{suffix}")(
        f.ctypes.data_as(fp), obs.ctypes.data_as(_U8P),
        f.shape[1], f.shape[2], accel_row, accel_w1, accel_w2)


def run(f: np.ndarray, mask: np.ndarray, *, num_steps: int, omega: float,
        accel_w1: float, accel_w2: float, accel_row: int) -> np.ndarray:
    """`num_steps` timesteps in place on `f`; returns the per-step tot_u
    (float64). Chunked calls are bit-identical to one call of the combined
    length: no state crosses steps but `f` itself."""
    suffix, fp = _check(f, mask)
    lib = require()
    obs = np.ascontiguousarray(mask, np.uint8)
    scratch = np.empty_like(f)
    tot_u = np.empty(num_steps, np.float64)
    getattr(lib, f"d2q9_run_{suffix}")(
        f.ctypes.data_as(fp), scratch.ctypes.data_as(fp),
        obs.ctypes.data_as(_U8P), f.shape[1], f.shape[2], num_steps,
        omega, accel_w1, accel_w2, accel_row, tot_u.ctypes.data_as(_F64P))
    return tot_u


def host_array(x) -> np.ndarray:
    """A numpy copy on the host of a numpy array or a torch tensor."""
    if hasattr(x, "detach"):  # a torch tensor, on any device
        x = x.detach().cpu().numpy()
    return np.array(x, order="C", copy=True)


def simulate(params: Params, f, mask):
    """The whole run of `ops.d2q9.simulate` on the native engine: first
    accelerate, then max_iters steps. Returns (f_final, av_vels) as numpy
    arrays; av_vels is divided by the free-cell count in the state's type
    (as the other engines divide) and returned as float64. `f` (a numpy
    array or a tensor) is not changed."""
    from .d2q9 import AccelWeights

    aw = AccelWeights.from_params(params)
    accel_row = params.ny - 2
    f = host_array(f)
    mask = np.asarray(host_array(mask), bool)
    first_accelerate(f, mask, accel_row=accel_row, accel_w1=aw.w1, accel_w2=aw.w2)
    tot_u = run(f, mask, num_steps=params.max_iters, omega=params.omega,
                accel_w1=aw.w1, accel_w2=aw.w2, accel_row=accel_row)
    num_free = f.dtype.type((~mask).sum())
    return f, (tot_u.astype(f.dtype) / num_free).astype(np.float64)
