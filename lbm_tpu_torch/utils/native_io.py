"""ctypes bindings for the native host library: the exact-format writers
and reader of `native/lbmio.cpp` and the serial engines of
`native/d2q9_serial.cpp` and `native/d3q19_serial.cpp`.

The counterpart of `lbm_tpu.utils.native_io`. The library is built at first
use with g++ from the three sources of `native/`, with the flags of
`native/Makefile` (so the bits are those of that Makefile's library), into
`build/lbm_tpu_torch/native/` beside the package. Nothing is ever written
into `native/`. The library's name carries a hash of the sources, the
compiler and the flags, so an edited source is rebuilt; it is written to a
temporary file and renamed into place, so concurrent builds never see half a
file. Callers fall back to the pure-Python writers when it cannot load.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path

import numpy as np

PACKAGE_DIR = Path(__file__).resolve().parent.parent
NATIVE_DIR = PACKAGE_DIR.parent / "native"
SOURCES = ("lbmio.cpp", "d2q9_serial.cpp", "d3q19_serial.cpp")
BUILD_DIR = PACKAGE_DIR.parent / "build" / "lbm_tpu_torch" / "native"
# native/Makefile: CXXFLAGS ?= -O3 -fPIC -Wall -Wextra, linked with -shared
CXXFLAGS = ("-O3", "-fPIC", "-Wall", "-Wextra", "-shared")

_U8P = ctypes.POINTER(ctypes.c_ubyte)
_F64P = ctypes.POINTER(ctypes.c_double)


class NativeIO:
    def __init__(self, lib: ctypes.CDLL):
        self._lib = lib
        lib.lbmio_write_final_state.restype = ctypes.c_int
        lib.lbmio_write_av_vels.restype = ctypes.c_int
        lib.lbmio_read_obstacles.restype = ctypes.c_long

    def write_final_state(self, path: str, u_x, u_y, u, pressure, obstacle) -> None:
        ny, nx = obstacle.shape
        arrs = [np.ascontiguousarray(a, dtype=np.float64) for a in (u_x, u_y, u, pressure)]
        obs = np.ascontiguousarray(obstacle, dtype=np.uint8)
        ret = self._lib.lbmio_write_final_state(
            str(path).encode(), *(a.ctypes.data_as(_F64P) for a in arrs),
            obs.ctypes.data_as(_U8P), ctypes.c_long(ny), ctypes.c_long(nx))
        if ret != 0:
            raise OSError(f"native write_final_state failed for {path}")

    def write_av_vels(self, path: str, vals) -> None:
        v = np.ascontiguousarray(vals, dtype=np.float64)
        ret = self._lib.lbmio_write_av_vels(str(path).encode(), v.ctypes.data_as(_F64P),
                                            ctypes.c_long(v.size))
        if ret != 0:
            raise OSError(f"native write_av_vels failed for {path}")

    def read_obstacles(self, path: str, ny: int, nx: int) -> np.ndarray:
        mask = np.zeros((ny, nx), dtype=np.uint8)
        count = self._lib.lbmio_read_obstacles(str(path).encode(), mask.ctypes.data_as(_U8P),
                                               ctypes.c_long(ny), ctypes.c_long(nx))
        if count < 0:
            raise ValueError(f"native read_obstacles failed for {path}")
        return mask.astype(bool)


def compiler() -> str:
    return os.environ.get("CXX", "g++")


def library_path() -> Path:
    digest = hashlib.sha256(b"".join((NATIVE_DIR / s).read_bytes() for s in SOURCES)
                            + " ".join((compiler(), *CXXFLAGS)).encode()).hexdigest()[:16]
    return BUILD_DIR / f"liblbmio_{digest}.so"


# why the last build failed, for the engines' error message
last_build_error: str | None = None


def build() -> bool:
    """Compile the library unless its current build exists; True on success."""
    global last_build_error
    try:
        out = library_path()
    except OSError as err:  # the sources are not there
        last_build_error = str(err)
        return False
    if out.exists():
        return True
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [compiler(), *CXXFLAGS, "-o", tmp, *(str(NATIVE_DIR / s) for s in SOURCES)]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
        if res.returncode != 0:
            last_build_error = f"{' '.join(cmd)} failed ({res.returncode}):\n{res.stderr}"
            return False
        os.replace(tmp, out)  # atomic: a concurrent build never sees half a file
        return True
    except (OSError, subprocess.SubprocessError) as err:  # no compiler, or it hung
        last_build_error = f"{' '.join(cmd)}: {err}"
        return False
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


_LOADED: NativeIO | None = None


def load(auto_build: bool = True) -> NativeIO | None:
    """The loaded library, built first if auto_build; None when it cannot
    be built or loaded. Memoised once loaded."""
    global _LOADED, last_build_error
    if _LOADED is None:
        try:
            path = library_path()
        except OSError as err:
            last_build_error = str(err)
            return None
        # a failed build is not retried in this process
        if not path.exists() and not (auto_build and last_build_error is None and build()):
            return None
        try:
            _LOADED = NativeIO(ctypes.CDLL(str(path)))
        except OSError as err:
            last_build_error = str(err)
    return _LOADED
