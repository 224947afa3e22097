"""The port's native I/O (utils/native_io.py) and its fast paths in
core/io.py and core/params.py, after tests/test_native_io.py.

final_state.dat and av_vels.dat are byte-identical to `lbm_tpu.core.io`'s
for the same arrays, through the native writer and through the Python
fallback; the native obstacle reader equals the Python reader and refuses
what it refuses; a writer that fails raises OSError. The port's build writes
its library under its own build directory, named by a hash of the sources,
and leaves `native/` as it found it.
"""

import os
from pathlib import Path

import numpy as np
import pytest

from lbm_tpu.core import io as ref_io
from lbm_tpu_torch.core import io, state
from lbm_tpu_torch.core.params import Obstacles, Params
from lbm_tpu_torch.utils import native_io


@pytest.fixture(scope="module")
def native():
    lib = native_io.load()
    if lib is None:
        pytest.skip(f"no C++ toolchain: {native_io.last_build_error}")
    return lib


def fields(seed, ny=16, nx=32):
    rng = np.random.default_rng(seed)
    p = Params(nx=nx, ny=ny, max_iters=1, reynolds_dim=10, density=0.1, accel=0.005, omega=1.85)
    f = state.initial_distributions(p, np.float64) + rng.uniform(0, 0.01, (9, ny, nx))
    mask = rng.random((ny, nx)) < 0.2
    return p, mask, f


@pytest.mark.parametrize("path", ["native", "python"])
def test_final_state_byte_identical_to_the_reference(tmp_path, native, monkeypatch, path):
    p, mask, f = fields(5)
    ref_io.write_final_state(tmp_path / "ref.dat", p, mask, f)
    if path == "python":
        monkeypatch.setattr(io, "_try_native", lambda: None)
    else:
        assert io._try_native() is not None
    io.write_final_state(tmp_path / "port.dat", p, mask, f)
    assert (tmp_path / "port.dat").read_bytes() == (tmp_path / "ref.dat").read_bytes()


def test_final_state_arrays_native_and_python_byte_identical(tmp_path, native, monkeypatch):
    rng = np.random.default_rng(3)
    arrays = [rng.standard_normal((5, 7)) for _ in range(4)]
    obs = rng.random((5, 7)) < 0.3
    native.write_final_state(str(tmp_path / "n.dat"), *arrays, obs)
    monkeypatch.setattr(io, "_try_native", lambda: None)
    io.write_final_state_arrays(tmp_path / "p.dat", *arrays, obs)
    ref_io.write_final_state_arrays(tmp_path / "r.dat", *arrays, obs)
    assert (tmp_path / "n.dat").read_bytes() == (tmp_path / "p.dat").read_bytes()
    assert (tmp_path / "n.dat").read_bytes() == (tmp_path / "r.dat").read_bytes()


@pytest.mark.parametrize("seed", [0, 1])
def test_av_vels_byte_identical_to_the_reference(tmp_path, native, seed):
    vals = np.random.default_rng(seed).uniform(1e-6, 1e-3, 100)
    native.write_av_vels(str(tmp_path / "native.dat"), vals)
    io.write_av_vels(tmp_path / "port.dat", vals)
    ref_io.write_av_vels(tmp_path / "ref.dat", vals)
    assert (tmp_path / "native.dat").read_bytes() == (tmp_path / "ref.dat").read_bytes()
    assert (tmp_path / "port.dat").read_bytes() == (tmp_path / "ref.dat").read_bytes()


def test_read_obstacles_equals_the_python_reader(tmp_path, native, monkeypatch):
    p, mask, _ = fields(7, ny=40, nx=24)
    Obstacles(mask).to_file(tmp_path / "o.dat")
    got = native.read_obstacles(str(tmp_path / "o.dat"), p.ny, p.nx)
    assert np.array_equal(got, mask)
    assert np.array_equal(Obstacles.from_file(tmp_path / "o.dat", p).mask, mask)
    monkeypatch.setattr(native_io, "load", lambda auto_build=True: None)
    assert np.array_equal(Obstacles.from_file(tmp_path / "o.dat", p).mask, mask)


@pytest.mark.parametrize("text,message", [("99 0 1\n", "x-coord out of range"),
                                          ("0 0 1 1 1 1\n", "3 values per obstacle line"),
                                          ("1 1 2\n", "blocked value should be 1")])
def test_read_obstacles_rejections(tmp_path, native, text, message):
    (tmp_path / "bad.dat").write_text(text)
    with pytest.raises(ValueError):
        native.read_obstacles(str(tmp_path / "bad.dat"), 4, 4)
    # the loader falls through to the Python reader for its precise message
    p = Params(nx=4, ny=4, max_iters=1, reynolds_dim=10, density=0.1, accel=0.005, omega=1.85)
    with pytest.raises(ValueError, match=message):
        Obstacles.from_file(tmp_path / "bad.dat", p)


def test_a_failing_native_writer_raises(tmp_path, native):
    missing = tmp_path / "no" / "such" / "dir"
    assert io._try_native() is not None
    with pytest.raises(OSError, match="native write_av_vels failed"):
        io.write_av_vels(missing / "av_vels.dat", np.ones(3))
    with pytest.raises(OSError, match="native write_final_state failed"):
        io.write_final_state_arrays(missing / "fs.dat", *[np.zeros((2, 2))] * 4,
                                    np.zeros((2, 2), bool))


def snapshot(directory: Path) -> dict:
    # liblbmio.so is the reference's own build (`make -C native`), which
    # its tests may run at any time
    return {p.name: (p.read_bytes(), p.stat().st_mtime_ns) for p in directory.iterdir()
            if p.name != "liblbmio.so"}


def test_the_build_leaves_native_as_it_found_it(tmp_path, monkeypatch):
    before = snapshot(native_io.NATIVE_DIR)
    monkeypatch.setattr(native_io, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native_io, "last_build_error", None)
    monkeypatch.setattr(native_io, "_LOADED", None)
    if not native_io.build():
        pytest.skip(f"no C++ toolchain: {native_io.last_build_error}")
    out = native_io.library_path()
    assert out.parent == tmp_path / "build" and out.exists()
    assert out.name.startswith("liblbmio_") and out.suffix == ".so"
    assert sorted(os.listdir(tmp_path / "build")) == [out.name]  # no temporary left
    assert native_io.load() is not None and native_io.build()  # built once
    assert snapshot(native_io.NATIVE_DIR) == before
    # the name follows the sources and the flags
    monkeypatch.setattr(native_io, "CXXFLAGS", native_io.CXXFLAGS + ("-DLBM_NAME_TEST",))
    assert native_io.library_path() != out
