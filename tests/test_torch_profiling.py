"""The port's profiling and export tooling (utils/profiling.py), the 2-D CLI's
--compile-only, --export, --trace-dir, --cache-dir and --debug-nans, the
export pair with cli/lbm_runner.py, and the blur's --compile-only/--export.

After tests/test_profiling.py and tests/test_cli.py: the exported plain step
serves two obstacle files, each bit-equal to `--engine torch` on the same
mask and within 4e-4 of the JAX package's exported step run by its runner;
a grid or device the export was not made for is refused. Params and obstacle
files are written into tmp_path from numpy seeds.
"""

import io as io_lib
import json
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from lbm_tpu_torch.cli import blur as blur_cli
from lbm_tpu_torch.cli import lbm as cli
from lbm_tpu_torch.cli import lbm_runner
from lbm_tpu_torch.core import io, state
from lbm_tpu_torch.core.params import Obstacles, Params
from lbm_tpu_torch.models import lbm as lbm_model
from lbm_tpu_torch.ops import _build, d2q9, d2q9_kstep, stencil
from lbm_tpu_torch.utils import image as img_lib
from lbm_tpu_torch.utils import native_io, profiling


def write_case(tmp_path, ny=16, nx=32, n=12, seed=0, name="o.dat"):
    p = Params(nx=nx, ny=ny, max_iters=n, reynolds_dim=10, density=0.1, accel=0.005,
               omega=1.85)
    p.to_file(tmp_path / "p.params")
    mask = np.random.default_rng(seed).random((ny, nx)) < 0.08
    Obstacles(mask).to_file(tmp_path / name)
    return p, mask


def files(tmp_path, obstacles="o.dat"):
    return ["--params", str(tmp_path / "p.params"), "--obstacles", str(tmp_path / obstacles)]


def test_timed_prints():
    buf = io_lib.StringIO()
    with profiling.timed("thing", file=buf):
        pass
    assert re.fullmatch(r"thing took \d+\.\d{4}s\n", buf.getvalue())


def test_trace_on_the_cpu_names_the_plain_step(tmp_path, capsys):
    write_case(tmp_path)
    assert cli.main(files(tmp_path) + ["--device", "cpu", "--engine", "torch", "--num-steps",
                                       "3", "--trace-dir", str(tmp_path / "trace"),
                                       "--out-dir", str(tmp_path / "out")]) == 0
    trace = tmp_path / "trace" / profiling.TRACE_FILE
    assert f"wrote {trace}" in capsys.readouterr().out
    names = {e.get("name") for e in json.loads(trace.read_text())["traceEvents"]}
    assert {"aten::roll", "aten::where", "aten::sqrt", profiling.TIMED_RUN} <= names
    summary = profiling.kernel_summary(trace)
    # no device on the CPU: nothing launched, no idle share to speak of
    assert summary["kernels"] == {} and summary["idle_share"] is None
    assert summary["window_us"] > 0


def test_kernel_summary_counts_the_timed_runs_launches(tmp_path):
    def span(name, cat, ts, dur, corr=None):
        return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
                **({"args": {"correlation": corr}} if corr is not None else {})}

    events = [
        span("kstep_box_kernel", "kernel", 5, 10, 1),  # the warm-up's: outside the range
        span("cudaLaunchKernel", "cuda_runtime", 1, 2, 1),
        span(profiling.TIMED_RUN, "user_annotation", 100, 60),
        span("cudaLaunchKernel", "cuda_runtime", 101, 2, 2),
        span("cudaLaunchKernel", "cuda_runtime", 104, 2, 3),
        span("cudaMemsetAsync", "cuda_runtime", 106, 1, 4),
        span("kstep_box_kernel", "kernel", 110, 20, 2),
        span("kstep_box_kernel", "kernel", 130, 20, 3),
        span("Memset (Device)", "gpu_memset", 125, 10, 4),  # overlaps the first kernel
    ]
    (tmp_path / "t.json").write_text(json.dumps({"traceEvents": events}))
    s = profiling.kernel_summary(tmp_path / "t.json")
    assert s["kernels"] == {"kstep_box_kernel": {"launches": 2, "device_us": 40.0}}
    assert s["device_events"] == 3 and s["window_us"] == 60.0 and s["busy_us"] == 40.0
    assert s["idle_share"] == pytest.approx(1 / 3)


def test_dump_graph_and_operation_count(tmp_path):
    p, _ = write_case(tmp_path)
    f0, mask = state.to_torch(state.initial_distributions(p, np.float32),
                              np.zeros((p.ny, p.nx), bool), device="cpu")
    text = profiling.dump_graph(d2q9.Step(p), f0, mask, path=tmp_path / "g.txt")
    assert "aten.roll" in text and (tmp_path / "g.txt").read_text() == text
    assert profiling.operation_count(profiling.export(d2q9.Step(p), f0, mask)) > 100


def test_set_build_dir_is_keyed_by_host(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "BUILD_DIR", _build.BUILD_DIR)
    monkeypatch.setattr(native_io, "BUILD_DIR", native_io.BUILD_DIR)
    fp = profiling.host_fingerprint()
    assert re.fullmatch(r"[0-9a-f]{12}", fp) and fp == profiling.host_fingerprint()
    got = profiling.set_build_dir(tmp_path / "cache")
    assert got == tmp_path / "cache" / f"host-{fp}" and got.is_dir()
    assert _build.BUILD_DIR == got and native_io.BUILD_DIR == got / "native"
    assert _build.library_path("d2q9_kstep").parent == got
    assert profiling.set_build_dir(tmp_path / "flat", per_host=False) == tmp_path / "flat"


def test_device_memory_stats_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    assert profiling.device_memory_stats() == {}


def test_cli_cache_dir_builds_the_native_library_there(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(_build, "BUILD_DIR", _build.BUILD_DIR)
    monkeypatch.setattr(native_io, "BUILD_DIR", native_io.BUILD_DIR)
    monkeypatch.setattr(native_io, "_LOADED", None)
    monkeypatch.setattr(native_io, "last_build_error", None)
    write_case(tmp_path, n=2)
    assert cli.main(files(tmp_path) + ["--engine", "native", "--cache-dir",
                                       str(tmp_path / "cache"), "--out-dir",
                                       str(tmp_path / "out")]) == 0
    built = list((tmp_path / "cache").glob("host-*/native/liblbmio_*.so"))
    assert len(built) == 1 and "build directory:" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# --debug-nans
# ---------------------------------------------------------------------------


@pytest.fixture
def nan_debugging():
    previous = profiling.enable_nan_debugging(True)
    yield
    profiling.enable_nan_debugging(previous)


def one_nan(p, dtype=np.float32, initial=state.initial_distributions):
    f = initial(p, dtype)
    f[2, 3, 5] = np.nan
    return f


def test_a_nan_raises_at_step_1_of_the_torch_engine(tmp_path, nan_debugging):
    p, mask = write_case(tmp_path)
    f, m = state.to_torch(one_nan(p), mask, device="cpu")
    amask = d2q9.accel_row_mask(p.ny, p.nx, p.ny - 2)
    with pytest.raises(FloatingPointError, match="after step 1 of the torch engine"):
        d2q9.run(f, m, amask, num_steps=5, omega=1.85, accel_w1=1e-4, accel_w2=2.5e-5)
    with pytest.raises(FloatingPointError, match="after steps 1-4 of a K-step pass"):
        d2q9_kstep.run(f, m, num_steps=8, k_steps=4, omega=1.85, accel_w1=1e-4,
                       accel_w2=2.5e-5, accel_row=p.ny - 2)


@pytest.mark.parametrize("engine,where", [("torch", "step 1 of the torch engine"),
                                          ("cuda", "steps 1-4 of a K-step pass"),
                                          ("native", "steps 1-12 of the native engine")])
def test_cli_debug_nans_raises_on_a_seeded_nan(tmp_path, monkeypatch, engine, where):
    write_case(tmp_path)
    monkeypatch.setattr(state, "initial_distributions", lambda p, dtype: one_nan(p, dtype))
    argv = files(tmp_path) + ["--device", "cpu", "--engine", engine, "--out-dir",
                              str(tmp_path / "out"), "--debug-nans"]
    with pytest.raises(FloatingPointError, match=where):
        cli.main(argv)
    assert not profiling.NAN_DEBUG  # the CLI restores the setting
    assert cli.main(argv[:-1]) == 0  # without the flag the NaN just runs on


@pytest.mark.parametrize("engine", ["torch", "cuda-inplace"])
def test_cli_debug_nans_leaves_the_run_bit_equal(tmp_path, engine):
    write_case(tmp_path)
    argv = files(tmp_path) + ["--device", "cpu", "--engine", engine]
    assert cli.main(argv + ["--out-dir", str(tmp_path / "a")]) == 0
    assert cli.main(argv + ["--out-dir", str(tmp_path / "b"), "--debug-nans"]) == 0
    for name in ("av_vels.dat", "final_state.dat"):
        assert (tmp_path / "a" / name).read_bytes() == (tmp_path / "b" / name).read_bytes()


# ---------------------------------------------------------------------------
# the export pair: cli.lbm --compile-only --export, then cli.lbm_runner
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("export")
    write_case(tmp, seed=0)
    # a second obstacle file of the same grid
    write_case(tmp, seed=1, name="o2.dat")
    buf = io_lib.StringIO()
    import contextlib

    with contextlib.redirect_stdout(buf):
        # no --obstacles: the mask is an input of the exported step
        rc = cli.main(["--params", str(tmp / "p.params"), "--device", "cpu", "--compile-only",
                       "--export", str(tmp / "step.pt2")])
    assert rc == 0
    return tmp, buf.getvalue()


def test_compile_only_exports_without_obstacles(exported):
    tmp, text = exported
    assert (tmp / "step.pt2").stat().st_size > 0
    count = int(re.search(r"ops\.d2q9\.Step on cpu, \(9, 16, 32\) float32, (\d+) operations",
                          text).group(1))
    assert count == profiling.operation_count(profiling.load_step(tmp / "step.pt2")) > 100
    assert re.search(rf"exported {(tmp / 'step.pt2').stat().st_size} bytes to ", text)


@pytest.mark.parametrize("obstacles", ["o.dat", "o2.dat"])
def test_runner_is_bit_equal_to_the_torch_engine(exported, obstacles):
    tmp, _ = exported
    out = tmp / f"run_{obstacles}"
    assert lbm_runner.main(["--exe", str(tmp / "step.pt2"), *files(tmp, obstacles), "--device",
                            "cpu", "--out-dir", str(out / "runner")]) == 0
    assert cli.main(files(tmp, obstacles) + ["--device", "cpu", "--engine", "torch",
                                             "--out-dir", str(out / "torch")]) == 0
    for name in ("av_vels.dat", "final_state.dat"):
        assert (out / "runner" / name).read_bytes() == (out / "torch" / name).read_bytes()


def test_one_export_serves_two_obstacle_files_like_the_jax_runner(exported):
    from lbm_tpu.cli import lbm as ref_cli
    from lbm_tpu.cli import lbm_runner as ref_runner

    tmp, _ = exported
    assert ref_cli.main(["--params", str(tmp / "p.params"), "--device", "cpu", "--compile-only",
                         "--export", str(tmp / "step.jaxexe")]) == 0
    avs = {}
    for obstacles in ("o.dat", "o2.dat"):
        out = tmp / f"pair_{obstacles}"
        assert lbm_runner.main(["--exe", str(tmp / "step.pt2"), *files(tmp, obstacles),
                                "--device", "cpu", "--out-dir", str(out / "port")]) == 0
        assert ref_runner.main(["--exe", str(tmp / "step.jaxexe"), *files(tmp, obstacles),
                                "--device", "cpu", "--out-dir", str(out / "jax")]) == 0
        got, want = (io.read_av_vels(out / d / "av_vels.dat") for d in ("port", "jax"))
        np.testing.assert_allclose(got, want, rtol=4e-4)
        avs[obstacles] = got
    assert not np.array_equal(avs["o.dat"], avs["o2.dat"])  # the mask is an input


def test_runner_refuses_another_grid_and_another_device(exported, tmp_path, monkeypatch, capsys):
    tmp, _ = exported
    write_case(tmp_path, ny=16, nx=40)
    with pytest.raises(SystemExit):
        lbm_runner.main(["--exe", str(tmp / "step.pt2"), *files(tmp_path), "--device", "cpu"])
    assert "exported for a (9, ny, nx) = (9, 16, 32) state" in capsys.readouterr().err
    # a step exported on the CPU is never moved to the card
    monkeypatch.setattr(lbm_model, "resolve_device", lambda device=None: torch.device("cuda"))
    with pytest.raises(SystemExit):
        lbm_runner.main(["--exe", str(tmp / "step.pt2"), *files(tmp), "--device", "cuda"])
    assert "exported on cpu and this run is on cuda" in capsys.readouterr().err


@pytest.mark.parametrize("argv,message", [
    (["--export", "x.pt2"], "--export applies to --compile-only"),
    ([], "--obstacles is required unless --compile-only")])
def test_cli_rejects_export_without_compile_only(tmp_path, capsys, argv, message):
    write_case(tmp_path)
    with pytest.raises(SystemExit):
        cli.main(["--params", str(tmp_path / "p.params"), "--device", "cpu", *argv])
    assert message in capsys.readouterr().err


# ---------------------------------------------------------------------------
# the blur's --compile-only / --export
# ---------------------------------------------------------------------------


def test_blur_export_writes_a_file_that_blurs_like_the_conv_engine(tmp_path, capsys):
    rgba = np.random.default_rng(4).integers(0, 256, size=(20, 30, 4), dtype=np.uint8)
    img_lib.save_png(tmp_path / "in.png", rgba)
    assert blur_cli.main(["-i", str(tmp_path / "in.png"), "--device", "cpu", "--compile-only",
                          "--export", str(tmp_path / "pass.pt2")]) == 0
    assert "ops.stencil.blur_step_conv on cpu, (4, 32, 128) float32" in capsys.readouterr().out
    fimg = img_lib.to_float_image(rgba)
    padded, interior, _ = img_lib.pad_to_tile(fimg.intensities, row_mult=32)
    x, inter = torch.from_numpy(padded), torch.from_numpy(interior)
    got = profiling.load_step(tmp_path / "pass.pt2").module()(x, inter)
    assert torch.equal(got, stencil.blur_step_conv(x, inter))
