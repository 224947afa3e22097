"""The port stands alone and runs on the card unless asked otherwise.

* Importing every module of lbm_tpu_torch, in a fresh interpreter (this
  process has JAX loaded by tests/conftest.py), loads neither `jax` nor any
  `lbm_tpu` module; chip_smoke.py imports neither, and without a card it
  exits non-zero and prints no result.
* The entry points default to CUDA: on a host without it, run_simulation()
  and the CLI given no device raise instead of running on the CPU.
* A kernel wrapper given a tensor that is not on the CPU launches its kernel
  or raises; it never returns the plain result.
"""

import ast
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from lbm_tpu_torch.core import state
from lbm_tpu_torch.core.params import Obstacles, Params
from lbm_tpu_torch.models import blur, lbm
from lbm_tpu_torch.ops import (blur_resident_opt, copy_floor, d2q9_kstep, d2q9_kstep_inplace,
                               d2q9_kstep_manual, overlap_probe, stencil)

REPO = Path(__file__).resolve().parent.parent
KW = dict(k_steps=2, omega=1.85, accel_w1=1e-4, accel_w2=2.5e-5, accel_row=6)

IMPORT_ALL = """
import importlib, json, pkgutil, sys
import lbm_tpu_torch
names = [m.name for m in pkgutil.walk_packages(lbm_tpu_torch.__path__, "lbm_tpu_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith(("jax.", "lbm_tpu.")) or m == "lbm_tpu")
print(json.dumps({"modules": names, "bad": bad}))
"""


def test_port_imports_no_jax_and_no_lbm_tpu():
    res = subprocess.run([sys.executable, "-c", IMPORT_ALL], capture_output=True, text=True,
                         cwd=REPO, timeout=120)
    assert res.returncode == 0, res.stderr
    out = json.loads(res.stdout.strip().splitlines()[-1])
    for name in ("ops.d2q9_kstep_inplace", "ops.d3q19", "ops.d3q19_lattice", "ops.d3q19_kstep",
                 "ops.d3q19_kstep_inplace", "ops.d3q19_kstep_blocked",
                 "ops.d3q19_kstep_inplace_blocked", "ops._build", "core.checkpoint", "models.lbm3d",
                 "cli.lbm", "cli.lbm3d", "utils.image", "ops.stencil", "models.blur",
                 "cli.blur", "ops.d2q9_kstep_manual", "ops.copy_floor", "ops.overlap_probe",
                 "parallel.mesh", "parallel.partition", "parallel.launch", "parallel.halo",
                 "parallel.kstep_sharded", "parallel.kstep_sharded_3d", "dryrun",
                 "ops.d2q9_native", "ops.d3q19_native", "utils.native_io", "utils.profiling",
                 "utils.roll_slices", "cli.lbm_runner", "cli.halo_bench", "cli.partition_stats",
                 "cli.viz_partition", "cli.flow_viz"):
        assert f"lbm_tpu_torch.{name}" in out["modules"]
    assert out["bad"] == []


def imported_modules(path):
    """Every module a Python source imports, at any depth of its code."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module)
    return names


def test_chip_smoke_imports_no_jax_and_no_lbm_tpu():
    names = imported_modules(REPO / "chip_smoke.py")
    assert any(n.startswith("lbm_tpu_torch") for n in names)
    bad = sorted(n for n in names
                 if n.split(".")[0] in ("jax", "jaxlib", "lbm_tpu"))
    assert bad == []
    # every source of the port, and the overlap probes' harness, read the same way
    for path in [*(REPO / "lbm_tpu_torch").rglob("*.py"),
                 REPO / "experiments" / "cuda-kstep-tiles" / "overlap_probe.py"]:
        assert not [n for n in imported_modules(path)
                    if n.split(".")[0] in ("jax", "jaxlib", "lbm_tpu")], path


def test_chip_smoke_fails_without_a_card():
    no_cuda()
    res = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")], capture_output=True,
                         text=True, cwd=REPO, timeout=120)
    assert res.returncode != 0
    assert res.stdout == "" and "CUDA is not available" in res.stderr


def no_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the no-CUDA behaviour cannot be observed")


def small_case():
    p = Params(nx=32, ny=8, max_iters=4, reynolds_dim=10, density=0.1, accel=0.005,
               omega=1.85)
    return p, Obstacles.empty(p)


def test_run_simulation_defaults_to_cuda_and_raises_without_it():
    no_cuda()
    p, obs = small_case()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        lbm.run_simulation(p, obs)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        lbm.run_simulation(p, obs, engine="torch", device="cuda")


def test_cli_defaults_to_cuda_and_raises_without_it(tmp_path):
    no_cuda()
    from lbm_tpu_torch.cli import lbm as cli

    p, obs = small_case()
    p.to_file(tmp_path / "p.params")
    obs.to_file(tmp_path / "o.dat")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["--params", str(tmp_path / "p.params"), "--obstacles", str(tmp_path / "o.dat"),
                  "--out-dir", str(tmp_path / "out")])
    assert not (tmp_path / "out").exists()


@pytest.mark.parametrize("mod", [d2q9_kstep, d2q9_kstep_inplace, d2q9_kstep_manual])
def test_wrapper_raises_on_a_non_cpu_tensor(mod):
    f_np = np.full((9, 8, 32), 0.1 / 9)
    mask_np = np.zeros((8, 32), bool)
    # a CUDA tensor cannot even be made on a host without CUDA
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            state.to_torch(f_np, mask_np, device="cuda")
    # a tensor on another device goes to the kernel's checks, which refuse
    # it: the plain version is never the answer
    f = torch.empty((9, 8, 32), device="meta")
    mask = torch.empty((8, 32), dtype=torch.bool, device="meta")
    before = mod.launches
    with pytest.raises(ValueError, match="needs a CUDA tensor"):
        mod.stepk(f, mask, **KW)
    with pytest.raises(ValueError, match="needs a CUDA tensor"):
        mod.run(f, mask, num_steps=4, **KW)
    assert mod.launches == before


def test_copy_floor_raises_on_a_non_cpu_tensor(monkeypatch):
    def never(*args, **kwargs):
        raise AssertionError("the copy floor's wrapper left its kernel's path")

    monkeypatch.setattr(copy_floor, "run_copy_plain", never)
    before = copy_floor.launches
    with pytest.raises(ValueError, match="needs a CUDA tensor"):
        copy_floor.run_copy(torch.empty((9, 8, 32), device="meta"), 2, 8, 32)
    assert copy_floor.launches == before


@pytest.mark.parametrize("name", sorted(set(overlap_probe.ENGINES) - {"torch"}))
def test_overlap_probe_raises_on_a_non_cpu_tensor(name, monkeypatch):
    def never(*args, **kwargs):
        raise AssertionError("an overlap probe left its kernel's path")

    for plain in ("work_plain", "halo_plain", "smem_total_plain", "alias_plain"):
        monkeypatch.setattr(overlap_probe, plain, never)
    monkeypatch.setattr(overlap_probe.Probe, "plain", never)
    probe = overlap_probe.ENGINES[name](96, 128, 16, 2)
    before = overlap_probe.launches
    with pytest.raises(ValueError, match="needs a CUDA tensor"):
        probe(torch.empty((9, 96, 128), device="meta"))
    assert overlap_probe.launches == before


def test_blur_defaults_to_cuda_and_raises_without_it(tmp_path):
    no_cuda()
    from lbm_tpu_torch.cli import blur as blur_cli
    from lbm_tpu_torch.utils import image as img_lib

    rgba = np.random.default_rng(0).integers(0, 256, size=(8, 12, 4), dtype=np.uint8)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        blur.blur_image(rgba, num_iters=1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        blur.blur_image(rgba, num_iters=1, engine="conv", device="cuda")
    img_lib.save_png(tmp_path / "in.png", rgba)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        blur_cli.main(["-i", str(tmp_path / "in.png"), "-o", str(tmp_path / "out.png")])
    assert not (tmp_path / "out.png").exists()


BLUR_WRAPPERS = {
    "blur_step": lambda x, m: stencil.blur_step(x, m),
    "blur_k": lambda x, m: stencil.blur_k(x, m, k_passes=2),
    "blur_resident": lambda x, m: stencil.blur_resident(x, m, num_passes=2),
    "blur_many-cuda": lambda x, m: stencil.blur_many(x, m, num_iters=1, engine="cuda"),
    "blur_many-cuda-k2": lambda x, m: stencil.blur_many(x, m, num_iters=1, engine="cuda",
                                                       k_passes=2),
    "blur_many-resident": lambda x, m: stencil.blur_many(x, m, num_iters=1, engine="resident"),
}


@pytest.mark.parametrize("name", list(BLUR_WRAPPERS))
def test_blur_wrapper_raises_on_a_non_cpu_tensor(name, monkeypatch):
    # a tensor that is not on the CPU goes to the kernel's checks, which
    # refuse it: neither a plain version nor the library's convolution is
    # ever the answer
    def never(*args, **kwargs):
        raise AssertionError("a kernel wrapper left its kernel's path")

    for plain in ("blur_step_plain", "blur_k_plain", "blur_resident_plain", "blur_step_conv"):
        monkeypatch.setattr(stencil, plain, never)
    monkeypatch.setattr(torch.nn.functional, "conv2d", never)
    x = torch.empty((4, 32, 128), device="meta")
    m = torch.empty((32, 128), device="meta")
    before = dict(stencil.launches)
    with pytest.raises(ValueError, match="needs a CUDA tensor"):
        BLUR_WRAPPERS[name](x, m)
    assert stencil.launches == before


def test_blur_resident_opt_and_its_harness_import_no_jax_and_no_lbm_tpu():
    res = subprocess.run([sys.executable, "-c", IMPORT_ALL], capture_output=True, text=True,
                         cwd=REPO, timeout=120)
    assert res.returncode == 0, res.stderr
    assert "lbm_tpu_torch.ops.blur_resident_opt" in json.loads(
        res.stdout.strip().splitlines()[-1])["modules"]
    harness = REPO / "experiments" / "cuda-kstep-tiles" / "blur_resident_opt.py"
    names = imported_modules(harness)
    assert "lbm_tpu_torch.ops" in names
    assert not [n for n in names if n.split(".")[0] in ("jax", "jaxlib", "lbm_tpu")]


@pytest.mark.parametrize("variant", blur_resident_opt.VARIANTS)
def test_blur_resident_opt_raises_on_a_non_cpu_tensor(variant, monkeypatch):
    # a tensor that is not on the CPU goes to the kernel's checks, which
    # refuse it: the plain version is never the answer
    def never(*args, **kwargs):
        raise AssertionError("a resident-blur variant left its kernel's path")

    for plain in ("plain", "_pass"):
        monkeypatch.setattr(blur_resident_opt, plain, never)
    monkeypatch.setattr(blur_resident_opt.Resident, "plain", never)
    x = torch.empty((4, 32, 128), device="meta")
    call, layout = blur_resident_opt.build(variant, x, (30, 126))
    if layout == "rank2":
        x = torch.empty((32, 512), device="meta")
    m = torch.empty(x.shape[-2:], device="meta")
    before = dict(blur_resident_opt.launches)
    with pytest.raises(ValueError, match="needs a CUDA tensor"):
        call(2, x, m)
    assert blur_resident_opt.launches == before
