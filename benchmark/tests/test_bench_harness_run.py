"""A run as the driver starts it, on a host without a card; and the
modules a run loads."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest
import torch

from conftest import REPO

ISOLATION = """
import importlib, json, pkgutil, sys, time
from pathlib import Path
sys.path[0] = {repo!r}
import torch
import benchmark
from benchmark import harness
names = [m.name for m in pkgutil.walk_packages(benchmark.__path__, "benchmark.")
         if ".tests" not in m.name]
for name in names:
    importlib.import_module(name)
for kind in ("drivers", "metrics"):
    for path in sorted(Path(benchmark.__path__[0], kind).glob("*.py")):
        harness.load_module(path, "x_" + path.stem)
for cell in ("small2.f32", "small3.bf16"):
    harness.run(Path({root!r}), cell, 3, 0.1, True, torch.device("cpu"), time.perf_counter())
print(json.dumps({{"names": names, "top": sorted({{m.split(".")[0] for m in sys.modules}})}}))
"""


def test_no_card_fails_with_a_message_and_no_result():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "d2q9-cavity.f32",
                          "--seed", str(2**31 + 5), "--seconds", "1", "--trace", "0"],
                         cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert "no CUDA device" in out.stderr
    assert not any(line.startswith("{") for line in out.stdout.splitlines())


def test_an_unknown_cell_is_named():
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "nope", "--seed",
                          "1", "--seconds", "1", "--trace", "0"],
                         cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and "no workload named 'nope'" in out.stderr


def _imported(code):
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_the_benchmark_loads_no_jax_package(root):
    """Importing every module under benchmark/, and runs of a 2-D and a 3-D
    cell on the CPU, load no module whose top-level name is jax, jaxlib,
    flax or lbm_tpu (compared whole: the program, lbm_tpu_torch, is
    loaded)."""
    got = _imported(ISOLATION.format(repo=str(REPO), root=str(root)))
    assert "benchmark.harness" in got["names"] and "benchmark.reference.d2q9" in got["names"]
    assert "lbm_tpu_torch" in got["top"]
    assert not {"jax", "jaxlib", "flax", "lbm_tpu"} & set(got["top"])


def test_the_reference_loads_nothing_of_the_program():
    code = ("import json, sys\nsys.path[0] = {!r}\n"
            "import benchmark.reference.d2q9, benchmark.reference.d3q19, "
            "benchmark.reference.compare\n"
            "print(json.dumps({{'top': sorted({{m.split('.')[0] for m in sys.modules}})}}))\n"
            ).format(str(REPO))
    top = set(_imported(code)["top"])
    assert not {"jax", "jaxlib", "flax", "lbm_tpu", "lbm_tpu_torch"} & top


def test_a_run_that_loaded_the_jax_package_is_refused(monkeypatch):
    from benchmark import harness

    monkeypatch.setitem(sys.modules, "lbm_tpu", type(sys)("lbm_tpu"))
    monkeypatch.setitem(sys.modules, "lbm_tpu_torch_extra", type(sys)("lbm_tpu_torch_extra"))
    assert harness.forbidden_modules() == ["lbm_tpu"]
