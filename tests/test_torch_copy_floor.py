"""The copy floor of the port (lbm_tpu_torch.ops.copy_floor, kernel B12) on the
CPU, against the TPU kernel it replaces: `_copy_kernel` of
experiments/d2q9-blocked-floor/run.py, loaded from that file by its path and
run through `pl.pallas_call(..., interpret=True)` over the same (9, by, bx)
blocks, one call per pass. A copy changes no value: the results must be
bit-equal.
"""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from lbm_tpu_torch.ops import copy_floor

REPO = Path(__file__).resolve().parent.parent


def experiment_module():
    path = REPO / "experiments" / "d2q9-blocked-floor" / "run.py"
    spec = importlib.util.spec_from_file_location("d2q9_blocked_floor_run", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def pallas_copy(f, n, by, bx):
    """n passes of the experiment's kernel, as its `run_copy` chains them."""
    kernel = experiment_module()._copy_kernel
    _, ny, nx = f.shape
    spec = pl.BlockSpec((9, by, bx), lambda i, j: (0, i, j))
    call = pl.pallas_call(kernel, grid=(ny // by, nx // bx), in_specs=[spec], out_specs=spec,
                          out_shape=jax.ShapeDtypeStruct(f.shape, f.dtype), interpret=True)
    for _ in range(n):
        f = call(f)
    return np.asarray(f)


@pytest.mark.parametrize("shape, by, bx, n", [
    ((9, 16, 128), 8, 128, 1),   # full-width bands
    ((9, 32, 64), 16, 32, 3),    # the K-step kernels' tile
])
def test_run_copy_plain_matches_the_tpu_kernel(shape, by, bx, n):
    f = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    ref = pallas_copy(jnp.asarray(f), n, by, bx)
    got = copy_floor.run_copy(torch.from_numpy(f), n, by, bx)
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(ref, f)


def test_run_copy_on_the_cpu_is_the_plain_version_and_leaves_f():
    f = torch.from_numpy(np.random.default_rng(1).standard_normal((9, 12, 20)))
    before = copy_floor.launches
    out = copy_floor.run_copy(f, 2, 5, 7)  # blocks that do not divide the grid
    assert out is not f and torch.equal(out, f) and out.dtype == torch.float64
    assert torch.equal(copy_floor.run_copy_plain(f, 1, 5, 7), f)
    assert copy_floor.launches == before


@pytest.mark.parametrize("args, match", [
    (((9, 8), 1, 8, 8), "shape"),
    (((8, 8, 8), 1, 8, 8), "shape"),
    (((9, 8, 8), 0, 8, 8), "positive"),
    (((9, 8, 8), 1, 0, 8), "positive"),
])
def test_run_copy_refuses_bad_arguments(args, match):
    shape, n, by, bx = args
    with pytest.raises(ValueError, match=match):
        copy_floor.run_copy(torch.zeros(shape), n, by, bx)
