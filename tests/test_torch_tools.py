"""The port's host tools against the JAX package's: cli/partition_stats.py,
cli/viz_partition.py, utils/roll_slices.py, cli/flow_viz.py, and
cli/halo_bench.py on gloo ranks."""

import itertools

import numpy as np
import pytest

from lbm_tpu.cli import flow_viz as ref_flow_viz
from lbm_tpu.cli import partition_stats as ref_partition_stats
from lbm_tpu.cli import viz_partition as ref_viz
from lbm_tpu.parallel import partition as ref_partition
from lbm_tpu.utils import roll_slices as ref_roll
from lbm_tpu_torch.cli import flow_viz, halo_bench, partition_stats, viz_partition
from lbm_tpu_torch.core import io
from lbm_tpu_torch.core.params import Params
from lbm_tpu_torch.models import lbm as lbm_model
from lbm_tpu_torch.parallel import partition
from lbm_tpu_torch.utils import image as img_lib
from lbm_tpu_torch.utils import roll_slices


@pytest.mark.parametrize("seed,devices", [(0, "1,2,4,8"), (7, "3,6,16")])
def test_partition_stats_byte_identical_to_the_reference(tmp_path, seed, devices):
    argv = ["--samples", "25", "--devices", devices, "--seed", str(seed)]
    assert partition_stats.main(argv + ["-o", str(tmp_path / "port.csv")]) == 0
    assert ref_partition_stats.main(argv + ["-o", str(tmp_path / "ref.csv")]) == 0
    text = (tmp_path / "port.csv").read_bytes()
    assert text == (tmp_path / "ref.csv").read_bytes() and text.count(b"\n") > 25


PLANS = {
    "devices": lambda p, ny, nx, n: p.partition_for_devices(ny, nx, n),
    "bands": lambda p, ny, nx, n: p.to_band_partitions(p.partition_for_devices(ny, nx, n), 24),
    "blocks": lambda p, ny, nx, n: p.to_block_partitions(p.partition_for_devices(ny, nx, n), 6),
    "overlay": lambda p, ny, nx, n: p.fixed_overlay_partitions(
        p.partition_for_devices(ny, nx, n), 5, 3),
}


@pytest.mark.parametrize("plan,lanes", itertools.product(PLANS, [False, True]))
def test_viz_partition_render_equals_the_reference(plan, lanes):
    ny, nx, n = 200, 300, 4
    got = viz_partition.render(PLANS[plan](partition, ny, nx, n), ny, nx, lanes=lanes)
    want = ref_viz.render(PLANS[plan](ref_partition, ny, nx, n), ny, nx, lanes=lanes)
    assert got.shape == (ny, nx, 4) and np.array_equal(got, want)
    scaled = viz_partition.render(PLANS[plan](partition, ny, nx, n), ny, nx, scale=2, lanes=lanes)
    assert np.array_equal(scaled[::2, ::2], got)


def test_viz_partition_cli_writes_the_png_and_the_stats(tmp_path, capsys):
    out, js = tmp_path / "p.png", tmp_path / "p.json"
    assert viz_partition.main(["--ny", "96", "--nx", "160", "--num-devices", "4", "--blocks",
                               "6", "--lanes", "-o", str(out), "--json", str(js)]) == 0
    text = capsys.readouterr().out
    for line in ("targets:", "load balance:", "max speedup:", "wasted targets:", "lane util:"):
        assert line in text
    part = partition.to_block_partitions(partition.partition_for_devices(96, 160, 4), 6)
    assert np.array_equal(img_lib.load_png(out), viz_partition.render(part, 96, 160, lanes=True))
    assert js.read_text() == partition.serialize_to_json(part)


@pytest.mark.parametrize("shape,roll", itertools.product(
    [(5, 7), (1, 4), (8, 3)], [(0, 0), (1, 0), (0, -1), (1, 1), (-1, 1), (2, -3)]))
def test_roll_slices_equal_the_reference_and_np_roll(shape, roll):
    regions = roll_slices.determine_src_dst_slices(shape, roll)
    ref = ref_roll.determine_src_dst_slices(shape, roll)
    assert [vars(r) for r in regions] == [vars(r) for r in ref]
    assert roll_slices.copy_volumes(shape, roll) == ref_roll.copy_volumes(shape, roll)
    assert sum(roll_slices.copy_volumes(shape, roll)) == shape[0] * shape[1]
    src = np.arange(shape[0] * shape[1] * 2).reshape(*shape, 2)
    assert np.array_equal(roll_slices.rolled_copy(src, roll), np.roll(src, roll, axis=(0, 1)))


@pytest.fixture(scope="module")
def final_state(tmp_path_factory):
    """A final_state.dat of a short run of the torch engine, with obstacles."""
    from lbm_tpu_torch.core.params import Obstacles

    tmp = tmp_path_factory.mktemp("flow")
    p = Params(nx=40, ny=24, max_iters=30, reynolds_dim=10, density=0.1, accel=0.005,
               omega=1.85)
    mask = np.random.default_rng(2).random((p.ny, p.nx)) < 0.08
    res = lbm_model.run_simulation(p, Obstacles(mask), engine="torch", device="cpu")
    io.write_final_state(tmp / "final_state.dat", p, mask, res.f_final)
    return tmp / "final_state.dat", p


@pytest.mark.parametrize("field", ["speed", "ux", "uy", "pressure", "vorticity"])
def test_flow_viz_render_field_equals_the_reference(final_state, field):
    path, p = final_state
    cols = io.read_final_state(path)
    got = flow_viz.render_field(cols, p.ny, p.nx, field)
    assert got.shape == (p.ny, p.nx, 4)
    assert np.array_equal(got, ref_flow_viz.render_field(cols, p.ny, p.nx, field))
    assert len(np.unique(got.reshape(-1, 4), axis=0)) > 10  # a field, not a flat colour


def test_flow_viz_cli_writes_the_png(final_state, tmp_path, capsys):
    path, p = final_state
    assert flow_viz.main([str(path), "-o", str(tmp_path / "f.png"), "--field", "vorticity",
                          "--scale", "3"]) == 0
    img = img_lib.load_png(tmp_path / "f.png")
    want = flow_viz.render_field(io.read_final_state(path), p.ny, p.nx, "vorticity")
    assert np.array_equal(img[::3, ::3], want)
    assert f"(vorticity, {p.ny}x{p.nx})" in capsys.readouterr().out


def test_halo_bench_on_two_gloo_ranks(capsys):
    assert halo_bench.main(["--device", "cpu", "--num-devices", "2", "--ny", "64", "--nx", "64",
                            "-n", "3"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0] == halo_bench.HEADER
    rows = [line.split(",") for line in lines[1:]]
    assert [r[0] for r in rows] == list(lbm_model.STRATEGIES)
    for r in rows:
        assert r[1:6] == ["cpu", "2", "1x2", "64x64", "3"]
        assert float(r[6]) > 0 and float(r[7]) > 0


def test_halo_bench_refuses_an_unknown_strategy(capsys):
    with pytest.raises(SystemExit):
        halo_bench.main(["--device", "cpu", "--strategies", "ppermute,none"])
    assert "unknown strategies ['none']" in capsys.readouterr().err

