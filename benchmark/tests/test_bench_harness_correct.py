"""`correct` on the CPU at small sizes: the program passes its cell's
limits; the control (the reference one storage type below, in the program's
place) fails one of them; and a run whose timed path is broken underneath
comes out not correct. The look for a card is skipped: the harness runs the
program's CPU path, its kernels' plain versions."""

from __future__ import annotations

import time

import pytest
import torch

from benchmark import harness

CELLS = ("small2.f32", "small3.f32", "small3.bf16")


def run(root, cell, seed=2**31 + 17):
    return harness.run(root, cell, seed, 0.2, False, torch.device("cpu"), time.perf_counter())


@pytest.mark.parametrize("cell", CELLS)
def test_the_program_passes_and_the_control_fails(root, cell):
    result = run(root, cell)
    assert result["correct"] and result["failed"] == 0, result["checks"]
    spec = harness.load_spec(root)
    c = harness.cell(spec, cell, root)
    job = harness.driver(c.bench, c.config["driver"]).Job(c.config, c.config_dir, c.traffic,
                                                         2**31 + 17, torch.device("cpu"))
    [row] = harness.judge(job, [job.reference(job.control)])
    assert any(row[n] > c.limits[n] for n in c.limits), (row, c.limits)


def _broken_pass(module, name, fault):
    """The kernels' plain K-step pass `module.name`, with `fault`."""
    original = getattr(module, name)

    def broken(f, mask, **kw):
        f_new, tot = original(f, mask, **kw)
        if fault == "unchanged":
            return f.clone(), tot
        f_new = f_new.clone()
        f_new[1, 2, 3] = f_new[1, 2, 3] * 2
        return f_new, tot

    return broken


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", ["unchanged", "altered"])
def test_a_broken_timed_path_is_not_correct(root, monkeypatch, cell, fault):
    """A step that returns its state unchanged, and an answer altered where
    it is produced (one value of one pass's state)."""
    from lbm_tpu_torch.ops import d2q9_kstep, d3q19_kstep

    module = d2q9_kstep if cell.startswith("small2") else d3q19_kstep
    monkeypatch.setattr(module, "stepk_plain", _broken_pass(module, "stepk_plain", fault))
    result = run(root, cell)
    assert not result["correct"] and result["failed"] == result["attempted"] > 0


def test_calibrate_reads_the_program_the_control_and_other_store_intervals(root):
    """calibrate.py's readings of one seed: the program, the control, and
    the reference storing at another interval in the program's place; the
    cell's own interval reads the replay exactly."""
    from benchmark import calibrate

    rows = []
    calibrate.readings(root, "small3.bf16", [2**31 + 3], {2**31 + 3}, torch.device("cpu"),
                       rows.append, (4, 8))
    by = {r["side"]: r for r in rows}
    assert list(by) == ["program", "control", "store_every_4", "store_every_8"]
    assert by["store_every_4"]["state_gap"] == 0 < by["store_every_8"]["state_gap"]
