"""A cell on more than one card, on the CPU: its ranks started once a run by
the command-line entry (`cpu_run.py`: benchmark/run.py with the look for a
card skipped, the groups on gloo), each running the test driver
`drivers/d3q19_ranks_job.py` on the program's plain multi-device engine and
returning its own z-slab; `correct` judged per rank and reduced; the cards
counted from what each rank reports; a failing rank ending the run."""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark import harness
from benchmark.reference import compare, d3q19

from conftest import REPO, ranks_cell

LAUNCHER = Path(__file__).parent / "cpu_run.py"
SEED = 2**31 + 23
LIMIT_S = 15.0


def launch(root, cell, seconds=0.5, trace=0, timeout_s=None):
    """(the finished process, its wall seconds)."""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    if timeout_s is not None:
        env["BENCH_TEST_TIMEOUT_S"] = str(timeout_s)
    t0 = time.monotonic()
    out = subprocess.run([sys.executable, str(LAUNCHER), "--workload", cell, "--seed", str(SEED),
                          "--seconds", str(seconds), "--trace", str(trace)],
                         cwd=root, env=env, capture_output=True, text=True, timeout=300)
    return out, time.monotonic() - t0


def result_of(out) -> dict:
    """The one JSON line of standard output, which is its last line."""
    lines = out.stdout.splitlines()
    found = [line for line in lines if line.startswith("{")]
    assert out.returncode == 0 and len(found) == 1 and lines[-1] == found[0], out.stderr[-4000:]
    return json.loads(found[0])


def processes_of(root) -> list[int]:
    """Processes whose command line names `root`'s run: none may outlive it."""
    pids = []
    for entry in Path("/proc").iterdir():
        if entry.name.isdigit():
            try:
                cmd = (entry / "cmdline").read_bytes()
                cwd = os.readlink(entry / "cwd")
            except OSError:
                continue
            if str(LAUNCHER).encode() in cmd and cwd == str(root):
                pids.append(int(entry.name))
    return pids


@pytest.mark.parametrize("chips", [2, 4])
def test_a_multi_rank_run_is_one_result_of_every_rank(root, chips):
    """One JSON line, correct, a report from every rank that ran as many jobs
    as the run attempted; count from the reports; the other ranks' output
    on standard error after their prefix; every job ran inside the
    harness's group (the program started no ranks of its own); no process
    left."""
    cell = ranks_cell(root, f"ranks{chips}", chips)
    out, _ = launch(root, cell, trace=1)
    r = result_of(out)
    assert r["correct"] and r["failed"] == 0 and r["attempted"] >= 1, r["checks"]
    ranks = r["device"]["ranks"]
    assert [x["rank"] for x in ranks] == list(range(chips))
    assert [x["jobs"] for x in ranks] == [r["attempted"]] * chips
    assert r["device"]["count"] == chips == len({x["uuid"] for x in ranks})
    assert r["device"]["memory_peak_bytes"] == max(x["memory_peak_bytes"] for x in ranks)
    assert all("busy_share" in x for x in ranks) and "window_s" in r["device"]
    assert all(f"rank {k}: benchmark: set-up" in out.stderr for k in range(1, chips))
    assert "ranks started:" not in out.stderr
    assert processes_of(root) == []


def test_a_job_that_starts_ranks_of_its_own_is_seen(root):
    """The control of the test above: the same driver in a one-card cell
    (no group) calls the multi-device entry, which starts its own ranks."""
    out, _ = launch(root, ranks_cell(root, "ranks1", 1), seconds=0.01)
    assert result_of(out)["correct"]
    assert "ranks started:" in out.stderr


def test_the_reduced_gaps_are_those_of_the_gathered_answer(root, tmp_path):
    """Each rank judges its slab against its own slab's replay; the numbers
    of the run equal those of the slabs put together against one replay of
    the whole domain (`solve`): the state's and |u|'s to the bit, av_vels'
    within 1e-6 (the two replays sum Sum|u| in float32 in another order,
    which moves av_vels by some 1e-7 of itself)."""
    cell = ranks_cell(root, "dump2", 2, dump=str(tmp_path))
    r = result_of(launch(root, cell, seconds=0.01)[0])
    assert r["attempted"] == 1
    parts = [np.load(tmp_path / f"rank{k}.npz") for k in range(2)]
    assert np.array_equal(parts[0]["av"], parts[1]["av"])
    spec = harness.load_spec(root)
    c = harness.cell(spec, cell, root)
    drv = harness.driver(c.bench, c.config["driver"])
    job = drv.Job(c.config, c.config_dir, c.traffic, SEED, torch.device("cpu"))
    f0 = drv.rest_state((19, *job.shape), job.kw["density"], job.dtype, "cpu")
    ref_f, ref_av = d3q19.solve(f0, job.mask, steps=job.steps, storage=job.dtype,
                                store_every=job.store_every, device="cpu", **job.kw)
    whole = compare.gaps(np.concatenate([p["f"] for p in parts], axis=1), parts[0]["av"],
                         ref_f, ref_av, job.speed, job.obstacle())
    got = {n: r["checks"][n]["value"] for n in compare.NAMES}
    assert got["state_gap"] == whole["state_gap"] and got["velocity_gap"] == whole["velocity_gap"]
    assert abs(got["av_vels_gap"] - whole["av_vels_gap"]) <= 1e-6, (got, whole)


def test_a_value_altered_on_one_rank_fails_the_job(root):
    r = result_of(launch(root, ranks_cell(root, "alter2", 2,
                                          fault={"kind": "alter", "rank": 1}))[0])
    assert not r["correct"] and r["failed"] == r["attempted"] > 0
    assert r["checks"]["state_gap"]["value"] > r["checks"]["state_gap"]["limit"]


@pytest.mark.parametrize("fault", [{"kind": "raise"}, {"kind": "sleep", "seconds": 1000}])
def test_a_rank_that_fails_ends_the_run_with_no_result(root, fault):
    """A rank that raises, and one that sleeps past the limit: the run exits
    non-zero, prints no JSON, within the limit (LIMIT_S) beyond a set-up of
    seconds, and leaves no process."""
    cell = ranks_cell(root, "fault2", 2, fault={"rank": 1, **fault})
    out, seconds = launch(root, cell, timeout_s=LIMIT_S)
    assert out.returncode != 0
    assert not any(line.startswith("{") for line in out.stdout.splitlines())
    assert seconds < LIMIT_S + 45, seconds
    assert processes_of(root) == []


def _report(rank, **kw):
    return {"rank": rank, "card": rank, "uuid": f"GPU-{rank}", "memory_peak_bytes": 2**30,
            "allocations": 40, "other_cards_peak_bytes": 0, "jobs": 3, **kw}


def test_cards_are_counted_from_what_the_ranks_report():
    """A card counts when its rank's window left a peak on it and shows work
    there (allocations, or traced busy time); an idle rank, a peak left from
    set-up with no allocation and no busy time, and a second rank on one
    card are named. A lone rank needs the peak alone."""
    assert harness.cards_used([_report(r) for r in range(4)]) == (4, [])
    count, idle = harness.cards_used([_report(0), _report(1), _report(2),
                                      _report(3, memory_peak_bytes=0, allocations=0)])
    assert count == 3 and idle == ["rank 3 (card 3, GPU-3: idle)"]
    count, idle = harness.cards_used([_report(0), _report(1, allocations=0)])
    assert count == 1 and idle == ["rank 1 (card 1, GPU-1: idle)"]
    count, idle = harness.cards_used([_report(0), _report(1, card=0, uuid="GPU-0")])
    assert count == 1 and idle == ["rank 1 (card 0, GPU-0: another rank's card)"]
    assert harness.cards_used([_report(0), _report(1, allocations=0, busy_s=0.5)]) == (2, [])
    assert harness.cards_used([_report(0, allocations=0)]) == (1, [])
    assert harness.cards_used([_report(0, memory_peak_bytes=0, allocations=0)])[0] == 0


def _main_with_report(root, monkeypatch, **report):
    """harness.main on the one-card cell small3.f32, every rank reporting
    `report` for its card: (exit code, standard output, standard error)."""
    monkeypatch.setattr(harness, "ROOT", root)
    monkeypatch.setattr(harness, "card_report", lambda device, start: {
        "card": 0, "uuid": "GPU-0", "other_cards_peak_bytes": 0, **report})
    return harness.main(["--workload", "small3.f32", "--seed", "5", "--seconds", "0.1"],
                        devices=lambda n, rank=0: torch.device("cpu"))


def test_a_run_that_used_fewer_cards_than_its_cell_prints_no_result(root, monkeypatch, capsys):
    """Through main, a one-card cell whose card the window left idle."""
    code = _main_with_report(root, monkeypatch, memory_peak_bytes=0, allocations=0)
    captured = capsys.readouterr()
    assert code != 0 and "{" not in captured.out
    assert "asks for 1 cards and the run used 0" in captured.err
    assert "rank 0 (card 0, GPU-0: idle)" in captured.err


def test_a_window_that_allocates_nothing_is_not_refused(root, monkeypatch, capsys):
    """Through main, a one-card cell whose window holds memory on its card
    and makes no allocation (as CUDA graphs, or buffers kept from set-up)."""
    code = _main_with_report(root, monkeypatch, memory_peak_bytes=2**30, allocations=0)
    result = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert code == 0 and result["correct"] and result["device"]["count"] == 1


def _parent_gaps(f, av, ref_f, ref_av, speed, obstacle):
    """compare.gaps as the benchmark had it before its numbers were split
    into parts (one ratio of maxima each, on the reference's device)."""
    def gap(x, ref):
        if x.shape != ref.shape:
            return math.inf
        return float((x - ref).abs().max() / ref.abs().max())

    def tensor(a, device):
        t = a if isinstance(a, torch.Tensor) else torch.from_numpy(np.asarray(a))
        return t.to(device=device, dtype=torch.float64)

    dev = ref_f.device
    fp, fr = tensor(f, dev), ref_f.double()
    out = {"state_gap": gap(fp, fr),
           "velocity_gap": (gap(speed(fp, obstacle), speed(fr, obstacle))
                            if fp.shape == fr.shape else math.inf),
           "av_vels_gap": gap(tensor(av, dev), ref_av.double())}
    return {k: (v if math.isfinite(v) else math.inf) for k, v in out.items()}


@pytest.mark.parametrize("cell", ["small2.f32", "small3.bf16"])
def test_the_one_card_result_keeps_its_keys_and_its_gaps(root, cell):
    """The one-card path: the result's keys as before, with `ranks` in the
    device block; one job's gaps equal to the bit to the parent's
    comparison, for the program's answer and for answers altered, cut
    short and not finite."""
    result = harness.run(root, cell, SEED, 0.2, False, torch.device("cpu"), time.perf_counter())
    assert list(result) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert list(result["device"]) == ["platform", "kind", "count", "memory_peak_bytes", "ranks"]
    assert result["device"]["count"] == 1 and len(result["device"]["ranks"]) == 1
    assert result["correct"] and result["device"]["ranks"][0]["jobs"] == result["attempted"]
    c = harness.cell(harness.load_spec(root), cell, root)
    job = harness.driver(c.bench, c.config["driver"]).Job(c.config, c.config_dir, c.traffic,
                                                          SEED, torch.device("cpu"))
    f, av = job.run()
    ref_f, ref_av = job.reference(job.dtype)
    obstacle = job.obstacle()
    f = torch.as_tensor(np.asarray(f, dtype=np.float32) if not isinstance(f, torch.Tensor) else f)
    altered = f.clone()
    altered[1, 2, 3] *= 2
    broken = f.clone().float()
    broken[0, 1, 1] = math.nan
    for answer, series in [(f, av), (altered, av), (f[:, 1:], av), (broken, av),
                           (f, np.asarray(av)[:-1])]:
        new = compare.gaps(answer, series, ref_f, ref_av, job.speed, obstacle)
        assert new == _parent_gaps(answer, series, ref_f, ref_av, job.speed, obstacle)


def test_parts_reduced_over_slabs_give_the_gaps_of_the_whole():
    """The parts of z-slabs, their maximum taken, give compare.gaps of the
    whole to the bit; a slab altered, cut short or not finite fails the
    whole as it fails alone."""
    gen = torch.Generator().manual_seed(3)
    ref_f = torch.rand((19, 8, 4, 6), generator=gen, dtype=torch.float64)
    ref_av = torch.rand(10, generator=gen, dtype=torch.float64)
    f = (ref_f + 1e-6 * torch.rand(ref_f.shape, generator=gen, dtype=torch.float64)).float()
    av = ref_av.numpy() + 1e-9
    obstacle = torch.zeros((8, 4, 6), dtype=torch.bool)
    obstacle[0] = obstacle[-1] = True

    def reduced(answer, cut=None):
        slabs = [slice(0, 3), slice(3, 8)]
        ps = []
        for i, z in enumerate(slabs):
            part = answer[:, z]
            if cut == i:
                part = part[:, 1:]
            ps.append(compare.parts(part, av, ref_f[:, z], ref_av, d3q19.speed, obstacle[z]))
        return compare.ratios(torch.stack(ps).max(dim=0).values)

    assert reduced(f) == compare.gaps(f, av, ref_f, ref_av, d3q19.speed, obstacle)
    altered = f.clone()
    altered[2, 5, 1, 1] *= 2
    assert reduced(altered) == compare.gaps(altered, av, ref_f, ref_av, d3q19.speed, obstacle)
    assert reduced(altered)["state_gap"] > 1e-3 > reduced(f)["state_gap"]
    broken = f.clone()
    broken[0, 6, 0, 0] = math.inf
    assert reduced(broken)["state_gap"] == math.inf == reduced(f, cut=0)["velocity_gap"]
