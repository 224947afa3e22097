"""The port's own ranges in a profiler's trace (utils/profiling.py: `span`,
`passes`): the phases of `run_simulation` and `d3q19.advance`, the engine
loop of every single-device engine with its kernel, path and K in its name,
and one pass range a pass inside it. Run on the CPU, where the kernel
engines take their plain version.

While no profiler runs, none of it may cost a `record_function` call: the
benchmark's untraced runs time the same code.
"""

import re

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from lbm_tpu_torch.core import state
from lbm_tpu_torch.core.params import Obstacles, Params
from lbm_tpu_torch.models import lbm
from lbm_tpu_torch.ops import d2q9_kstep, d3q19
from lbm_tpu_torch.utils import profiling

CALL = "test: call"
STEPS = 8
# run_simulation's engines: the kernel each names its loop by, and its K
# for STEPS steps (the largest of 4, 2, 1 that divides them; the plain
# torch engine steps one at a time)
ENGINES_2D = {"cuda": ("B2", 4), "cuda-inplace": ("B1", 4), "cuda-manual": ("B3", 4),
              "torch": ("torch", 1), "auto": ("B2", 4)}
ENGINES_3D = {"cuda-inplace": "B4", "cuda": "B6"}
LOOP = re.compile(re.escape(profiling.ENGINE) + r"(\S+) (\S+) K=(\d+)$")


def case_2d():
    p = Params(nx=16, ny=12, max_iters=STEPS, reynolds_dim=10, density=0.1, accel=0.005,
               omega=1.85)
    mask = np.zeros((12, 16), bool)
    mask[0] = mask[-1] = True
    mask[3:9, 6] = True
    return p, Obstacles(mask)


def run_2d(engine):
    p, obstacles = case_2d()
    return lbm.run_simulation(p, obstacles, engine=engine, device="cpu")


def run_3d(engine):
    mask = np.zeros((6, 4, 8), bool)
    mask[0] = mask[-1] = True
    f, m = state.to_torch3d(d3q19.initial_distributions(6, 4, 8, 0.1, np.float32), mask,
                            device="cpu")
    return d3q19.advance(f, m, num_steps=STEPS, engine=engine)


def traced(fn):
    """The program's ranges (and CALL) of fn() under torch.profiler."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function(CALL):
            fn()
    return [e for e in prof.events() if e.name.startswith("lbm_tpu_torch: ") or e.name == CALL]


def owner(event):
    """The innermost range of the program (or CALL) that holds `event`."""
    e = event.cpu_parent
    while e is not None and not (e.name.startswith("lbm_tpu_torch: ") or e.name == CALL):
        e = e.cpu_parent
    return e


def check_loops(events, kernel, k=None, steps=None):
    """Every pass lies in a loop named for `kernel` on the plain path, each
    loop holds its steps / K passes: `steps[name]` for a loop inside the
    range `name`, STEPS where `steps` is None; returns the loops."""
    loops = [e for e in events if e.name.startswith(profiling.ENGINE)]
    passes = [e for e in events if e.name == profiling.PASS]
    assert loops and passes
    assert all(owner(e) in loops for e in passes)
    for loop in loops:
        m = LOOP.match(loop.name)
        assert m and m.group(1) == kernel and m.group(2) == "plain", loop.name
        loop_k = int(m.group(3))
        assert k is None or loop_k == k
        n = STEPS if steps is None else steps[owner(loop).name]
        assert n % loop_k == 0
        assert sum(1 for e in passes if owner(e) is loop) == n // loop_k
    return loops


@pytest.mark.parametrize("engine", sorted(ENGINES_2D))
def test_run_simulation_records_its_phases_loops_and_passes(engine):
    events = traced(lambda: run_2d(engine))
    names = {e.name for e in events}
    phases = set(profiling.SPANS) - ({profiling.CHOOSE_ENGINE} if engine != "auto" else set())
    assert phases <= names
    assert (profiling.CHOOSE_ENGINE in names) == (engine == "auto")
    kernel, k = ENGINES_2D[engine]
    # the warm-up run steps choose_k(STEPS) steps (a pass of the kernel
    # engines), the timed run all STEPS
    steps = {profiling.WARM_UP: min(STEPS, d2q9_kstep.choose_k(STEPS)),
             profiling.TIMED_RUN: STEPS}
    loops = check_loops(events, kernel, k, steps)
    # one loop in the warm-up run, one in the timed run, both in the call
    assert sorted(owner(e).name for e in loops) == sorted([profiling.WARM_UP,
                                                           profiling.TIMED_RUN])
    assert all(owner(e).name == CALL for e in events
               if e.name in (profiling.WARM_UP, profiling.TIMED_RUN))
    assert all(owner(e) is not None for e in events if e.name != CALL)
    # the start state and upload come before the warm-up run, the copy-out
    # and total density after the timed run
    start = {e.name: e.time_range.start for e in events}
    assert start[profiling.START_STATE] < start[profiling.UPLOAD] < start[profiling.WARM_UP]
    assert start[profiling.TIMED_RUN] < start[profiling.TOTAL_DENSITY]
    assert max(e.time_range.start for e in events if e.name == profiling.COPY_OUT) > \
        start[profiling.TIMED_RUN]


@pytest.mark.parametrize("engine", sorted(ENGINES_3D))
def test_advance_records_the_engine_choice_and_one_loop(engine):
    events = traced(lambda: run_3d(engine))
    names = {e.name for e in events}
    assert {profiling.UPLOAD, profiling.CHOOSE_ENGINE} <= names
    loops = check_loops(events, ENGINES_3D[engine])
    assert len(loops) == 1 and owner(loops[0]).name == CALL


def count_record_function(monkeypatch):
    """A list that grows by a name at each record_function call."""
    calls = []
    real = torch.profiler.record_function

    def counting(name, *args, **kwargs):
        calls.append(name)
        return real(name, *args, **kwargs)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", counting)
    return calls


@pytest.mark.parametrize("run", [pytest.param(lambda e=e: run_2d(e), id=f"2d-{e}")
                                 for e in sorted(ENGINES_2D)]
                         + [pytest.param(lambda e=e: run_3d(e), id=f"3d-{e}")
                            for e in sorted(ENGINES_3D)])
def test_no_record_function_call_while_no_profiler_runs(monkeypatch, run):
    calls = count_record_function(monkeypatch)
    run()
    assert calls == []
    # the control: traced, every range of the program is one call
    events = traced(run)
    assert len(calls) == len(events) and sorted(calls) == sorted(e.name for e in events)


def test_passes_are_a_plain_range_and_spans_a_shared_no_op_while_off():
    assert not torch.autograd._profiler_enabled()
    assert profiling.passes(5, "B2", "box", 4) == range(5)
    assert profiling.span(profiling.PASS) is profiling.span(profiling.UPLOAD)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert list(profiling.passes(3, "B4", "wave", 4)) == [0, 1, 2]
        with profiling.span(profiling.COPY_OUT):
            pass
    names = [e.name for e in prof.events()]
    assert names.count(profiling.PASS) == 3 and names.count(profiling.COPY_OUT) == 1
    assert f"{profiling.ENGINE}B4 wave K=4" in names


def test_a_loop_asks_a_callable_path_only_while_a_profiler_runs():
    asked = []

    def path():
        asked.append(1)
        return "box"

    assert profiling.passes(2, "B7", path, 4) == range(2) and asked == []
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert list(profiling.passes(2, "B7", path, 4)) == [0, 1]
    assert asked == [1]
    assert f"{profiling.ENGINE}B7 box K=4" in [e.name for e in prof.events()]


def test_a_loop_left_by_an_exception_closes_its_ranges():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with pytest.raises(RuntimeError):
            for i in profiling.passes(4, "B2", "box", 4):
                if i == 1:
                    raise RuntimeError("a failed launch")
        with profiling.span(profiling.COPY_OUT):
            pass
    events = {e.name: e for e in prof.events()}
    # the range after the loop is no child of the loop's ranges
    assert events[profiling.COPY_OUT].cpu_parent is None
    assert [e.name for e in prof.events()].count(profiling.PASS) == 2
