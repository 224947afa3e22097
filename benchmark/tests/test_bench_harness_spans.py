"""The readers of the program's own ranges (benchmark/spans.py and the
metrics launch_gap_us_per_pass, enqueue_us_per_pass, host_stall_ms_per_job)
on synthetic traces, and in a traced run on the CPU."""

from __future__ import annotations

import time

import pytest
import torch

from benchmark import devtrace, harness, spans

from conftest import REPO
from test_bench_harness_trace import ctx

BENCH = REPO / "benchmark"
LOOP_2D = spans.ENGINE + "B2 box K=4"
LOOP_3D = spans.ENGINE + "B4 wave K=4"
READERS = ("launch_gap_us_per_pass", "enqueue_us_per_pass", "host_stall_ms_per_job",
           "runner_ms_per_job")


def events():
    """A 200 us window with two jobs, [0, 90] and [100, 200], and a kernel
    launched before the window (the pairing runs over the whole trace).
    Job 1: a copy to the card [10, 20]; a loop [20, 60] of three passes, a
    launch and a kernel each, the kernels [24, 30], [32, 38], [40, 50]
    (extent [24, 50], 4 idle in it); a copy to the host [60, 70] with a set
    under it; a kernel outside the loop [75, 80]. Job 2: a loop [110, 150]
    of two passes, two launches and kernels each (extent [116, 143], 3 idle
    in it); a copy to the host [150, 170]."""
    launch = "cudaLaunchKernel"
    return [
        ("kstep_box_kernel", "kernel", -48.0, -40.0),
        (launch, "cuda_runtime", -50.0, -49.0),
        (devtrace.WINDOW, "user_annotation", 0.0, 200.0),
        (devtrace.JOB, "user_annotation", 0.0, 90.0),
        (devtrace.JOB, "user_annotation", 100.0, 200.0),
        ("lbm_tpu_torch: start state", "user_annotation", 0.0, 10.0),
        ("Memcpy HtoD", "gpu_memcpy", 10.0, 20.0),
        (LOOP_2D, "user_annotation", 20.0, 60.0),
        (spans.PASS, "user_annotation", 20.0, 28.0),
        (spans.PASS, "user_annotation", 28.0, 36.0),
        (spans.PASS, "user_annotation", 36.0, 44.0),
        (launch, "cuda_runtime", 21.0, 23.0),
        ("aten::empty", "cpu_op", 23.0, 24.0),
        (launch, "cuda_runtime", 29.0, 31.0),
        (launch, "cuda_runtime", 37.0, 39.0),
        ("kstep_box_kernel", "kernel", 24.0, 30.0),
        ("kstep_box_kernel", "kernel", 32.0, 38.0),
        ("kstep_box_kernel", "kernel", 40.0, 50.0),
        ("Memcpy DtoH", "gpu_memcpy", 60.0, 70.0),
        ("Memset", "gpu_memset", 65.0, 68.0),
        (launch, "cuda_runtime", 72.0, 73.0),
        ("reduce_kernel", "kernel", 75.0, 80.0),
        (LOOP_3D, "user_annotation", 110.0, 150.0),
        (spans.PASS, "user_annotation", 110.0, 125.0),
        (spans.PASS, "user_annotation", 125.0, 140.0),
        (launch, "cuda_runtime", 111.0, 113.0),
        (launch, "cuda_runtime", 114.0, 115.0),
        (launch, "cuda_runtime", 126.0, 128.0),
        (launch, "cuda_runtime", 129.0, 130.0),
        ("wave_kernel", "kernel", 116.0, 126.0),
        ("sum_partials_kernel", "kernel", 126.0, 128.0),
        ("wave_kernel", "kernel", 131.0, 141.0),
        ("sum_partials_kernel", "kernel", 141.0, 143.0),
        ("Memcpy DtoH", "gpu_memcpy", 150.0, 170.0),
        ("cudaStreamSynchronize", "cuda_runtime", 150.0, 171.0),
    ]


def read(trace):
    return {m: harness.reader(BENCH, m)(ctx(trace)) for m in READERS}


def test_each_reader_on_a_synthetic_trace():
    got = read(devtrace.from_events(events()))
    # gaps 4 + 3 over five passes
    assert got["launch_gap_us_per_pass"] == pytest.approx(1.4)
    # passes 8, 8, 8 long with 2 of launch each; 15, 15 with 3
    assert got["enqueue_us_per_pass"] == pytest.approx((6 + 6 + 6 + 12 + 12) / 5)
    # idle outside the extents: job 1 90 - 51, job 2 100 - 47
    assert got["host_stall_ms_per_job"] == pytest.approx((39 + 53) / 2 / 1e3)
    assert got["runner_ms_per_job"] == pytest.approx((63 + 76) / 2 / 1e3)


def test_the_runner_is_gaps_stall_and_uncovered_copies_exactly():
    t = devtrace.from_events(events())
    parts = spans.split(t)
    assert parts == {"gaps": 7.0, "stall": 92.0, "copies": 40.0, "passes": 5, "jobs": 2}
    got = read(t)
    jobs = parts["jobs"]
    assert got["runner_ms_per_job"] * 1e3 * jobs == parts["gaps"] + parts["stall"] + parts["copies"]
    assert got["runner_ms_per_job"] * 1e3 == (got["launch_gap_us_per_pass"] * parts["passes"]
                                              / jobs + got["host_stall_ms_per_job"] * 1e3
                                              + parts["copies"] / jobs)


def test_unpaired_launches_read_nothing_on_the_device():
    # a kernel the trace lost: the launches no longer pair
    trace = devtrace.from_events([e for e in events() if e[2:] != (32.0, 38.0)])
    got = read(trace)
    assert got["launch_gap_us_per_pass"] is None and got["host_stall_ms_per_job"] is None
    assert spans.extents(trace) is None and spans.split(trace) is None
    # the host's own reading needs no pairing
    assert got["enqueue_us_per_pass"] == pytest.approx(8.4)


def test_a_program_without_loop_ranges_reads_nothing():
    # the trace of a program that records no engine loop or pass
    trace = devtrace.from_events([e for e in events() if not e[0].startswith("lbm_tpu_torch")])
    got = read(trace)
    assert got["runner_ms_per_job"] is not None
    assert [got[m] for m in READERS[:3]] == [None, None, None]
    assert [r(ctx(None)) for r in (harness.reader(BENCH, m) for m in READERS[:3])] == \
        [None, None, None]


def test_a_loop_on_the_cpu_has_passes_and_no_device():
    t = devtrace.from_events([
        (devtrace.WINDOW, "user_annotation", 0.0, 100.0),
        (devtrace.JOB, "user_annotation", 0.0, 100.0),
        (LOOP_2D, "user_annotation", 10.0, 50.0),
        (spans.PASS, "user_annotation", 10.0, 30.0),
        (spans.PASS, "user_annotation", 30.0, 50.0),
        (spans.PASS, "user_annotation", 150.0, 160.0),  # after the window
    ])
    got = read(t)
    assert got["enqueue_us_per_pass"] == pytest.approx(20.0)
    assert got["launch_gap_us_per_pass"] is None and got["host_stall_ms_per_job"] is None


@pytest.mark.parametrize("cell", ["small2.f32", "small3.f32"])
def test_a_traced_run_on_the_cpu_reads_the_host_and_leaves_out_the_device(root, cell):
    result = harness.run(root, cell, 2**31 + 11, 0.2, True, torch.device("cpu"),
                         time.perf_counter())
    assert result["correct"]
    metrics = result["metrics"]
    assert metrics["enqueue_us_per_pass"]["value"] > 0
    assert metrics["enqueue_us_per_pass"]["unit"] == "us"
    assert "launch_gap_us_per_pass" not in metrics and "host_stall_ms_per_job" not in metrics
