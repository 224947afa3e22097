"""The interval arithmetic of the per-layer metrics, on synthetic traces."""

from __future__ import annotations

import json
import types

import pytest
import torch

from benchmark import devtrace, harness

from conftest import REPO

BENCH = REPO / "benchmark"


def synthetic():
    """A 100 us window with two jobs: [0, 40] and [50, 100]. Kernels at
    [5, 15], [10, 30] (overlapping), [60, 90]; a copy at [35, 45] (half in
    the first job); a set at [95, 99]."""
    events = [
        (devtrace.WINDOW, "user_annotation", 0.0, 100.0),
        (devtrace.JOB, "user_annotation", 0.0, 40.0),
        (devtrace.JOB, "user_annotation", 50.0, 100.0),
        ("k1", "kernel", 5.0, 15.0),
        ("k2", "kernel", 10.0, 30.0),
        ("k1", "kernel", 60.0, 90.0),
        ("Memcpy DtoH", "gpu_memcpy", 35.0, 45.0),
        ("Memset", "gpu_memset", 95.0, 99.0),
        ("cudaMemcpy", "cuda_runtime", 33.0, 47.0),
        ("aten::copy_", "cpu_op", 32.0, 48.5),
        ("host work", "cpu_op", 0.0, 4.0),
    ]
    return devtrace.from_events(events)


def report(rank, **kw):
    """A rank's report as `harness.run` makes it."""
    return {"rank": rank, "card": rank, "uuid": f"GPU-{rank}", "memory_peak_bytes": 2**30,
            "allocations": 40, "other_cards_peak_bytes": 0, "jobs": 2, **kw}


def ctx(trace, reports=None, **kw):
    """A reader's context; its device block from `reports`, by default one
    rank's, with `trace`'s busy figures."""
    if reports is None:
        reports = [report(0, **(devtrace.busy(trace) if trace else {}))]
    base = dict(trace=trace, device_kind="NVIDIA H100 80GB HBM3", compute="float32",
                peaks=json.loads((BENCH / "peaks.json").read_text()),
                flop_per_job=0.0, bytes_per_job=0.0, jobs=2,
                device=harness.device_block(torch.device("cpu"), reports, trace is not None))
    base.update(kw)
    return types.SimpleNamespace(**base)


def test_union_clip_merged():
    assert devtrace.union([(0, 10), (5, 15), (20, 25), (21, 22)]) == 20
    assert devtrace.union([]) == 0
    assert devtrace.clip([(0, 10), (5, 15), (20, 25)], 8, 21) == [(8, 10), (8, 15), (20, 21)]
    assert devtrace.merged([(5, 15), (0, 10), (20, 25)]) == [(0, 15), (20, 25)]


def test_busy_in_spans_sees_an_interval_that_starts_before_the_span():
    assert devtrace.busy_in_spans([(0, 50), (60, 61), (70, 80)], [(40, 65), (75, 90)]) == [11, 5]


def test_trace_parts():
    t = synthetic()
    assert t.window == (0.0, 100.0) and t.jobs == [(0.0, 40.0), (50.0, 100.0)]
    assert t.kernels() == [(5.0, 15.0), (10.0, 30.0), (60.0, 90.0)]
    assert len(t.device_intervals()) == 5
    with pytest.raises(ValueError):
        devtrace.from_events([("k", "kernel", 0.0, 1.0)])


def test_readers_on_a_synthetic_trace():
    t = synthetic()
    read = {m: harness.reader(BENCH, m) for m in
            ("runner_ms_per_job", "kernels_roofline", "device_idle_pct")}
    # kernels inside the jobs: 25 us in the first (40 long), 30 in the
    # second (50 long): the runner holds 15 and 20 us
    assert read["runner_ms_per_job"](ctx(t)) == pytest.approx(17.5e-3)
    # device busy: [5, 30], [35, 45], [60, 90], [95, 99] = 69 of 100
    assert read["device_idle_pct"](ctx(t)) == pytest.approx(31.0)
    # least time a job: max(6.7e6 FLOP / 67e12 = 0.1 us, 0) -> two jobs
    # 0.2 us over 55 us of kernels
    c = ctx(t, flop_per_job=6.7e6)
    assert read["kernels_roofline"](c) == pytest.approx(100 * 0.2 / 55)
    # bytes bind: 3.35e6 B / 3.35e12 = 1 us a job
    c = ctx(t, flop_per_job=6.7e6, bytes_per_job=3.35e6)
    assert read["kernels_roofline"](c) == pytest.approx(100 * 2.0 / 55)
    # nothing to read: no trace, no kernels, or a card without peaks
    assert read["kernels_roofline"](ctx(None)) is None
    assert read["kernels_roofline"](ctx(t, device_kind="cpu")) is None
    assert read["runner_ms_per_job"](ctx(None)) is None
    assert read["device_idle_pct"](ctx(None)) is None


def test_on_two_ranks_the_readers_agree_with_the_device_block():
    """Rank 0 busy 69 us of its 100 (the synthetic trace), rank 1 95 of 100:
    device_idle_pct is the idle share that the result's busy_s and window_s
    give, and kernels_roofline holds rank 0's kernels to half the job's
    least time (the job's work shared by two cards)."""
    t = synthetic()
    roofline, idle = (harness.reader(BENCH, m) for m in ("kernels_roofline", "device_idle_pct"))
    other = report(1, busy_s=95e-6, window_s=100e-6, busy_share=0.95)
    two = ctx(t, [report(0, **devtrace.busy(t)), other], flop_per_job=6.7e6)
    d = two.device
    assert d["busy_s"] == pytest.approx(82e-6) and d["window_s"] == pytest.approx(100e-6)
    assert idle(two) == pytest.approx(100 * (1 - d["busy_s"] / d["window_s"]))
    assert idle(two) == pytest.approx(18.0) and idle(ctx(t)) == pytest.approx(31.0)
    assert roofline(two) == pytest.approx(roofline(ctx(t, flop_per_job=6.7e6)) / 2)
    assert d["count"] == 2 and [r["rank"] for r in d["ranks"]] == [0, 1]


def test_breakdown():
    t = synthetic()
    ops = devtrace.device_ops(t)
    assert ops[0] == ["k1", pytest.approx(40e-6)] and ops[1] == ["k2", pytest.approx(20e-6)]
    gaps = dict((k, v) for k, v in devtrace.idle_gaps(t))
    # gaps [0, 5] (host work), [30, 35], [45, 60], [90, 95], [99, 100]
    assert gaps["host work"] == pytest.approx(5e-6)
    assert sum(gaps.values()) == pytest.approx(31e-6)
    assert len(devtrace.idle_gaps(t, n=2)) == 2


def test_a_chrome_trace_reads_as_its_events():
    data = {"traceEvents": [
        {"ph": "X", "cat": "user_annotation", "name": devtrace.WINDOW, "ts": 10, "dur": 90},
        {"ph": "X", "cat": "user_annotation", "name": devtrace.JOB, "ts": 10, "dur": 40},
        {"ph": "X", "cat": "kernel", "name": "k", "ts": 12, "dur": 5},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts": 20, "dur": 2},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 11, "dur": 1},
        {"ph": "f", "cat": "ac2g", "name": "flow", "ts": 11},
        {"ph": "X", "cat": "gpu_user_annotation", "name": "x", "ts": 10, "dur": 90},
    ]}
    t = devtrace.from_chrome(data)
    assert t.window == (10.0, 100.0) and t.jobs == [(10.0, 50.0)]
    assert t.kernels() == [(12.0, 17.0)] and len(t.device) == 2
    assert ("cudaLaunchKernel", 11.0, 12.0) in t.host


def test_a_trace_of_one_card_leaves_out_the_device_events_of_others():
    """A rank's trace stands for its card: a copy this process made on
    another card is left out; host events and device events that name no
    card stay."""
    data = {"traceEvents": [
        {"ph": "X", "cat": "user_annotation", "name": devtrace.WINDOW, "ts": 0, "dur": 100},
        {"ph": "X", "cat": "kernel", "name": "k", "ts": 10, "dur": 5, "args": {"device": 1}},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts": 20, "dur": 30,
         "args": {"device": 0}},
        {"ph": "X", "cat": "gpu_memset", "name": "Memset", "ts": 60, "dur": 2},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaMemcpyAsync", "ts": 19, "dur": 31,
         "args": {"device": 0}},
    ]}
    assert len(devtrace.from_chrome(data).device) == 3
    t = devtrace.from_chrome(data, card=1)
    assert [name for name, *_ in t.device] == ["k", "Memset"]
    assert ("cudaMemcpyAsync", 19.0, 50.0) in t.host
