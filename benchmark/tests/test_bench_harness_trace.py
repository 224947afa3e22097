"""The interval arithmetic of the per-layer metrics, on synthetic traces."""

from __future__ import annotations

import json
import types

import pytest

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


def ctx(trace, **kw):
    base = dict(trace=trace, device_kind="NVIDIA H100 80GB HBM3", compute="float32",
                peaks=json.loads((BENCH / "peaks.json").read_text()),
                flop_per_job=0.0, bytes_per_job=0.0, jobs=2)
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
