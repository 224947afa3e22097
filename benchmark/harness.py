"""One run of one cell of the benchmark.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

The harness is driven by data. It finds, by the names in BENCHMARK.json:
  * the cell (`workloads`), its configuration's file (`configs[].file`),
    its traffic mix `traffic/<traffic>.json` and its limits
    `limits/<workload>.json`;
  * the job driver `drivers/<driver>.py` that the configuration's file
    names: it builds a job's inputs from the seed, runs a job through the
    program's own entry, and replays it with the plain reference;
  * one reader `metrics/<metric>.py` for each metric the cell reports:
    `read(ctx)` returns the number, or None where it finds nothing to read.

A run: set-up (the program's imports, the card, the inputs from the seed,
a short warm-up job of the cell's own shapes), then jobs back to back for
`--seconds`: a job started in the window runs to its end, and the window
closes at the end of the last. With --trace 1 the window runs under
torch.profiler and the per-layer metrics are read from its trace, else the
end-to-end metrics from the host's clock. Once the window has closed the
program's state is freed and every job's answer is compared with one replay
of the job by the plain reference. The run prints the numbers compared, each
beside its limit, as the last lines of standard error, and one JSON object
as the last line of standard output.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib.util
import json
import subprocess
import sys
import time
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
# top-level modules that must not be loaded in a run (compared whole: the
# program's name begins with the JAX package's)
FORBIDDEN = ("jax", "jaxlib", "flax", "lbm_tpu")


class NoDevice(RuntimeError):
    """The host lacks the cards a cell asks for."""


def process_age_s() -> float:
    """Seconds since this process started (/proc/self/stat's start time
    against the boot clock; 10 ms resolution)."""
    import os

    fields = Path("/proc/self/stat").read_text().rsplit(")", 1)[1].split()
    start = int(fields[19]) / os.sysconf("SC_CLK_TCK")
    return time.clock_gettime(time.CLOCK_BOOTTIME) - start


def load_spec(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _named(items: list, name: str, what: str) -> dict:
    for item in items:
        if item["name"] == name:
            return item
    raise SystemExit(f"no {what} named {name!r} in BENCHMARK.json; "
                     f"choose from {[i['name'] for i in items]}")


def cell(spec: dict, workload: str, root: Path = ROOT) -> types.SimpleNamespace:
    """Everything that a run of `workload` reads, found by name."""
    w = _named(spec["workloads"], workload, "workload")
    c = _named(spec["configs"], w["config"], "configuration")
    config_file = root / c["file"]
    bench = config_file.parent.parent
    return types.SimpleNamespace(
        config=json.loads(config_file.read_text()), config_dir=config_file.parent,
        traffic=json.loads((bench / "traffic" / f"{w['traffic']}.json").read_text()),
        limits=json.loads((bench / "limits" / f"{workload}.json").read_text()),
        bench=bench)


def metrics_of(spec: dict, workload: str, trace: bool) -> list[dict]:
    """The metrics a run of `workload` asks its readers for: the end-to-end
    metrics, or with a trace the per-layer metrics. A reader that finds
    nothing to read in the cell returns None, and the run leaves it out."""
    return spec["per_layer"] if trace else spec["end_to_end"]


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def reader(bench: Path, metric: str):
    return load_module(bench / "metrics" / f"{metric}.py", f"benchmark_metric_{metric}").read


def driver(bench: Path, name: str):
    return load_module(bench / "drivers" / f"{name}.py", f"benchmark_driver_{name}")


def require_devices(n: int):
    """The first CUDA card, once the host is seen to hold `n` of them."""
    import torch

    if not torch.cuda.is_available():
        raise NoDevice("no CUDA device: the benchmark measures the card and never falls back "
                       "to the CPU")
    if torch.cuda.device_count() < n:
        raise NoDevice(f"the cell asks for {n} CUDA devices and the host has "
                       f"{torch.cuda.device_count()}")
    return torch.device("cuda", 0)


def card_line() -> str:
    """The card's name and power limit as nvidia-smi reads them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else out.stderr.strip()
    except (OSError, subprocess.TimeoutExpired, IndexError) as exc:
        return f"nvidia-smi: {exc}"


def forbidden_modules() -> list[str]:
    return sorted(m for m in sys.modules if m.split(".", 1)[0] in FORBIDDEN)


def _sync(device):
    if device.type == "cuda":
        import torch

        torch.cuda.synchronize(device)


def window(job, seconds: float, device, traced: bool):
    """Jobs back to back for `seconds`. Returns (outputs, host spans of the
    jobs, the profiler or None)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from . import devtrace

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda"
                                           else [])
    prof = profile(activities=activities) if traced else contextlib.nullcontext()
    outputs, spans = [], []
    with prof:
        with record_function(devtrace.WINDOW):
            start = time.perf_counter()
            while time.perf_counter() - start < seconds:
                t0 = time.perf_counter()
                with record_function(devtrace.JOB):
                    outputs.append(job.run())
                    _sync(device)
                spans.append((t0, time.perf_counter()))
    return outputs, spans, (prof if traced else None)


def judge(job, outputs, storage=None) -> list[dict]:
    """compare.gaps of each output against one replay of the job by the
    reference, at the cell's storage type (or `storage`)."""
    from .reference import compare

    ref_f, ref_av = job.reference(storage or job.dtype)
    obstacle = job.obstacle()
    return [compare.gaps(f, av, ref_f, ref_av, job.speed, obstacle) for f, av in outputs]


def run(root: Path, workload: str, seed: int, seconds: float, traced: bool, device,
        setup_start: float) -> dict:
    """One run of `workload` on `device`; `setup_start` is the process's
    start on the perf_counter clock. Returns the result's fields."""
    import torch

    from . import devtrace

    spec = load_spec(root)
    c = cell(spec, workload, root)
    wanted = metrics_of(spec, workload, traced)
    phases = [("imports", time.perf_counter())]
    job = driver(c.bench, c.config["driver"]).Job(c.config, c.config_dir, c.traffic, seed,
                                                  device)
    _sync(device)
    phases.append(("inputs", time.perf_counter()))
    job.warm_up()
    _sync(device)
    phases.append(("warm-up", time.perf_counter()))
    setup_s = time.perf_counter() - setup_start
    print("benchmark: set-up " + ", ".join(
        f"{name} {t - (phases[i - 1][1] if i else setup_start):.3f} s"
        for i, (name, t) in enumerate(phases)), file=sys.stderr)
    if device.type == "cuda":
        # the peak of the window's jobs, not of the set-up's temporaries
        torch.cuda.reset_peak_memory_stats(device)
    outputs, spans, prof = window(job, seconds, device, traced)
    print("benchmark: jobs " + " ".join(f"{b - a:.4f}" for a, b in spans) + " s", file=sys.stderr)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    parsed = devtrace.from_profiler(prof) if prof is not None else None
    del prof
    job.release()
    rows, names = judge(job, outputs), list(c.limits)
    del outputs
    worst = {n: max(r[n] for r in rows) for n in names}
    failed = sum(1 for r in rows if any(not r[n] <= c.limits[n] for n in names))
    ctx = types.SimpleNamespace(
        setup_s=setup_s, jobs=len(spans), window_s=spans[-1][1] - spans[0][0],
        updates=job.updates * len(spans), flop_per_job=job.flop, bytes_per_job=job.bytes, compute=job.compute,
        device_kind=(torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"),
        peaks=json.loads((c.bench / "peaks.json").read_text()), trace=parsed)
    metrics = {}
    for m in wanted:
        value = reader(c.bench, m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": ctx.device_kind, "count": 1, "memory_peak_bytes": peak}
    result = {"correct": failed == 0, "attempted": len(spans), "failed": failed, "metrics": metrics, "device": dev}
    if parsed is not None:
        lo, hi = parsed.window
        dev["busy_s"] = devtrace.union(devtrace.clip(parsed.device_intervals(), lo, hi)) / 1e6
        dev["window_s"] = (hi - lo) / 1e6
        result["breakdown"] = {"device_ops": devtrace.device_ops(parsed),
                               "idle_gaps": devtrace.idle_gaps(parsed)}
    result["checks"] = {n: {"value": worst[n], "limit": c.limits[n]} for n in names}
    return result


def main(argv=None) -> int:
    setup_start = time.perf_counter() - process_age_s()
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    spec = load_spec()
    chips = _named(spec["workloads"], args.workload, "workload")["chips"]
    try:
        device = require_devices(chips)
    except NoDevice as exc:
        print(f"benchmark: {exc}", file=sys.stderr)
        return 2
    result = run(ROOT, args.workload, args.seed, args.seconds, bool(args.trace), device,
                 setup_start)
    print(f"benchmark: card {card_line()}", file=sys.stderr)
    bad = forbidden_modules()
    if bad:
        print(f"benchmark: the run loaded {bad}: the program must not use the JAX package",
              file=sys.stderr)
        return 3
    for name, check in result["checks"].items():
        print(f"check {name} {check['value']!r} limit {check['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0
