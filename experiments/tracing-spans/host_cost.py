"""The host's time to enqueue an engine loop's pass, with and without a
profiler running, at each benchmark cell's own grid, storage and engine.

A long sleep kernel is queued first, so the card is busy while the host
enqueues the loop and the launch queue never fills: the host's time of the
call is then its own cost, with no wait on the card in it. The loop runs
at three pass counts; the slope between them is the cost of a pass (the
call's set-up cancels, a sync in it too: the 2-D entry's waits out the
sleep before its loop), and the two slopes agree while the queue has
room. `card_after_s_min` > 0 shows the loop was enqueued ahead of the card.
The same is done inside a torch.profiler trace with CPU and CUDA activity,
as `benchmark/run.py --trace 1` records it, which also gives the pass
ranges' mean length. Prints one JSON line per cell.

    python3 experiments/tracing-spans/host_cost.py --root <checkout> \
        [--cells d2q9-cavity.f32 ...] [--passes 20 70 120] [--trials 5]

`--root` is the checkout whose program runs (default: this one); the
cells are read from this checkout's benchmark.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parents[2]
CELLS = ("d2q9-cavity.f32", "d3q19-channel.f32", "d3q19-channel.bf16")
PASS = "lbm_tpu_torch: pass"
# about 0.2 s of a 2 GHz card's clock: longer than any call's enqueue here
SLEEP_CYCLES = 400_000_000


def loop_of(job, device):
    """A callable that runs the cell's engine loop for n passes from the
    job's start state, as its entry point runs it (n K=4 passes, or as
    many steps in passes of the engine's own K)."""
    if hasattr(job, "params"):  # the 2-D entry, run_simulation's engine
        from lbm_tpu_torch.core import state
        from lbm_tpu_torch.models import lbm
        from lbm_tpu_torch.ops import d2q9, d2q9_kstep, d2q9_kstep_inplace, d2q9_kstep_manual

        p = job.params
        engine = job.engine if job.engine != "auto" else lbm.choose_engine(p, job.dtype, device)
        simulate = {"torch": d2q9.simulate, "cuda": d2q9_kstep.simulate,
                    "cuda-inplace": d2q9_kstep_inplace.simulate,
                    "cuda-manual": d2q9_kstep_manual.simulate}[engine]
        f0, mask = state.to_torch(state.initial_distributions(p, lbm.host_dtype(job.dtype)),
                                  job.obstacles.mask, device=device)
        k = d2q9_kstep.PREFERRED_K
        return lambda n: simulate(dataclasses.replace(p, max_iters=n * k), f0, mask)

    from lbm_tpu_torch.core import state
    from lbm_tpu_torch.ops import d3q19

    f, mask = state.to_torch3d(job.f_host, job.mask, device=device)
    f0 = f.clone()

    def run(n):
        f.copy_(f0)
        return d3q19.advance(f, mask, num_steps=n * 4, engine=job.engine, **job.kw)

    return run


def timed(call, n, device):
    """(host seconds of call(n), seconds the card ran on after it)."""
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda._sleep(SLEEP_CYCLES)
    t0 = time.perf_counter()
    call(n)
    t1 = time.perf_counter()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return t1 - t0, time.perf_counter() - t1


def slopes(rows, counts):
    """Median over trials of the host us per unit of n between each pair of
    counts."""
    out = []
    for a, b in zip(counts, counts[1:]):
        out.append(statistics.median((r[b][0] - r[a][0]) / (b - a) * 1e6 for r in rows))
    return out


def measure(call, counts, trials, device, traced):
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda"
                                           else [])
    rows = []
    prof = profile(activities=activities) if traced else None
    if prof is not None:
        prof.__enter__()
    try:
        for _ in range(trials):
            rows.append({n: timed(call, n, device) for n in counts})
    finally:
        if prof is not None:
            prof.__exit__(None, None, None)
    out = {"slopes_us": slopes(rows, counts),
           "host_s_max": max(r[counts[-1]][0] for r in rows),
           "card_after_s_min": min(r[counts[-1]][1] for r in rows)}
    if prof is not None:
        # the host's ranges; with CUDA activity each has a device-side copy too
        spans = [e for e in prof.events()
                 if e.name == PASS and e.device_type == torch.autograd.DeviceType.CPU]
        out["pass_spans"] = len(spans)
        out["pass_span_us_mean"] = statistics.fmean(
            e.time_range.end - e.time_range.start for e in spans) if spans else None
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--root", type=Path, default=HERE)
    parser.add_argument("--cells", nargs="+", default=list(CELLS))
    parser.add_argument("--passes", nargs=3, type=int, default=[20, 70, 120])
    parser.add_argument("--trials", type=int, default=5)
    args = parser.parse_args()
    root = args.root.resolve()
    sys.path.insert(0, str(root))
    sys.path.insert(1, str(HERE))

    import torch

    import lbm_tpu_torch
    from benchmark import harness

    if Path(lbm_tpu_torch.__file__).resolve().parents[1] != root:
        raise SystemExit(f"the program was imported from {lbm_tpu_torch.__file__}, not {root}")
    device = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    spec = harness.load_spec(HERE)
    for workload in args.cells:
        c = harness.cell(spec, workload, HERE)
        job = harness.driver(c.bench, c.config["driver"]).Job(c.config, c.config_dir, c.traffic,
                                                              2**31 + 7, device)
        call = loop_of(job, device)
        for n in args.passes:
            timed(call, n, device)  # builds and loads the kernels
        plain = measure(call, args.passes, args.trials, device, traced=False)
        traced = measure(call, args.passes, args.trials, device, traced=True)
        # passes a unit of n: 1 at K=4, taken as 1 where the program
        # records no pass range
        per_n = traced["pass_spans"] / (args.trials * sum(args.passes)) or 1.0
        for m in (plain, traced):
            m["us_per_pass"] = [v / per_n for v in m.pop("slopes_us")]
        print(json.dumps({"workload": workload, "root": str(root), "passes": args.passes,
                          "untraced": plain, "traced": traced,
                          "passes_per_n": per_n,
                          "ratio": traced["us_per_pass"][-1] / plain["us_per_pass"][-1]}),
              flush=True)
        del call, job
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
