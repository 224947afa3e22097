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
of the job by the plain reference, in blocks of planes (`reference.compare`),
so an answer as large as the program's state on a card is never on the card
whole twice. The run prints the numbers compared, each beside its limit, as
the last lines of standard error, and one JSON object as the last line of
standard output.

A cell on n > 1 cards runs as n ranks, one process a card, started once a
run. Rank 0 is the process that was started; it starts ranks 1..n-1 as
the same command with the same arguments and `--rank r --group <dir>`.
Rank r drives cuda:r (`torch.cuda.set_device(r)` before anything touches a
card). The ranks meet in one process group (NCCL on the cards, gloo on the
CPU) through a `file://` rendezvous in a temporary directory, and a second
group on gloo carries the harness's own messages, so that they never queue
behind a card's work. A multi-device entry of the program called inside
that group runs on these ranks (`parallel.launch.run`'s in-group branch)
and starts none of its own. Every rank builds the job, warms it up and runs
the same jobs: before each job rank 0 decides by its clock whether another
starts and tells the others; a job ends when every rank has finished it
(a barrier on gloo), so the jobs' spans, the window and `setup_s` (rank
0's process start to the first job: the other ranks' start, imports and
the group's set-up included) are on rank 0's clock. With --trace 1 every
rank traces its window; the readers read rank 0's trace.

A driver of a multi-card cell writes to this interface:
  * `Job(config, config_dir, traffic, seed, device)` is built on every
    rank, with torch.distributed initialised and `device` this rank's card;
  * `run()` returns this rank's part of the answer (final state, av_vels),
    and `reference(storage)` this rank's part of the replay; `obstacle()`
    the obstacle cells of this rank's part of the state;
  * `updates`, `flop` and `bytes` count the whole job, over every rank.
`correct` is judged on each rank's part and reduced over the ranks, with no
gather (`judge`). The result's `device` block is measured: each rank
reports its card, its peak and its allocations in the window, and `count`
is the number of distinct cards that the window used (`cards_used`); a run
that used fewer cards than the cell asks for prints no result.

A driver of any cell may declare `last_state_only = True` on its Job, where
a job's state is too large to keep more than one (a state that fills most
of a card: the next job's state would not fit beside it, nor a run's states
on the host). Its `run()` may then hand back the state on the card, the
program's own. The window takes a digest of each job's state on the card
(`digest`: sums of its bits) and lets the previous job's state go before
the next job starts, so it holds one state; after the window the last
job's state is moved to the host (`keep_off_card`). The judge compares that
state in full, holds each earlier job to it by its digest (equal: the
kept state's numbers; not equal: it fails), and compares every job's
av_vels in full. This asks the program to give the same bits in every job
of a run, as every job starts from the same inputs: the program is
bit-deterministic on the state (the 3-D cells read `state_gap` 0 on every
seed). Drivers whose jobs can be kept whole keep them and leave it unset.

Failure never hangs a run. Set-up, every message of the harness between
ranks and the wait for the ranks' exit each have the limit TIMEOUT_S (600
s, as `parallel.launch.DEFAULT_TIMEOUT`); the program's own process group
has it too. Rank 0 watches the others: one that exits with an error, or a
run that makes no progress for TIMEOUT_S and a minute more, ends the run
with a message and no result, and rank 0 kills the other ranks. A rank
whose rank 0 is gone exits. The other ranks' standard output and error go
to rank 0's standard error, each line after "rank <r>: ", so the last line
of standard output is rank 0's result.
"""

from __future__ import annotations

import argparse
import contextlib
import datetime
import importlib.util
import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
# top-level modules that must not be loaded in a run (compared whole: the
# program's name begins with the JAX package's)
FORBIDDEN = ("jax", "jaxlib", "flax", "lbm_tpu")
# seconds: set-up, each message between ranks, the ranks' exit
TIMEOUT_S = 600.0
# values of a state a chunk of `digest` takes (256 MB as int64)
DIGEST_VALUES = 1 << 25
# the range around each digest of a job's state in a traced window
DIGEST = "benchmark: digest"
# seconds beyond TIMEOUT_S without progress after which rank 0's watch ends
# the run (a rank stuck in the program's own collectives)
GRACE_S = 60.0


class NoDevice(RuntimeError):
    """The host lacks the cards a cell asks for."""


def process_age_s() -> float:
    """Seconds since this process started (/proc/self/stat's start time
    against the boot clock; 10 ms resolution)."""
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


def require_devices(n: int, rank: int = 0):
    """This rank's CUDA card, cuda:rank, once the host is seen to hold `n`
    of them; in a run of n > 1 ranks it becomes the current device."""
    import torch

    if not torch.cuda.is_available():
        raise NoDevice("no CUDA device: the benchmark measures the card and never falls back "
                       "to the CPU")
    if torch.cuda.device_count() < n:
        raise NoDevice(f"the cell asks for {n} CUDA devices and the host has "
                       f"{torch.cuda.device_count()}")
    if n > 1:
        torch.cuda.set_device(rank)
    return torch.device("cuda", rank)


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


class Group:
    """This rank's place in the ranks of a multi-card run: `rank`, `size`,
    and `control`, the gloo group of the harness's own messages. `ranks`
    is rank 0's Ranks (None on the others): every message marks progress
    for its watch."""

    def __init__(self, rendezvous: str, rank: int, size: int, device, ranks=None):
        import torch.distributed as dist

        timeout = datetime.timedelta(seconds=TIMEOUT_S)
        dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                                init_method=f"file://{Path(rendezvous) / 'rendezvous'}",
                                world_size=size, rank=rank, timeout=timeout)
        self.control = dist.new_group(backend="gloo", timeout=timeout)
        self.rank, self.size, self.ranks = rank, size, ranks
        self.progress()

    def progress(self):
        if self.ranks is not None:
            self.ranks.progress()

    def barrier(self):
        """Returns when every rank has reached it; rank 0 names a rank that
        does not come within TIMEOUT_S."""
        import torch.distributed as dist

        dist.monitored_barrier(self.control, timeout=datetime.timedelta(seconds=TIMEOUT_S),
                               wait_all_ranks=True)
        self.progress()

    def decide(self, go: bool) -> bool:
        """Rank 0's `go`, on every rank."""
        import torch
        import torch.distributed as dist

        flag = torch.tensor([int(go)])
        dist.broadcast(flag, 0, group=self.control)
        return bool(flag.item())

    def max(self, t):
        """The elementwise maximum of `t` (a CPU tensor) over the ranks."""
        import torch.distributed as dist

        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.control)
        self.progress()
        return t

    def gather(self, obj) -> list | None:
        """[each rank's obj] on rank 0, None on the others."""
        import torch.distributed as dist

        out = [None] * self.size if self.rank == 0 else None
        dist.gather_object(obj, out, dst=0, group=self.control)
        self.progress()
        return out

    def close(self):
        import torch.distributed as dist

        dist.destroy_process_group()


class Ranks:
    """Ranks 1..n-1 of a multi-card run, as rank 0 starts and watches them:
    each the same command with `--rank r --group <dir>`; their output to
    this process's standard error, line by line after "rank <r>: ". A watch
    thread ends the run (`os._exit`) when a rank exits with an error, or
    when no progress has been marked for TIMEOUT_S + GRACE_S.

    Not torch.multiprocessing.start_processes: its children write to rank
    0's own standard output, where a rank's line could follow the result,
    and re-routed inside a child they would carry the prefix only on what
    Python writes, not on what CUDA and NCCL write; and it starts
    multiprocessing's resource tracker, a process beside the ranks that
    outlives them until rank 0 exits (both seen on the CPU, torch 2.13). Its
    `join(timeout)` would stand in for the exit check of the watch alone."""

    def __init__(self, n: int, command: list[str]):
        self.dir = tempfile.mkdtemp(prefix="benchmark_ranks_")
        self.last = time.monotonic()
        self.done = False
        self.procs, self.threads = [], []
        for r in range(1, n):
            proc = subprocess.Popen(command + ["--rank", str(r), "--group", self.dir],
                                    stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                                    stderr=subprocess.PIPE, text=True, bufsize=1)
            self.procs.append(proc)
            for stream in (proc.stdout, proc.stderr):
                t = threading.Thread(target=self._forward, args=(r, stream), daemon=True)
                t.start()
                self.threads.append(t)
        threading.Thread(target=self._watch, daemon=True).start()

    @staticmethod
    def _forward(rank: int, stream):
        for line in stream:
            sys.stderr.write(f"rank {rank}: {line}")
        sys.stderr.flush()

    def progress(self):
        self.last = time.monotonic()

    def _watch(self):
        while not self.done:
            time.sleep(0.2)
            failed = [(r, p.returncode) for r, p in enumerate(self.procs, 1)
                      if p.poll() not in (None, 0)]
            if self.done:
                return
            if failed:
                why = ", ".join(f"rank {r} exited with code {code}" for r, code in failed)
            elif time.monotonic() - self.last > TIMEOUT_S + GRACE_S:
                why = f"no progress for {TIMEOUT_S + GRACE_S:.0f} s"
            else:
                continue
            self.kill()
            print(f"benchmark: {why}: the run ends with no result", file=sys.stderr, flush=True)
            os._exit(3)

    def kill(self):
        self.done = True
        for p in self.procs:
            if p.poll() is None:
                p.kill()
        for p in self.procs:
            with contextlib.suppress(subprocess.TimeoutExpired):
                p.wait(10)
        shutil.rmtree(self.dir, ignore_errors=True)

    def finish(self) -> list[int]:
        """Waits for every rank's exit (TIMEOUT_S) and the end of its output;
        returns their exit codes."""
        deadline = time.monotonic() + TIMEOUT_S
        codes = []
        for p in self.procs:
            try:
                codes.append(p.wait(max(0.0, deadline - time.monotonic())))
            except subprocess.TimeoutExpired:
                codes.append(None)
        self.done = True
        for t in self.threads:
            t.join(10)
        self.kill()
        return codes


def _orphan_watch():
    """On ranks 1..n-1: exit when rank 0 is gone (the end of standard
    input, which rank 0 holds open)."""
    def watch():
        sys.stdin.read()
        os._exit(5)

    threading.Thread(target=watch, daemon=True).start()


def _allocations(device) -> int:
    import torch

    return torch.cuda.memory_stats(device).get("allocation.all.allocated", 0)


def card_start(device) -> int | None:
    """Resets every card's peak in this process; returns the allocations
    made on `device` so far, which card_report counts from (None on the
    CPU)."""
    if device.type != "cuda":
        return None
    import torch

    for i in range(torch.cuda.device_count()):
        torch.cuda.reset_peak_memory_stats(i)
    return _allocations(device)


def card_report(device, start: int | None) -> dict:
    """This rank's card and its use since card_start: `card` (index), `uuid`,
    `memory_peak_bytes` (the peak allocated on it, the window's),
    `allocations` (made on it) and `other_cards_peak_bytes` (the largest
    peak this process left on another card). On the CPU, a test run's
    device: the process, its peak resident set, allocations unknown."""
    if device.type != "cuda":
        import resource

        return {"card": None, "uuid": f"cpu-{os.getpid()}",
                "memory_peak_bytes": resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024,
                "allocations": None, "other_cards_peak_bytes": 0}
    import torch

    others = [torch.cuda.max_memory_allocated(i) for i in range(torch.cuda.device_count())
              if i != device.index]
    uuid = getattr(torch.cuda.get_device_properties(device), "uuid", f"cuda:{device.index}")
    return {"card": device.index, "uuid": str(uuid),
            "memory_peak_bytes": torch.cuda.max_memory_allocated(device),
            "allocations": _allocations(device) - start,
            "other_cards_peak_bytes": max(others, default=0)}


def cards_used(reports: list[dict]) -> tuple[int, list[str]]:
    """(the number of distinct cards that the ranks' windows used, a line
    for each rank that used none). A rank uses its card when its window left
    a peak on it and shows work there: allocations in the window (unknown on
    the CPU), or traced busy time on it. A lone rank needs the peak alone: no
    other process can have done its work, and a window that allocates
    nothing (CUDA graphs, buffers kept from set-up) is no idle one. A second
    rank on a card already counted adds none."""
    seen, idle = set(), []
    for r in reports:
        worked = len(reports) == 1 or r["allocations"] != 0 or r.get("busy_s", 0) > 0
        if r["uuid"] in seen:
            idle.append(f"rank {r['rank']} (card {r['card']}, {r['uuid']}: another rank's card)")
        elif r["memory_peak_bytes"] > 0 and worked:
            seen.add(r["uuid"])
        else:
            idle.append(f"rank {r['rank']} (card {r['card']}, {r['uuid']}: idle)")
    return len(seen), idle


def device_block(device, reports: list[dict], traced: bool) -> dict:
    """The result's `device`, from every rank's report: `count`
    (cards_used), the fullest card's peak, traced `busy_s` and `window_s`
    as means over the ranks (so the idle share worked out from them is
    device_idle_pct's), and the reports under `ranks`."""
    import torch

    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": cards_used(reports)[0],
           "memory_peak_bytes": max(r["memory_peak_bytes"] for r in reports)}
    if traced:
        for key in ("busy_s", "window_s"):
            dev[key] = sum(r[key] for r in reports) / len(reports)
    dev["ranks"] = reports
    return dev


def digest(f) -> tuple[int, int]:
    """(plain, position-weighted) sums modulo 2**64 of the bits of a state
    (q, ...), each value read as the signed integer of its width, on the
    state's device: equal for states that are equal bit for bit, and
    different for one value altered. Taken a chunk of f[k] at a time (at
    most DIGEST_VALUES values), so no temporary is the size of the state."""
    import torch

    itype = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}[f.element_size()]
    plain = weighted = torch.zeros((), dtype=torch.int64, device=f.device)
    offset = 0
    for k in range(f.shape[0]):
        fk = f[k].reshape(-1, f.shape[-1])
        rows = max(1, DIGEST_VALUES // fk.shape[1])
        for a in range(0, fk.shape[0], rows):
            v = fk[a:a + rows].view(itype).to(torch.int64)
            r, c = v.shape
            row_sums, col_sums = v.sum(dim=1), v.sum(dim=0)
            total = row_sums.sum()
            # sum over values of (offset + r_i * c + c_i + 1) * value
            weighted = (weighted + offset * total
                        + c * (torch.arange(r, device=v.device) * row_sums).sum()
                        + (torch.arange(1, c + 1, device=v.device) * col_sums).sum())
            plain = plain + total
            offset += r * c
            del v, row_sums, col_sums
    return int(plain), int(weighted)


def window(job, seconds: float, device, traced: bool, group: Group | None = None):
    """Jobs back to back for `seconds`. Returns (outputs: each job's (final
    state, av_vels), the states' digests or None, host spans of the jobs,
    the profiler or None). On ranks, rank 0 decides before each job whether
    it starts, and a job ends at a barrier of every rank.

    For a job whose `last_state_only` is true, each job's state is digested
    (`digest`, after the job's span) and the previous job's state is let go
    before the next job starts: the state of the last job alone is kept
    (the others' entries hold None), so the window holds one state."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from . import devtrace

    last_only = getattr(job, "last_state_only", False)
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda"
                                           else [])
    prof = profile(activities=activities) if traced else contextlib.nullcontext()
    outputs, spans, digests = [], [], ([] if last_only else None)
    with prof:
        with record_function(devtrace.WINDOW):
            start = time.perf_counter()
            while True:
                go = time.perf_counter() - start < seconds
                if not (group.decide(go) if group else go):
                    break
                if last_only and outputs:
                    outputs[-1] = (None, outputs[-1][1])
                t0 = time.perf_counter()
                with record_function(devtrace.JOB):
                    outputs.append(job.run())
                    _sync(device)
                    if group:
                        group.barrier()
                spans.append((t0, time.perf_counter()))
                if last_only:
                    with record_function(DIGEST):
                        digests.append(digest(outputs[-1][0]))
    return outputs, digests, spans, (prof if traced else None)


def keep_off_card(outputs: list) -> int:
    """Moves the states that `outputs` keeps on a card to the host, one at a
    time, and returns the bytes they take there. Pageable memory: the
    caching host allocator rounds a pinned block up to a power of two, 64
    GiB for a 40.8 GB state."""
    import torch

    held = 0
    for i, (f, av) in enumerate(outputs):
        if isinstance(f, torch.Tensor) and f.device.type == "cuda":
            outputs[i] = (f.cpu(), av)
            del f
        if isinstance(outputs[i][0], torch.Tensor):
            held += outputs[i][0].nbytes
    return held


def judge(job, outputs, storage=None, group: Group | None = None, digests=None) -> list[dict]:
    """compare.gaps of each output against one replay of the job by the
    reference, at the cell's storage type (or `storage`). On ranks, each
    compares its part of the answer with its part of the replay, and the
    parts (compare.parts) are reduced by their maximum over the ranks before
    the division: the gaps of the whole answer, with no gather.

    With `digests` (a window of `last_state_only`), the one state kept, the
    last job's, is compared in full, and an earlier job's state counts as
    the kept one's where its digest is equal, and fails each state number
    where it is not; every job's av_vels is compared in full. Prints on
    standard error the seconds of the replay and of the comparison."""
    import torch

    from .reference import compare

    t0 = time.perf_counter()
    ref_f, ref_av = job.reference(storage or job.dtype)
    obstacle = job.obstacle()
    _sync(ref_f.device)
    t1 = time.perf_counter()
    states = [None if f is None else compare.state_parts(f, ref_f, job.speed, obstacle)
              for f, _ in outputs]
    if digests is not None:
        kept = {digests[i]: s for i, s in enumerate(states) if s is not None}
        differs = torch.stack([*compare.MISMATCH, *compare.MISMATCH])
        states = [kept.get(digests[i], differs) if s is None else s for i, s in enumerate(states)]
    rows = [compare.finish(torch.cat([s, compare.av_parts(av, ref_av)]))
            for s, (_, av) in zip(states, outputs)]
    print(f"benchmark: replay {t1 - t0:.3f} s, comparison {time.perf_counter() - t1:.3f} s",
          file=sys.stderr)
    parts = torch.stack(rows)
    if group:
        parts = group.max(parts)
    return [compare.ratios(p) for p in parts]


def run(root: Path, workload: str, seed: int, seconds: float, traced: bool, device,
        setup_start: float, group: Group | None = None) -> dict | None:
    """One run of `workload` on `device`; `setup_start` is the process's
    start on the perf_counter clock. Returns the result's fields (on ranks:
    rank 0's, None on the others)."""
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
    if group:
        group.barrier()
        phases.append(("the other ranks", time.perf_counter()))
    setup_s = time.perf_counter() - setup_start
    print("benchmark: set-up " + ", ".join(
        f"{name} {t - (phases[i - 1][1] if i else setup_start):.3f} s"
        for i, (name, t) in enumerate(phases)), file=sys.stderr)
    # the peak of the window's jobs, not of the set-up's temporaries
    start = card_start(device)
    outputs, digests, spans, prof = window(job, seconds, device, traced, group)
    report = {"rank": group.rank if group else 0, **card_report(device, start),
              "jobs": len(spans)}
    if digests is not None:
        t0 = time.perf_counter()
        held = keep_off_card(outputs)
        print(f"benchmark: the last job's state kept, {held} B on the host, moved there in "
              f"{time.perf_counter() - t0:.3f} s", file=sys.stderr)
    card_start(device)
    parsed = (devtrace.from_profiler(prof, device.index if device.type == "cuda" else None)
              if prof is not None else None)
    del prof
    if parsed is not None:
        report.update(devtrace.busy(parsed))
    job.release()
    rows, names = judge(job, outputs, group=group, digests=digests), list(c.limits)
    del outputs
    if device.type == "cuda":
        import torch

        print(f"benchmark: peak {torch.cuda.max_memory_allocated(device)} B on the card in "
              f"the replay and the comparison", file=sys.stderr)
    reports = group.gather(report) if group else [report]
    if reports is None:
        return None
    print("benchmark: jobs " + " ".join(f"{b - a:.4f}" for a, b in spans) + " s", file=sys.stderr)
    worst = {n: max(r[n] for r in rows) for n in names}
    failed = sum(1 for r in rows if any(not r[n] <= c.limits[n] for n in names))
    dev = device_block(device, reports, parsed is not None)
    ctx = types.SimpleNamespace(
        setup_s=setup_s, jobs=len(spans), window_s=spans[-1][1] - spans[0][0],
        updates=job.updates * len(spans), flop_per_job=job.flop, bytes_per_job=job.bytes,
        compute=job.compute, device_kind=dev["kind"], device=dev,
        peaks=json.loads((c.bench / "peaks.json").read_text()), trace=parsed)
    metrics = {}
    for m in wanted:
        value = reader(c.bench, m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {"correct": failed == 0, "attempted": len(spans), "failed": failed,
              "metrics": metrics, "device": dev}
    if parsed is not None:
        result["breakdown"] = {"device_ops": devtrace.device_ops(parsed),
                               "idle_gaps": devtrace.idle_gaps(parsed)}
    result["checks"] = {n: {"value": worst[n], "limit": c.limits[n]} for n in names}
    return result


def _command(argv) -> list[str]:
    """This process's command (the interpreter, its options and the script)
    with the arguments `argv`: how rank 0 starts the other ranks."""
    script = sys.orig_argv[:len(sys.orig_argv) - len(sys.argv) + 1]
    return [sys.executable] + script[1:] + list(argv)


def main(argv=None, devices=require_devices) -> int:
    """A run as the command line asks; `devices(n, rank)` gives this rank's
    device once the host is seen to hold n (the tests give the CPU)."""
    setup_start = time.perf_counter() - process_age_s()
    argv = sys.argv[1:] if argv is None else list(argv)
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    # set by rank 0 on the ranks it starts
    parser.add_argument("--rank", type=int, default=0, help=argparse.SUPPRESS)
    parser.add_argument("--group", help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    spec = load_spec(ROOT)
    chips = _named(spec["workloads"], args.workload, "workload")["chips"]
    ranks = None
    if chips > 1 and args.rank == 0:
        ranks = Ranks(chips, _command(argv))
        args.group = ranks.dir
    elif args.rank:
        _orphan_watch()
    try:
        return _main(args, chips, setup_start, devices, ranks)
    finally:
        if ranks is not None:
            ranks.kill()


def _main(args, chips: int, setup_start: float, devices, ranks) -> int:
    rank = args.rank
    try:
        device = devices(chips, rank)
    except NoDevice as exc:
        print(f"benchmark: {exc}", file=sys.stderr)
        return 2
    group = Group(args.group, rank, chips, device, ranks) if chips > 1 else None
    result = run(ROOT, args.workload, args.seed, args.seconds, bool(args.trace), device,
                 setup_start, group)
    loaded = group.gather(forbidden_modules()) if group else [forbidden_modules()]
    if group:
        group.close()
    if rank:
        return 0
    if ranks is not None:
        codes = ranks.finish()
        if any(code != 0 for code in codes):
            print(f"benchmark: the other ranks exited with {codes}: no result", file=sys.stderr)
            return 3
    print(f"benchmark: card {card_line()}", file=sys.stderr)
    bad = {r: names for r, names in enumerate(loaded) if names}
    if bad:
        print(f"benchmark: the run loaded {bad} (by rank): the program must not use the JAX "
              f"package", file=sys.stderr)
        return 3
    count, idle = cards_used(result["device"]["ranks"])
    if count < chips:
        print(f"benchmark: the cell asks for {chips} cards and the run used {count}; unused: "
              f"{'; '.join(idle)}: no result", file=sys.stderr)
        return 4
    for name, check in result["checks"].items():
        print(f"check {name} {check['value']!r} limit {check['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0
