"""Profiling, tracing, ahead-of-time export and NaN checks of the port.

The counterpart of `lbm_tpu.utils.profiling`:
  * `timed` — wall-clock timing of a block (the reference's timedStep);
  * `trace` — a `torch.profiler` trace of a block, written as Chrome trace
    JSON; on the card it names each hand-written kernel and times it on the
    device (CUPTI). `TIMED_RUN` marks the timed run of an entry point in it,
    and `kernel_summary` reads a trace back: launches and device time of
    each kernel, and the device's idle share in that run's window;
  * `dump_graph` — the `torch.export` graph of a function as text (the
    counterpart of `dump_hlo`);
  * `set_build_dir` — where the kernels and the native library are built,
    keyed by host (the counterpart of `enable_compilation_cache`);
  * `export_step` / `load_step` — a module exported with `torch.export` to
    a file and loaded back (the counterpart of `export_executable` /
    `load_executable`: the reference's compile-then-run split);
  * `enable_nan_debugging` — each engine's run checks its state for NaN
    after every launch, step or chunk and raises FloatingPointError at the
    first (the counterpart of `jax_debug_nans`). Off, the engines add
    nothing: no check and no synchronisation;
  * `device_memory_stats` — `torch.cuda.memory_stats` of each device.
"""

from __future__ import annotations

import contextlib
import json
import os
import sys
import time
from pathlib import Path

import torch

# the name of the range an entry point records around its timed run
TIMED_RUN = "lbm_tpu_torch: timed run"
# the trace file that `trace` writes into its directory
TRACE_FILE = "trace.json"
# the device events of a trace, by their category
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


@contextlib.contextmanager
def timed(description: str, file=sys.stderr):
    """Print '<description> took Xs' like the reference's timedStep."""
    t0 = time.perf_counter()
    yield
    print(f"{description} took {time.perf_counter() - t0:.4f}s", file=file)


@contextlib.contextmanager
def trace(log_dir: str | Path, cuda: bool | None = None):
    """A torch.profiler trace of the block, written to log_dir/trace.json
    (Chrome trace format: Perfetto or chrome://tracing open it; rank r > 0
    of a process group writes trace_rank<r>.json). CPU activity always;
    CUDA activity (kernels and copies on the device's clock) when `cuda`, by
    default when CUDA is available."""
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile

    if cuda is None:
        cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    rank = dist.get_rank() if dist.is_available() and dist.is_initialized() else 0
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(str(log_dir / (f"trace_rank{rank}.json" if rank else TRACE_FILE)))


def timed_run():
    """The range an entry point records around its timed run (TIMED_RUN),
    for `kernel_summary`; a no-op while no profiler runs."""
    return torch.profiler.record_function(TIMED_RUN)


def _union_us(intervals) -> float:
    busy, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b <= end:
            continue
        busy += b - max(a, end)
        end = b
    return busy


def kernel_summary(trace_path: str | Path, window: str = TIMED_RUN) -> dict:
    """What a `trace` file says of the device: {"kernels": {name: {"launches",
    "device_us"}}, "device_events", "window_us", "busy_us", "idle_share"}.
    With a range named `window` (the timed run) in the trace, the device
    events are those launched inside it (by their correlation with the
    launching call), and the window runs from its start to the end of the
    range or of the last of those events, whichever is later; without one,
    every device event counts and the window spans them. idle_share is None
    for a trace with no device event at all (a run on the CPU, or a trace
    taken without CUPTI)."""
    events = json.loads(Path(trace_path).read_text())
    events = events.get("traceEvents", events) if isinstance(events, dict) else events
    spans = [e for e in events if e.get("ph") == "X" and "dur" in e]
    device = [e for e in spans if e.get("cat") in DEVICE_CATEGORIES]
    traced_device = bool(device)
    ranges = [(float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in spans
              if e.get("name") == window and e.get("cat") == "user_annotation"]
    if ranges:
        start, range_end = min(a for a, _ in ranges), max(b for _, b in ranges)
        launched = {e["args"]["correlation"] for e in spans
                    if e.get("cat") in ("cuda_runtime", "cuda_driver")
                    and "correlation" in e.get("args", {})
                    and start <= float(e["ts"]) <= range_end}
        device = [e for e in device if e.get("args", {}).get("correlation") in launched]
    else:
        start = min((float(e["ts"]) for e in device), default=0.0)
        range_end = start
    end = max([range_end] + [float(e["ts"]) + float(e["dur"]) for e in device])
    kernels: dict = {}
    for e in device:
        if e["cat"] == "kernel":
            k = kernels.setdefault(e["name"], {"launches": 0, "device_us": 0.0})
            k["launches"] += 1
            k["device_us"] += float(e["dur"])
    busy = _union_us((float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in device)
    window_us = end - start
    return {"kernels": kernels, "device_events": len(device), "window_us": window_us,
            "busy_us": busy,
            "idle_share": 1.0 - busy / window_us if traced_device and window_us > 0 else None}


class _Call(torch.nn.Module):
    """A function of tensors as a module, for torch.export."""

    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def forward(self, *args):
        return self.fn(*args)


def export(fn_or_module, *args):
    """torch.export.export of a module, or of a function of tensors."""
    module = (fn_or_module if isinstance(fn_or_module, torch.nn.Module)
              else _Call(fn_or_module))
    return torch.export.export(module, tuple(args))


def dump_graph(fn, *args, path: str | Path | None = None) -> str:
    """The torch.export graph of fn(*args) (a function of tensors or a
    module) as text; written to `path` too when given."""
    text = str(export(fn, *args))
    if path is not None:
        Path(path).write_text(text)
    return text


def operation_count(program) -> int:
    """The operations (call_function nodes) of an exported program's graph."""
    return sum(1 for node in program.graph.nodes if node.op == "call_function")


def export_step(module, *args, path: str | Path):
    """Export module(*args) with torch.export and save it to `path`. The
    program is specialised to the example inputs' shapes, types and device,
    and holds the module's buffers. Returns (the program, bytes written)."""
    program = export(module, *args)
    torch.export.save(program, str(path))
    return program, os.path.getsize(path)


def load_step(path: str | Path):
    """An exported program from `path`; call it through `.module()`."""
    return torch.export.load(str(path))


def input_specs(program) -> dict:
    """{name: (shape, dtype, device)} of an exported program's user inputs."""
    names = set(program.graph_signature.user_inputs)
    return {node.name: (tuple(node.meta["val"].shape), node.meta["val"].dtype,
                        node.meta["val"].device)
            for node in program.graph.nodes if node.op == "placeholder" and node.name in names}


def host_fingerprint() -> str:
    """Short stable hash of the host's CPU feature set and model name: a
    build directory keyed by it is never shared by two kinds of host, whose
    compilers would target other features."""
    import hashlib
    import platform
    import re

    try:
        text = Path("/proc/cpuinfo").read_text()
        flags = re.search(r"^(?:flags|Features)\s*:\s*(.*)$", text, re.M)
        model = re.search(r"^model name\s*:\s*(.*)$", text, re.M)
        ident = " ".join(sorted(flags.group(1).split())) if flags else ""
        ident += "|" + (model.group(1) if model else "")
    except OSError:
        ident = platform.processor() or platform.machine()
    return hashlib.sha256(ident.encode()).hexdigest()[:12]


def set_build_dir(cache_dir: str | Path, per_host: bool = True) -> Path:
    """Build the CUDA kernels (ops/_build.py) and the native library
    (utils/native_io.py) under `cache_dir` from now on:
    cache_dir/host-<fingerprint> with per_host (the default), so that two
    kinds of host never share a build. Libraries already loaded stay
    loaded. Returns the directory."""
    from ..ops import _build
    from . import native_io

    build_dir = Path(cache_dir)
    if per_host:
        build_dir = build_dir / f"host-{host_fingerprint()}"
    build_dir.mkdir(parents=True, exist_ok=True)
    _build.BUILD_DIR = build_dir
    native_io.BUILD_DIR = build_dir / "native"
    return build_dir


# NaN checks of the engines: inherited by the ranks a run starts (spawn)
# through the environment
_NAN_ENV = "LBM_TORCH_DEBUG_NANS"
NAN_DEBUG = os.environ.get(_NAN_ENV) == "1"


def enable_nan_debugging(on: bool = True) -> bool:
    """Turn the engines' NaN checks on (or off). Returns the previous
    setting, for a caller that restores it."""
    global NAN_DEBUG
    previous = NAN_DEBUG
    NAN_DEBUG = on
    if on:
        os.environ[_NAN_ENV] = "1"
    else:
        os.environ.pop(_NAN_ENV, None)
    return previous


def check_nans(f, step: int, what: str, k_steps: int = 1) -> None:
    """Raise FloatingPointError if the state f (a tensor, a DTensor's block
    or a numpy array) holds a NaN after `step` steps of `what`; k_steps
    names the steps of the launch that made it. A check synchronises the
    host with the device: the engines call it only while NAN_DEBUG."""
    import numpy as np

    if hasattr(f, "to_local"):
        f = f.to_local()
    bad = bool(torch.isnan(f).any()) if isinstance(f, torch.Tensor) else bool(np.isnan(f).any())
    if bad:
        steps = f"step {step}" if k_steps == 1 else f"steps {step - k_steps + 1}-{step}"
        raise FloatingPointError(f"NaN in the state after {steps} of {what} "
                                 f"(pass {step // k_steps})")


def device_memory_stats() -> dict:
    """torch.cuda.memory_stats of each CUDA device, by name; {} on a host
    without CUDA."""
    if not torch.cuda.is_available():
        return {}
    return {f"cuda:{i}": torch.cuda.memory_stats(i) for i in range(torch.cuda.device_count())}
