"""Ranks for the multi-device paths: the process group they run in.

The reference needs none of this: JAX drives every device of a mesh from one
controller. On torch.distributed each device is driven by a rank of its own,
so a multi-device entry point runs its body on every rank and hands the
caller rank 0's result:

  * inside an initialised process group (torchrun, or a caller that set one
    up: one rank per GPU under NCCL), `run` calls the body in this process,
    on this rank, and broadcasts rank 0's result;
  * otherwise it starts `world_size` ranks with `torch.multiprocessing`
    ('spawn'), which meet through a `file://` rendezvous in a temporary
    directory: NCCL on CUDA (rank r on GPU r), gloo on the CPU. Each child
    runs on one thread. `init_process_group` and the join each have a time
    limit, so a lost rank fails the call instead of hanging it.

The body must be a function of this package: a child unpickles it by its
import path, and so imports nothing but the port (never JAX, never a test
module). No fallback: asking for more CUDA ranks than there are GPUs raises.
"""

from __future__ import annotations

import datetime
import os
import pickle
import tempfile
import time

import torch
import torch.distributed as dist

# seconds a rank group may take from spawn to join, and a collective may wait
DEFAULT_TIMEOUT = 600.0


def _check_body(fn) -> None:
    if not getattr(fn, "__module__", "").startswith("lbm_tpu_torch."):
        raise ValueError(f"a rank body must be a function of lbm_tpu_torch, got {fn!r}")


def check_world(world_size: int, device_type: str) -> None:
    """Refuses a world the host cannot run: no CUDA, or more CUDA ranks than
    GPUs."""
    if world_size < 1:
        raise ValueError(f"world_size must be at least 1, got {world_size}")
    if device_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available on this host; pass device='cpu' "
                               "(--device cpu) to run the ranks on the CPU")
        if world_size > torch.cuda.device_count():
            raise RuntimeError(f"{world_size} CUDA ranks asked for, and this host has "
                               f"{torch.cuda.device_count()} GPUs")


def run(fn, world_size: int, *args, device_type: str = "cpu",
        timeout: float = DEFAULT_TIMEOUT, **kwargs):
    """fn(*args, **kwargs) on each of world_size ranks; returns rank 0's
    result. See the module's note for where the ranks come from."""
    _check_body(fn)
    if dist.is_available() and dist.is_initialized():
        if dist.get_world_size() != world_size:
            raise ValueError(f"{world_size} ranks asked for inside a process group of "
                             f"{dist.get_world_size()}")
        if (dist.get_backend() == "nccl") != (device_type == "cuda"):
            raise ValueError(f"a {device_type} run inside a {dist.get_backend()} process group")
        result = fn(*args, **kwargs)
        box = [result if dist.get_rank() == 0 else None]
        dist.broadcast_object_list(box, src=0)
        return box[0]
    check_world(world_size, device_type)
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory(prefix="lbm_torch_ranks_") as tmp:
        # the call goes by file: a start through the pipe would wait for
        # each child in turn to import torch before the next could start
        with open(os.path.join(tmp, "call.pkl"), "wb") as fh:
            pickle.dump((fn, args, kwargs), fh)
        backend = "nccl" if device_type == "cuda" else "gloo"
        ctx = mp.start_processes(_rank_main, args=(world_size, backend, tmp, timeout),
                                 nprocs=world_size, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout
        try:
            while not ctx.join(timeout=0.1):
                if time.monotonic() > deadline:
                    raise TimeoutError(f"{world_size} ranks did not finish in {timeout} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                    p.join(10)
        with open(os.path.join(tmp, "result.pkl"), "rb") as fh:
            return pickle.load(fh)


def run_each(calls, world_size: int, *, device_type: str = "cpu",
             timeout: float = DEFAULT_TIMEOUT) -> list:
    """[fn(*args, **kwargs) for fn, args, kwargs in calls] in one group of
    world_size ranks (one start-up for many calls); returns rank 0's
    results. A call may itself be a multi-device entry point: inside the
    group, `run` runs it on these ranks."""
    for fn, args, _ in calls:
        _check_body(fn)
        for arg in args:  # a body's own body (on_mesh)
            if callable(arg) and not isinstance(arg, type):
                _check_body(arg)
    return run(each, world_size, calls, device_type=device_type, timeout=timeout)


def each(calls) -> list:
    return [fn(*args, **kwargs) for fn, args, kwargs in calls]


def on_mesh(shape, fn, *args, **kwargs):
    """fn(*args, mesh=<a mesh of this shape over the group>, **kwargs): a
    call of `run_each` on a mesh of a given shape."""
    from . import mesh as mesh_lib

    _check_body(fn)
    return fn(*args, mesh=mesh_lib.make_mesh2d(*shape), **kwargs)


def _rank_main(rank, world_size, backend, tmp, timeout):
    torch.set_num_threads(1)
    with open(os.path.join(tmp, "call.pkl"), "rb") as fh:
        fn, args, kwargs = pickle.load(fh)
    if backend == "nccl":
        torch.cuda.set_device(rank)
    dist.init_process_group(backend, init_method=f"file://{os.path.join(tmp, 'rendezvous')}",
                            world_size=world_size, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout))
    try:
        result = fn(*args, **kwargs)
        if rank == 0:
            part = os.path.join(tmp, "result.part")
            with open(part, "wb") as fh:
                pickle.dump(result, fh)
            os.replace(part, os.path.join(tmp, "result.pkl"))
    finally:
        dist.destroy_process_group()


def is_rank0() -> bool:
    """Whether this process is rank 0 of its group, or in none."""
    return not (dist.is_available() and dist.is_initialized()) or dist.get_rank() == 0
