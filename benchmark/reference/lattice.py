"""The loop of the references: a lattice's plain step, repeated, with the
state rounded to its storage type every `store_every` steps.

A state stored in bfloat16 (or, for a control, float8) is stepped in float32
and rounded once every `store_every` steps, as a program that keeps K steps
of a pass in float32 and stores the lattice once a pass does. On the card
the loop is recorded once as a CUDA graph of `chunk` steps (the least
multiple of `chunk` that is whole passes) and replayed: the same plain
operations, without the host's launch overhead, so that a replay of a whole
job fits beside a run.
"""

from __future__ import annotations

import math

import torch

CHUNK = 100
# storage types by the names the traffic mixes use
STORAGE = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float8_e4m3fn": torch.float8_e4m3fn, "float64": torch.float64}


def compute_dtype(storage: torch.dtype) -> torch.dtype:
    """The type a state stored as `storage` is stepped in."""
    return torch.float64 if storage == torch.float64 else torch.float32


def run(step, f: torch.Tensor, *, steps: int, storage: torch.dtype, store_every: int,
        chunk: int = CHUNK):
    """`steps` steps of `step(state) -> (state', Sum|u|)` from f (stored as
    `storage`). Returns (the final state as `storage`, Sum|u| of each step
    in the compute type)."""
    compute = compute_dtype(storage)
    if steps % store_every:
        raise ValueError(f"{steps} steps are not a whole number of passes of {store_every}")

    def advance(state, n):
        tots = []
        for i in range(n):
            state, tot = step(state)
            tots.append(tot)
            if storage != compute and (i + 1) % store_every == 0:
                state = state.to(storage).to(compute)
        return state, torch.stack(tots)

    x = f.to(compute)
    chunk = math.lcm(chunk, store_every)
    if x.device.type != "cuda" or steps % chunk:
        x, tots = advance(x, steps)
        return x.to(storage), tots
    static = x.clone()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        advance(static.clone(), store_every)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out, tots = advance(static, chunk)
    all_tots = torch.empty(steps, dtype=compute, device=x.device)
    for c in range(steps // chunk):
        graph.replay()
        all_tots[c * chunk:(c + 1) * chunk].copy_(tots)
        static.copy_(out)
    final = static.to(storage)
    del graph
    return final, all_tots
