"""The engine loop of the K-step kernels: `num_steps` steps in passes of K.

Every K-step wrapper's `run` (B1-B3 in `d2q9_kstep*`, B4-B7 in
`d3q19_kstep*`) is `run` here with its own `launch_pass`, or on a CPU tensor
`run_plain` with its kernel's plain version. The loop checks K, allocates
Sum|u|, names itself and each pass in a trace (`profiling.passes`), hands
each pass its K values of Sum|u| and, under `--debug-nans`, checks the state
after each pass. What is the kernel's own (its arguments, buffers, plan and
the rotation of its lattices) stays in the wrapper, in `launch_pass`.
"""

from __future__ import annotations

from ..utils import profiling
from . import d2q9_kstep


def run(f, *, num_steps: int, k_steps: int, kernel: str, path, launch_pass, what: str):
    """`num_steps` // `k_steps` passes from state f: f = launch_pass(i, f,
    tot), where tot is pass i's K values of Sum|u| to write. `kernel` and
    `path` name the loop as in `profiling.passes` (a callable path is asked
    only while a profiler runs); `what` names the pass in a NaN check.
    Returns (f_final, tot_u (num_steps,)), float32 for a bfloat16 f."""
    if num_steps % k_steps:
        raise ValueError(f"num_steps {num_steps} not a multiple of k_steps {k_steps}")
    tots = d2q9_kstep.sums(f, num_steps)
    for i in profiling.passes(num_steps // k_steps, kernel, path, k_steps):
        f = launch_pass(i, f, tots[i * k_steps:(i + 1) * k_steps])
        if profiling.NAN_DEBUG:
            profiling.check_nans(f, (i + 1) * k_steps, what, k_steps)
    return f, tots


def run_plain(stepk_plain, f, mask, *, num_steps: int, k_steps: int, kernel: str,
              in_place: bool = False, **kw):
    """`run` in passes of `stepk_plain` (the CPU route of every wrapper's
    `run`; `kernel` names the wrapper's kernel in a trace, on the path
    "plain"). in_place: each pass's state is copied back into f, which the
    run returns, as the in-place kernels do."""

    def launch_pass(i, f, tot):
        f_new, tot[:] = stepk_plain(f, mask, k_steps=k_steps, **kw)
        return f.copy_(f_new) if in_place else f_new

    return run(f, num_steps=num_steps, k_steps=k_steps, kernel=kernel, path="plain",
               launch_pass=launch_pass, what="a K-step pass (plain version)")
