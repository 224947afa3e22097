"""kernels_roofline (%, layer "kernels"): the least time the card needs for
the work the window's jobs delivered, over the time the kernels ran inside
the jobs' spans (the union of their intervals; copies and sets left out).

The work is the cell updates the jobs delivered, whatever the program
launched to deliver them (a warm-up the entry runs first, or a step in
another K, changes the kernels' time and not the work). The least time of a
job is the larger of
  its operations: FLOP per update (the reference's count, in
    benchmark/reference/<lattice>.py) x updates, at the card's peak for the
    arithmetic type (`peaks.json`);
  its bytes: the start state read once, the final state and av_vels written
    once, the mask read once, at the card's memory bandwidth.
The body force on one row or plane and the first acceleration are left out
of the operations, so the bound is a lower one and the share cannot pass
100% unless the kernels' time leaves out part of the work. On n ranks the
work is the whole job's, shared by n cards (one a rank, in every run that
prints a result), and the kernels' time is rank 0's: the least time of its
card is the job's over n."""

from benchmark import devtrace


def peak(peaks: dict, kind: str):
    for card in peaks["cards"]:
        if card["match"] in kind:
            return card
    return None


def read(ctx):
    t = ctx.trace
    card = peak(ctx.peaks, ctx.device_kind)
    if t is None or card is None or not t.jobs or not t.kernels():
        return None
    kernel_s = sum(devtrace.busy_in_spans(t.kernels(), t.jobs)) / 1e6
    cards = len(ctx.device["ranks"])
    least = max(ctx.flop_per_job / card["flop_per_s"][ctx.compute],
                ctx.bytes_per_job / card["bytes_per_s"]) * len(t.jobs) / cards
    return 100.0 * least / kernel_s if kernel_s > 0 else None
