"""setup_s (s, end to end): from the process's start to the first job of
the window: imports, the card, the kernels' build and load, the inputs from
the seed and the warm-up job."""


def read(ctx):
    return ctx.setup_s
