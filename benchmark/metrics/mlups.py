"""mlups (MLUP/s, end to end): lattice-cell updates of every job completed in
the window, over the window's seconds on the host's clock. The window opens
at the first job's start and closes at the last job's end."""


def read(ctx):
    return ctx.updates / ctx.window_s / 1e6
