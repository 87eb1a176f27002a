"""The window's wall time over all the MD steps it completed (ms)."""


def read(ctx):
    return 1e3 * ctx.window_s / ctx.steps
