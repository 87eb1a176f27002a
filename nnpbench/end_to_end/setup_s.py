"""From process start to the first timed step: imports, inputs, weights,
kernel builds (the first run in a checkout), warm-up (s)."""


def read(ctx):
    return ctx.setup_s
