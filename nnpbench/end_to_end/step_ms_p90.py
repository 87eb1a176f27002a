"""The 90th percentile (numpy's linear interpolation) of the window's
per-step intervals between consecutive CUDA events, each recorded on the
stream after a step."""

import numpy as np


def read(ctx):
    return float(np.percentile(np.asarray(ctx.step_ms), 90))
