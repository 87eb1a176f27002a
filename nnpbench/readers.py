"""The arithmetic the per-layer metrics share: each metric's file under
``layer_metrics/`` names one of these.  A reader returns None where the
run has nothing for it to read (no trace, no launch of the kernels it
reads)."""

from nnpbench.work import et

# the port's fused kernels: ET's edge phase (#1-#3 and the weight
# reduction) and the cell list's k-smallest selection (#6)
ET_EDGE = ("et_fwd_kernel", "et_bwd_kernel", "et_bwd_src_kernel", "et_bwd2_kernel", "et_bwd2_src_kernel",
           "et_dw_kernel")
FUSED = ET_EDGE + ("select_topk_kernel",)


def _matching(table, names):
    return {k: v for k, v in table.items() if any(n in k for n in names)}


def device_idle_pct(ctx):
    t = ctx.trace
    if t is None or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)


def step_mfu(ctx):
    """The model's matrix-product operations a step (``work.et``) over the
    traced step time, as a share of the card's bf16 dense peak."""
    if ctx.trace is None or ctx.peaks is None or not ctx.steps:
        return None
    w = ctx.work
    flops = et.step_flops(w["kind"], w["args"], w["atoms"], w["pairs"], w["pairs_ne"])
    step_s = ctx.trace.window_s / ctx.steps
    return 100.0 * flops / step_s / ctx.peaks["bf16_tensor_flops"]


def et_edge_roofline(ctx):
    """The ET edge phase's floor (``work.et.passes`` at the pairs the inputs
    hold, for the passes the trace launched) over its kernels' device
    time."""
    if ctx.trace is None or ctx.peaks is None:
        return None
    table = ctx.trace.by_name(("kernel",))
    mine = _matching(table, ET_EDGE)
    seconds = sum(v[0] for v in mine.values())
    if seconds <= 0:
        return None

    def launches(name):
        return sum(v[1] for k, v in mine.items() if name in k)

    if launches("et_bwd2_kernel"):
        return None  # a second order: its passes are not counted in ``work.et``
    w = ctx.work
    passes = et.passes(w["args"], w["atoms"], w["pairs"])
    bound = sum(launches(f"et_{k}_kernel") * et.floor_s(v, ctx.peaks)[0] for k, v in passes.items())
    return 100.0 * bound / seconds


def composable_ms_per_step(ctx):
    """Device ms a step outside the fused kernels: the composable torch
    operations, copies and sets."""
    if ctx.trace is None or not ctx.steps:
        return None
    table = ctx.trace.by_name()
    other = sum(v[0] for k, v in table.items() if not any(n in k for n in FUSED))
    return 1e3 * other / ctx.steps
