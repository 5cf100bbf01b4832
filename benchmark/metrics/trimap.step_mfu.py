"""trimap.step_mfu: a denoise step's model operations, counted from the
configuration's shapes, over the step's time in the traced window at
the card's bf16 peak, in %."""
from benchmark.counts import dit, peaks


def read(ctx):
    t = ctx.trace
    if not t.units:
        return None
    step_s = t.window_s / t.units
    return dit.step_flops(ctx.config) / (step_s * peaks.PEAK_BF16_FLOPS) \
        * 100.0
