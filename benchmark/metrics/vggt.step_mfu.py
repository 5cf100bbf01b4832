"""vggt.step_mfu: a forward's operations (the ViT, the aggregator and the
camera and depth heads), counted from the configuration's shapes, over
the forward's time in the traced window at the card's bf16 peak, in %."""
from benchmark.counts import peaks, vggt


def read(ctx):
    t = ctx.trace
    if not t.units:
        return None
    forward_s = t.window_s / t.units
    return vggt.forward_flops(ctx.config)["total"] / (
        forward_s * peaks.PEAK_BF16_FLOPS) * 100.0
