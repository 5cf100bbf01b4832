"""field.blend_bwd_roofline: K2's counted least time over the device time
of the kernels launched inside the benchmark's span around the port's
blend backward, summed over the traced window, in %."""
from benchmark.counts import blend


def read(ctx):
    return blend.roofline(ctx, "bwd")
