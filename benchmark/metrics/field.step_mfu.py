"""field.step_mfu: the training iteration's counted least time (K1's and
K2's bounds, the pair stream's compaction and sort and the splat Adam's
bytes over the groups the phase trains) over its measured time in the
traced window, in %."""
from benchmark.counts import blend


def read(ctx):
    return blend.step_mfu(ctx)
