"""field.loop_idle_ms_per_iter: the device's idle ms an iteration in the
trainer's own loop work: the interior gaps of the traced window's kernels
whose midpoint falls in a ``field.iter`` span of the program and outside
its ``field.step`` (``train/field.GaussianFieldTrainer.train``: the view
and draws, densification, the pair-cap check)."""
from benchmark.harness import spans


def read(ctx):
    return spans.idle_ms_per_unit(ctx, "field.step", "field.iter",
                                  "field.iter")
