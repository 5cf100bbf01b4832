"""field.step_idle_ms_per_iter: the device's idle ms an iteration inside
the trainer's step: the interior gaps of the traced window's kernels
whose midpoint falls in a ``field.step`` span of the program (host
dispatch and syncs inside ``train/field.make_train_step``'s step)."""
from benchmark.harness import spans


def read(ctx):
    return spans.idle_ms_per_unit(ctx, "field.step", "field.iter",
                                  "field.step")
