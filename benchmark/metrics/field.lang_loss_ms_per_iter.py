"""field.lang_loss_ms_per_iter: device ms an iteration spends in the
program's ``field.loss.lang`` span (``train/field.view_loss``: the
language map's masked L1 and the grouping loss over its sampled pixels;
the 3D kNN loss is outside it), in the traced window."""
from benchmark.harness import spans


def read(ctx):
    return spans.device_ms_per_unit(ctx, "field.loss.lang")
