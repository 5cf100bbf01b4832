"""field.render_ms_per_iter: device ms an iteration spends in the program's
``field.render`` span (``train/field.view_loss``: the trained view's
``render_view``, i.e. preprocess, SH, binning K3/K4 and the blend K1), in
the traced window."""
from benchmark.harness import spans


def read(ctx):
    return spans.device_ms_per_unit(ctx, "field.render")
