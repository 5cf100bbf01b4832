"""field.backward_ms_per_iter: device ms an iteration spends in the
program's ``field.backward`` span (``train/field.loss_and_grads``'s
``torch.autograd.grad``: the blend backward K2 and every loss's
backward), in the traced window."""
from benchmark.harness import spans


def read(ctx):
    return spans.device_ms_per_unit(ctx, "field.backward")
