"""field.kernels_per_iter: device activities (kernels, memsets, copies)
in the traced window per training iteration: the host's dispatch load."""


def read(ctx):
    t = ctx.trace
    return len(t.kernels) / t.units if t.units else None
