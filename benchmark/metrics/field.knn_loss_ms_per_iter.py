"""field.knn_loss_ms_per_iter: device ms an iteration spends in the kernels
launched inside the benchmark's span around the 3D kNN regulariser's
forward (``ops/losses.loss_cls_3d``: the sampled splats' squared
distances to every slot, their top-k and the KL), in the traced window."""


def read(ctx):
    ms = ctx.trace.span_device_ms.get("bench.knn_loss", [])
    return sum(ms) / ctx.trace.units if ms and ctx.trace.units else None
