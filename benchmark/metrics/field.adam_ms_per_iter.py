"""field.adam_ms_per_iter: device ms an iteration spends in the kernels
launched inside the benchmark's span around the trainer's Adam updates
(``train/optim.GroupAdam.update``, every splat group), in the traced
window."""


def read(ctx):
    ms = ctx.trace.span_device_ms.get("bench.adam", [])
    return sum(ms) / ctx.trace.units if ms and ctx.trace.units else None
