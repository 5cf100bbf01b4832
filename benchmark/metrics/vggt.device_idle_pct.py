"""vggt.device_idle_pct: the share of the traced window in which no
kernel ran (1 - union of kernel intervals / window), in %."""


def read(ctx):
    t = ctx.trace
    return (1.0 - t.busy_s / t.window_s) * 100.0 if t.window_s > 0 else None
