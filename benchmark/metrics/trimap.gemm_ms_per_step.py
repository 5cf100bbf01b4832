"""trimap.gemm_ms_per_step: device ms a denoise step spends in the kernels
launched inside the benchmark's spans around the DiT's linear layers
(the projections, the MLP, the modulations), in the traced window."""


def read(ctx):
    ms = ctx.trace.span_device_ms.get("bench.linear", [])
    return sum(ms) / ctx.trace.units if ms and ctx.trace.units else None
