"""trimap.attn_roofline: the joint attention's counted least time (its
score and value products at the bf16 peak) over the device time of the
kernels inside the benchmark's span around the port's attention call,
summed over the traced window, in %."""
from benchmark.counts import dit, peaks


def read(ctx):
    ms = ctx.trace.span_device_ms.get("bench.attention", [])
    if not ms or sum(ms) <= 0:
        return None
    c = ctx.config
    L, V = dit.tokens(c)
    least = peaks.tensor_ms(dit.attention_flops(2, c["num_heads"], L + V,
                                                c["head_dim"]))
    return least * len(ms) / sum(ms) * 100.0
