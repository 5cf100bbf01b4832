"""trimap.lnz_roofline: LayerNormZero's counted least time (its bytes at
the HBM rate) over the device time of the kernels inside the benchmark's
span around the port's call, summed over the traced window, in %."""
from benchmark.counts import dit, peaks


def read(ctx):
    ms = ctx.trace.span_device_ms.get("bench.ln_modulate", [])
    if not ms or sum(ms) <= 0:
        return None
    c = ctx.config
    L, V = dit.tokens(c)
    least = peaks.bytes_ms(dit.ln_modulate_bytes(
        2, L + V, c["num_heads"] * c["head_dim"]))
    return least * len(ms) / sum(ms) * 100.0
