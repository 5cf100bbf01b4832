"""vggt.global_attn_roofline: a global block's attention counted at its
least time (4 H (S T)^2 D at the bf16 peak) over the device time of the
program's ``vggt.attn`` spans inside ``vggt.global`` spans (K9 on the
card), summed over the traced window, in %."""
from benchmark.counts import peaks, vggt
from benchmark.counts.dit import attention_flops
from benchmark.harness import spans


def read(ctx):
    ms = [r.device_ms for r in spans.log() or ()
          if r.name == "vggt.attn" and r.parent is not None
          and r.parent.name == "vggt.global"]
    if not ms or None in ms:
        return None
    c = ctx.config
    S, T = vggt.tokens(c)
    least = peaks.tensor_ms(attention_flops(
        1, c["num_heads"], S * T, c["embed_dim"] // c["num_heads"]))
    return least * len(ms) / sum(ms) * 100.0
