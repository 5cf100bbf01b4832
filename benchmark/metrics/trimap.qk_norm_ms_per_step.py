"""trimap.qk_norm_ms_per_step: device ms a denoise step spends in the
program's ``dit.qk_norm`` spans (``models/cogvideox/transformer.
JointAttention``'s LayerNorms of q and k over each head), in the traced
window."""
from benchmark.harness import spans


def read(ctx):
    return spans.device_ms_per_unit(ctx, "dit.qk_norm")
