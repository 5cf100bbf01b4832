"""trimap.rope_ms_per_step: device ms a denoise step spends in the
program's ``dit.rope`` spans (``models/cogvideox/transformer.
apply_rope_fused`` on q and k: the pair flip and the products with the
tables), in the traced window."""
from benchmark.harness import spans


def read(ctx):
    return spans.device_ms_per_unit(ctx, "dit.rope")
