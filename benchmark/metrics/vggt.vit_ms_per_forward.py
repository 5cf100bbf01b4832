"""vggt.vit_ms_per_forward: device ms a forward spends in the program's
``vggt.vit`` span (``models/vggt.DinoViT``: the patch embedding and the
24 ViT blocks), in the traced window."""
from benchmark.harness import spans


def read(ctx):
    return spans.device_ms_per_unit(ctx, "vggt.vit")
