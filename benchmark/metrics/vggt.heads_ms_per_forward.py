"""vggt.heads_ms_per_forward: device ms a forward spends in the program's
``vggt.camera_head`` and ``vggt.depth_head`` spans (``models/vggt.
CameraHead``, ``DPTHead``, in f32), in the traced window."""
from benchmark.harness import spans


def read(ctx):
    parts = [spans.device_ms_per_unit(ctx, name)
             for name in ("vggt.camera_head", "vggt.depth_head")]
    return None if None in parts else sum(parts)
