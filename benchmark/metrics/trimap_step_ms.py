"""trimap_step_ms: the window's host seconds, ending in a synchronise, over
the denoise steps it completed, in ms."""


def read(ctx):
    w = ctx.window
    return w["elapsed_s"] / w["units"] * 1e3 if w.get("units") else None
