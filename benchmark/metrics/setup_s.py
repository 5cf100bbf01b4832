"""setup_s: host seconds from the start of the process to the first timed
step (imports, inputs and weights, the kernel build or load, warm
steps)."""


def read(ctx):
    return ctx.setup_s
