"""peak_mem_gib: the allocator's peak over set-up and window, read before
the reference runs, in GiB."""


def read(ctx):
    return ctx.peak_bytes / 2 ** 30 if ctx.peak_bytes else None
