"""field.pairs_per_iter: the trainer's own ``num_pairs`` counter (the
(tile, splat) pairs binning made) averaged over the traced iterations."""


def read(ctx):
    xs = ctx.records.get("num_pairs", [])
    return sum(float(x) for x in xs) / len(xs) if xs else None
