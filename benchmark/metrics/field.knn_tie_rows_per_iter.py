"""field.knn_tie_rows_per_iter: the sampled rows of the 3D kNN loss whose
k-th distance is tied and that ``ops/losses._knn_smallest`` re-ranks with
a stable sort over every slot (the program's ``knn.tie_rows`` counter),
over the traced window's iterations."""
from benchmark.harness import spans


def read(ctx):
    if not spans.counted("knn.rows") or not ctx.trace.units:
        return None
    return spans.counted("knn.tie_rows") / ctx.trace.units
