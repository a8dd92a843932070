"""launches.train: device operations (kernels, copies, fills) an epoch
whose launch the host issued inside an ``epoch`` span, over the traced
epochs."""

from portbench import spans


def read(ctx):
    j = getattr(ctx, "spans", None)
    n = spans.per_unit(j, "epoch")
    if n is None:
        return None
    return len(j.ops_in("epoch")) / n
