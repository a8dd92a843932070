"""issue_ms.train: the host's time to issue one epoch, the mean length of
the program's ``epoch`` spans over the traced epochs (host clock), in
ms. The ``synchronize`` that ends each epoch lies outside the span."""

from portbench import spans


def read(ctx):
    j = getattr(ctx, "spans", None)
    if spans.per_unit(j, "epoch") is None:
        return None
    ep = j.named("epoch")
    return 1e3 * sum(s[2] - s[1] for s in ep) / len(ep)
