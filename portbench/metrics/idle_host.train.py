"""idle_host.train: the share of the traced window in which no device
operation ran while the host was inside an ``epoch`` span, in percent:
the device waiting on the program's issuing. ``idle.train`` less this is
the idle of the loop around the epochs (its ``synchronize``)."""

from portbench import spans


def read(ctx):
    j, tr = getattr(ctx, "spans", None), ctx.trace
    if spans.per_unit(j, "epoch") is None or tr is None or tr.window_s <= 0:
        return None
    return 100.0 * spans.overlap(tr.gaps, j.named("epoch")) / tr.window_s
