"""idle.topn: the share of the traced passes' window in which no device
operation ran (one minus the union of kernel, copy and fill intervals
over the window), in percent."""


def read(ctx):
    tr = ctx.trace
    if tr is None or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
