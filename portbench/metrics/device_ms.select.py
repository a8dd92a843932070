"""device_ms.select: device time a serving pass of the operations
launched inside the program's ``select`` spans (the two top-k after K2,
the gathers, the ids and the rebias), in ms."""

from portbench import spans


def read(ctx):
    v = spans.device_s(getattr(ctx, "spans", None), "select", "pass")
    return None if v is None else 1e3 * v
