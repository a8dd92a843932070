"""device_ms.normal_eq: device time an epoch of the operations launched
inside the program's ``normal_eq`` spans (the gather and Gram, the ridge,
iALS's base Gram), whatever their kernels are named, in ms."""

from portbench import spans


def read(ctx):
    v = spans.device_s(getattr(ctx, "spans", None), "normal_eq", "epoch")
    return None if v is None else 1e3 * v
