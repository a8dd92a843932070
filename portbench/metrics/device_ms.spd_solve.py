"""device_ms.spd_solve: device time an epoch of the operations launched
inside the program's ``solve`` spans (K1 and the rows' write-back, and on
iALS the base Gram's add, the ridge and the symmetrize before K1), in
ms."""

from portbench import spans


def read(ctx):
    v = spans.device_s(getattr(ctx, "spans", None), "solve", "epoch")
    return None if v is None else 1e3 * v
