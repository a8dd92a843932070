"""part_sum_mb.normal_eq: MB (10^6 bytes) an epoch of partial A and b on
``fused_gram``'s split path (a call that cuts long rating lists into
parts, one f32 partial each, and sums them), written by the kernel and
read back by the sum, in MB.

Read from the program's counters (``ops/fused_gram``: ``part_bytes``
and ``launches`` since the process began): every epoch makes the same
calls, so their ratio is the bytes a launch, which times the
``fused_gram`` kernels an epoch of the trace gives the epoch's. A program
without the counter reads nothing."""

import sys

FUSED = ("fused_gram",)  # kernel names of ops/fused_gram.py, both bodies


def read(ctx):
    fg = sys.modules.get("ycnr_tpu_torch.ops.fused_gram")
    moved = getattr(fg, "part_bytes", None)
    launched = getattr(fg, "launches", 0)
    tr = ctx.trace
    if moved is None or not launched or tr is None or not ctx.units:
        return None
    kernels = sum(1 for n, _, _ in tr.kernels if any(p in n for p in FUSED))
    return moved / launched * kernels / ctx.units / 1e6
