"""roofline.topn: a serving pass's least time over the device time of
every kernel in the traced passes (K2, the selection after it, and
whatever else the pass launches), in percent.

Least time per pass: the larger of the scoring's operations, 2 * users *
items * k, at the bf16 peak, and its bytes at the HBM bandwidth: the
factors read once in bf16, one rated bit per (user, item) read once, and
each list written once (n ids and n f32 scores). It reads the same work
whatever implements it, so a selection fused into K2 shows here.
"""

from portbench.harness import PEAKS


def least_per_pass(counts) -> float:
    u, i, k, n = (counts["users"], counts["n_items"], counts["rank"],
                  counts["n"])
    ops = 2.0 * u * i * k
    nbytes = (u + i) * k * 2 + u * -(-i // 8) + u * n * 8
    return max(ops / PEAKS["bf16_flops_per_s"],
               nbytes / PEAKS["hbm_bytes_per_s"])


def read(ctx):
    tr = ctx.trace
    if tr is None or not ctx.units:
        return None
    device = sum(d for _, _, d in tr.kernels)
    if device <= 0:
        return None
    return 100.0 * least_per_pass(ctx.counts) * ctx.units / device
