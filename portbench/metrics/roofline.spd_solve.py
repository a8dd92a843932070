"""roofline.spd_solve: K1's least time over the device time of the
traced kernels whose names are K1's, in percent.

For every entity with ratings, per epoch: read A's lower triangle
(k (k + 1) / 2 f32) and b (k f32), write x (k f32), and factor and solve
(k^3 / 3 + 2 k^2 operations, at the f32 peak: the configuration
accumulates in f32). The least time is the larger of the two bounds.
"""

from portbench.harness import PEAKS
K1 = ("spd_solve",)  # kernel names of K1 (ops/spd_solve.py)


def least_per_epoch(counts) -> float:
    k = counts["rank"]
    ents = counts["users"] + counts["items"]
    nbytes = ents * (k * (k + 1) // 2 + 2 * k) * 4
    ops = ents * (k ** 3 / 3 + 2 * k * k)
    return max(nbytes / PEAKS["hbm_bytes_per_s"],
               ops / PEAKS["f32_flops_per_s"])


def read(ctx):
    tr = ctx.trace
    if tr is None or not ctx.units:
        return None
    device = sum(d for n, _, d in tr.kernels if any(p in n for p in K1))
    if device <= 0:
        return None
    return 100.0 * least_per_epoch(ctx.counts) * ctx.units / device
