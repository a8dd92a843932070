"""roofline.normal_eq: the normal equations' least time over the device
time of every traced epoch kernel that is not K1's, in percent.

The least time is the larger of the operations at the bf16 peak and the
bytes at the HBM bandwidth. Operations: each rating's outer product and
right-hand side (2 k^2 + 2 k, both sides), plus iALS's weighting and full
Grams. Bytes, read or written once: each rating's index (int32) and
value (bf16, exact for half-star levels) on both sides, each side's other
table once in bf16, and for every entity its A and b in f32. A counts as
its lower triangle, k (k + 1) / 2 entries: A is symmetric, the solve
reads only that triangle, and a body that writes the square does work the
layer does not need.
"""

from portbench.harness import PEAKS
K1 = ("spd_solve",)  # kernel names of K1 (ops/spd_solve.py)


def ops_per_epoch(config, counts) -> float:
    k, nnz = counts["rank"], counts["nnz"]
    ops = 2 * nnz * (2 * k * k + 2 * k)
    if config.get("alpha") is not None:
        ops += 2 * nnz * 2 * k
        ops += 2 * k * k * (counts["n_users"] + counts["n_items"])
        ops += (counts["users"] + counts["items"]) * k * k
    return float(ops)


def bytes_per_epoch(config, counts) -> float:
    k, nnz = counts["rank"], counts["nnz"]
    ents = counts["users"] + counts["items"]
    tables = (counts["n_users"] + counts["n_items"]) * k * 2
    return float(2 * nnz * (4 + 2) + tables
                 + ents * (k * (k + 1) // 2 + k) * 4)


def read(ctx):
    tr = ctx.trace
    if tr is None or not ctx.units:
        return None
    device = sum(d for n, _, d in tr.kernels if not any(p in n for p in K1))
    if device <= 0:
        return None
    least = max(ops_per_epoch(ctx.config, ctx.counts)
                / PEAKS["bf16_flops_per_s"],
                bytes_per_epoch(ctx.config, ctx.counts)
                / PEAKS["hbm_bytes_per_s"])
    return 100.0 * least * ctx.units / device
