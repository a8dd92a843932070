"""mfu.train: the operations a training epoch needs, counted from the
shapes, over the window's ``epoch_ms``, against the card's bf16 peak
(both configurations state bf16 gathers), in percent.

Counted per epoch (both half-steps): each rating's outer product and
right-hand side, 2 k^2 + 2 k; for every entity with ratings a Cholesky
factorization and two triangular solves, k^3 / 3 + 2 k^2. iALS adds each
rating's confidence weighting (2 k), the full Gram of each side's other
table (2 k^2 per row) and its addition to every entity's (k^2).
"""

from portbench.harness import PEAKS


def ops_per_epoch(config, counts) -> float:
    k, nnz = counts["rank"], counts["nnz"]
    ents = counts["users"] + counts["items"]
    ops = 2 * nnz * (2 * k * k + 2 * k) + ents * (k ** 3 / 3 + 2 * k * k)
    if config.get("alpha") is not None:
        ops += 2 * nnz * 2 * k
        ops += 2 * k * k * (counts["n_users"] + counts["n_items"])
        ops += ents * k * k
    return float(ops)


def read(ctx):
    if not getattr(ctx, "epoch_ms", None):
        return None
    flops = ops_per_epoch(ctx.config, ctx.counts) / (ctx.epoch_ms / 1e3)
    return 100.0 * flops / PEAKS["bf16_flops_per_s"]
