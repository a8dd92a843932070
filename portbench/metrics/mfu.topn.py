"""mfu.topn: the scoring a serving pass needs, 2 * users * items * k
operations, over the wall of the traced passes, against the card's bf16
peak (the pass scores in bf16), in percent."""

from portbench.harness import PEAKS


def ops_per_pass(counts) -> float:
    return 2.0 * counts["users"] * counts["n_items"] * counts["rank"]


def read(ctx):
    if ctx.trace is None or not ctx.units or ctx.traced_wall_s <= 0:
        return None
    flops = ops_per_pass(ctx.counts) * ctx.units / ctx.traced_wall_s
    return 100.0 * flops / PEAKS["bf16_flops_per_s"]
