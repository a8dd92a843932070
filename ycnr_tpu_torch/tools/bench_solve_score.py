"""Device time of K1 (batched SPD solve) and K2 (fused masked scorer) at
the main path's shapes, over CUDA graphs (no host launch cost).

K1 at n = 64 with B = 8, 256 and 20,000 systems (the bucketed epoch calls
it with anything from 8 systems to tens of thousands), and at n = 192 and
256 (ranks above 128: the packed-triangle body) with the same batches; K2
at one serving block of 4,096 users x 26,744 items, rank 64, bf16 and f32
score buffers.
Uses only the wrappers' stable signatures, so the same file times another
checkout of the package when run with that checkout first on
``PYTHONPATH``: two versions are compared inside one call on one card.
Prints one JSON line per measurement. Needs a GPU.

    python -m ycnr_tpu_torch.tools.bench_solve_score [--reps 3]
"""

from __future__ import annotations

import argparse
import json

import torch

from ycnr_tpu_torch.ops.fused_topn import SEG_LEN, fused_scores_cuda
from ycnr_tpu_torch.ops.spd_solve import spd_solve_cuda
from ycnr_tpu_torch.tools.probe_gather import device_name, graph_ms

K1_NS = (64, 192, 256)
K1_BATCHES = (8, 256, 20_000)
K2_USERS, K2_ITEMS, K2_RANK = 4096, 26_744, 64


def spd_systems(batch: int, n: int, gen: torch.Generator, dev):
    """A = M M^T / n + I / 2, b normal: well-conditioned f32 systems."""
    M = torch.randn(batch, n, n, generator=gen, device=dev)
    A = M @ M.transpose(1, 2) / n + 0.5 * torch.eye(n, device=dev)
    A = (0.5 * (A + A.transpose(1, 2))).contiguous()
    return A, torch.randn(batch, n, generator=gen, device=dev)


def scorer_inputs(gen: torch.Generator, dev):
    n_seg = -(-(K2_ITEMS + 1) // SEG_LEN)
    m = n_seg * SEG_LEN
    rows = (0.5 * torch.randn(K2_USERS, K2_RANK, generator=gen,
                              device=dev)).bfloat16()
    V = (0.5 * torch.randn(m, K2_RANK, generator=gen, device=dev)).bfloat16()
    bi = 0.1 * torch.randn(m, generator=gen, device=dev)
    bits = torch.randint(-2 ** 31, 2 ** 31, (K2_USERS, 4 * n_seg),
                         generator=gen, device=dev, dtype=torch.int64)
    # ~1.6% of the items rated: the AND of six random words
    for _ in range(5):
        bits &= torch.randint(-2 ** 31, 2 ** 31, bits.shape, generator=gen,
                              device=dev, dtype=torch.int64)
    return rows, V, bi, bits.to(torch.int32)


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=3,
                    help="graph timings per measurement; the least is kept")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bench_solve_score needs a GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    out = []

    def report(**kw):
        kw["device"] = device_name()
        out.append(kw)
        print(json.dumps(kw), flush=True)

    for n in K1_NS:
        for batch in K1_BATCHES:
            A, b = spd_systems(batch, n, gen, dev)
            iters = 20 if batch <= 256 else 10 if n <= 64 else 3
            ms = min(graph_ms(lambda: spd_solve_cuda(A, b), iters)
                     for _ in range(args.reps))
            report(kernel="spd_solve", n=n, batch=batch, ms=ms)
            del A, b
    rows, V, bi, bits = scorer_inputs(gen, dev)
    for score_bf16 in (True, False):
        ms = min(graph_ms(lambda: fused_scores_cuda(rows, V, bi, bits,
                                                    score_bf16), 5)
                 for _ in range(args.reps))
        report(kernel="fused_scores", users=K2_USERS, items=K2_ITEMS,
               rank=K2_RANK, scores="bf16" if score_bf16 else "f32", ms=ms)
    return out


if __name__ == "__main__":
    main()
