"""Device time of ``fused_gram`` (T4's counterpart) on list shapes that
split its time: long lists whose A is negligible (264 x 16,384 slots: the
loop), short lists whose A is most of the bytes (25,000 x 16), the user
phase's mean (8,192 x 224) and two of its rungs (1,024 x 1,416; 12,472 x
56), at w 192 and 256 (the wide body) and, with ``--all``, w 250 (its
plain loads), on a random bf16 table of the ML-20M item factor's shape
with the zero trash row last, random indices and ratings, the ridge on.
Times by CUDA events over a few calls after a warm-up.

Uses only the wrapper's stable signature, so the same file times another
checkout of the package when run as a script with that checkout first on
``PYTHONPATH``: two versions are compared inside one call on one card.
Prints one JSON line per measurement. Needs a GPU.

    python -m ycnr_tpu_torch.tools.bench_fused_gram [--all] [--iters 5]
    PYTHONPATH=<other checkout> python ycnr_tpu_torch/tools/bench_fused_gram.py
"""

from __future__ import annotations

import argparse
import json

import torch

import ycnr_tpu_torch
from ycnr_tpu_torch.ops.fused_gram import fused_gram_cuda
from ycnr_tpu_torch.tools.probe_gather import device_name

N_ROWS = 26_745  # the ML-20M item factor and its trash row
SHAPES = (("long", 264, 16_384), ("short", 25_000, 16), ("mid", 8192, 224),
          ("r1416", 1024, 1416), ("r56", 12_472, 56))
HBM_BYTES_PER_S = 3.35e12


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--all", action="store_true",
                    help="every shape, and w 250 (plain loads)")
    ap.add_argument("--iters", type=int, default=5)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bench_fused_gram needs a GPU")
    dev = torch.device("cuda", 0)
    out = []
    shapes = SHAPES if args.all else SHAPES[:3]
    for w in (192, 256, 250) if args.all else (192, 256):
        gen = torch.Generator(device=dev)
        gen.manual_seed(w)
        table = (0.1 * torch.randn(N_ROWS, w, generator=gen,
                                   device=dev)).bfloat16()
        table[-1] = 0
        for name, ne, R in shapes if w % 8 == 0 else shapes[2:3]:
            idx = torch.randint(0, N_ROWS - 1, (ne, R), generator=gen,
                                device=dev)
            rat = (1 + 4 * torch.rand(ne, R, generator=gen,
                                      device=dev)).bfloat16()
            reg = torch.full((ne,), 0.5, device=dev)
            ms = cuda_ms(lambda: fused_gram_cuda(table, idx, rat, reg),
                         args.iters)
            row = dict(w=w, shape=name, entities=ne, slots=R, ms=ms,
                       ns_slot=ms * 1e6 / (ne * R),
                       a_bound_ms=ne * 4 * w * w / HBM_BYTES_PER_S * 1e3,
                       package=ycnr_tpu_torch.__file__,
                       device=device_name())
            out.append(row)
            print(json.dumps(row), flush=True)
    return out


if __name__ == "__main__":
    main()
