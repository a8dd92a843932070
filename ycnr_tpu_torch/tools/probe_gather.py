"""Gather probe on the card: the port's counterpart of
``tools/probe_gather.py``.

Gathers m rows (default 2^23) from a factor table of 26,752 rows (the
ML-20M items table, padded: the U-phase's access pattern) at widths 64
and 128, bf16 and f32, and times with CUDA events:

  plain_*        PyTorch indexing ``table[idx]`` (int32 indices)
  kernel_*       ``row_gather`` (csrc/row_gather.cu; the TPU probe's
                 ``pallas_loop_gather`` and ``pallas_take_gather``)
  *_taa_*        the take-along form with row-broadcast [m/8, w] int64
                 indices: ``torch.gather`` vs ``take_along_rows``
                 (``pallas_taa_gather``)
  *_gram_*       with ``--gram``: R = 32 slots per entity, w = 64 bf16;
                 the two-step gather -> f32 einsum vs ``fused_gram``
                 (``pallas_fused_gram``)

Every kernel result is checked against its plain version first (bit
equality for the gathers, the fused-Gram bound for ``--gram``). Prints one
JSON line of ns per gathered row. Needs a CUDA device.

    python -m ycnr_tpu_torch.tools.probe_gather [--m 23] [--gram]
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from ycnr_tpu_torch import full_precision_matmul
from ycnr_tpu_torch.ops.fused_gram import (
    fused_gram,
    fused_gram_bound,
    fused_gram_reference,
)
from ycnr_tpu_torch.ops.row_gather import (
    row_gather,
    take_along_rows,
    take_along_rows_reference,
)

DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}


def cuda_ns_per_row(fn, rows: int, iters: int, warmup: int = 2) -> float:
    """Mean device nanoseconds per row over ``iters`` calls (CUDA events,
    after ``warmup`` calls)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters * 1e6 / rows


def device_name() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("this probe measures the card: torch.cuda."
                         "is_available() is False")
    return torch.cuda.get_device_name(0)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--m", type=int, default=23,
                    help="log2 of gathered rows per call")
    ap.add_argument("--n", type=int, default=26_752, help="table rows")
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--gram", action="store_true",
                    help="also time the fused gather -> Gram kernel")
    args = ap.parse_args(argv)
    M = 1 << args.m
    out = {"device": device_name(), "m_rows": M, "n_table": args.n,
           "iters": args.iters}
    full_precision_matmul()
    out.update(probe(M, args.n, args.iters, gram=args.gram))
    print(json.dumps(out), flush=True)
    return out


def probe(M: int, n: int, iters: int, dtypes=("bf16", "f32"),
          gram: bool = False) -> dict:
    """Check, then time, the gathers of M rows from an n-row table at
    widths 64 and 128 in each of ``dtypes`` (and with ``gram`` the fused
    gather -> Gram); keys as in the module docstring."""
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(0)
    idx = torch.as_tensor(rng.integers(0, n, M, dtype=np.int32), device=dev)
    out = {}
    m2 = M >> 3
    for w in (64, 128):
        idx2 = idx[:m2, None].long().expand(m2, w).contiguous()
        for dname in dtypes:
            table = torch.as_tensor(
                rng.standard_normal((n, w), dtype=np.float32),
                device=dev).to(DTYPES[dname])
            key = f"w{w}_{dname}"
            if not (torch.equal(row_gather(table, idx), table[idx])
                    and torch.equal(take_along_rows(table, idx2),
                                    take_along_rows_reference(table, idx2))):
                raise RuntimeError(f"{key}: kernel differs from plain")
            out[f"plain_{key}_ns_row"] = cuda_ns_per_row(
                lambda: table[idx], M, iters)
            out[f"kernel_{key}_ns_row"] = cuda_ns_per_row(
                lambda: row_gather(table, idx), M, iters)
            out[f"plain_taa_{key}_ns_row"] = cuda_ns_per_row(
                lambda: take_along_rows_reference(table, idx2), m2, iters)
            out[f"kernel_taa_{key}_ns_row"] = cuda_ns_per_row(
                lambda: take_along_rows(table, idx2), m2, iters)
            print(f"n={n} {key}: " + ", ".join(
                f"{k}={v:.4f}" for k, v in out.items()
                if key in k), file=sys.stderr)
    if gram:
        out.update(gram_probe(rng, idx, n, iters, dev))
    return out


def gram_probe(rng, idx, n: int, iters: int, dev, R: int = 32) -> dict:
    """Two-step gather -> einsum vs ``fused_gram`` on R-slot entities."""
    M = idx.shape[0]
    table = torch.as_tensor(rng.standard_normal((n, 64), dtype=np.float32),
                            device=dev).to(torch.bfloat16)
    rat = torch.as_tensor(rng.standard_normal(M, dtype=np.float32),
                          device=dev).to(torch.bfloat16).view(M // R, R)
    idx2 = idx.view(M // R, R)
    A, b = fused_gram(table, idx2, rat)
    Ap, bp = fused_gram_reference(table, idx2, rat)
    bA, bb = fused_gram_bound(table[idx2].float(), rat)
    err = max((A - Ap).abs().max().item(), (b - bp).abs().max().item())
    if not (bool(((A - Ap).abs() <= bA).all())
            and bool(((b - bp).abs() <= bb).all())):
        raise RuntimeError("fused_gram: outside its bound")
    del A, b, Ap, bp, bA, bb
    return {"gram_R": R, "gram_max_abs_err": err,
            "plain_gram_w64_bf16_ns_row": cuda_ns_per_row(
                lambda: fused_gram_reference(table, idx2, rat), M, iters),
            "kernel_gram_w64_bf16_ns_row": cuda_ns_per_row(
                lambda: fused_gram(table, idx2, rat), M, iters)}


if __name__ == "__main__":
    main()
