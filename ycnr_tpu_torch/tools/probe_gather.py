"""Gather probe on the card: the port's counterpart of
``tools/probe_gather.py``.

Gathers m rows (default 2^23) from a factor table of 26,752 rows (the
ML-20M items table, padded: the U-phase's access pattern) at widths 64
and 128, bf16 and f32, and times device time per call over a CUDA graph
of ``--iters`` calls (which holds that many outputs: 4.3 GB each at
m = 2^23, w 128, f32). The table stays in the L2 from call to call, as the
U-phase finds it:

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


L2_BYTES = 50 * 2 ** 20  # the H100's L2


def graph_ms(fn, iters: int, warmup: int = 2, sets=((),)) -> float:
    """Mean device milliseconds per call over ``iters`` calls, from one
    CUDA graph of them replayed (CUDA events, after ``warmup`` calls on a
    side stream): device time, without the host's launch cost, which is
    about a short call's whole time.

    Call i runs ``fn(*sets[i % len(sets)])``, and the graph keeps every
    call's output, so no call writes over another's. With one set, a call
    finds the inputs that the call before it read in the L2 (where they
    fit); with ``cold_sets(...)`` of them it finds its own cold."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for i in range(warmup):
            fn(*sets[i % len(sets)])
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = [fn(*sets[i % len(sets)]) for i in range(iters)]
    del outs
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def cold_sets(tensors, call_bytes: int, iters: int):
    """Copies of ``tensors`` for ``graph_ms(sets=...)``: enough that the
    calls between two uses of one copy move four L2s' worth of
    ``call_bytes`` each, which evicts that copy; at most ``iters``."""
    k = min(iters, max(2, 1 + -(-4 * L2_BYTES // max(1, call_bytes))))
    return [tuple(tensors)] + [tuple(t.clone() for t in tensors)
                               for _ in range(k - 1)]


def cuda_ns_per_row(fn, rows: int, iters: int) -> float:
    """Mean device nanoseconds per row over ``iters`` calls (``graph_ms``)."""
    return graph_ms(fn, iters) * 1e6 / rows


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
    ap.add_argument("--iters", type=int, default=5)
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
