"""BPR batch-size A/B on the card (counterpart of the JAX package's
``tools/bench_bpr_batch.py``, with its flags and JSON lines; ``--device``
added).

Batch size is the one lever the BPR epoch has that changes its rate: per-row
costs fall with larger batches, at a cost in sequential steps an epoch.
This tool measures what that buys on the REAL epoch and what it costs in
quality: epoch wall time AND the hit@10 trajectory at each batch size,
same data, same seed, ``emean`` + ``batches`` (the production path).

    python -m ycnr_tpu_torch.tools.bench_bpr_batch --batches 65536 262144 \\
        --epochs 6
    python -m ycnr_tpu_torch.tools.bench_bpr_batch --scale smoke \\
        --batches 4096 --epochs 2 --device cpu

One JSON line per batch size on stdout (``batch``, ``epochs``,
``first_s``, ``steady_s``, ``hit10``); diagnostics on stderr. Uses the
bench's ML-20M COO cache (``tools/bench_ooc.get_coo``).
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from ycnr_tpu_torch.tools.bench import json_stdout, log, sync, tool_device


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batches", type=int, nargs="+",
                    default=[65536, 262144])
    ap.add_argument("--epochs", type=int, default=6)
    ap.add_argument("--rank", type=int, default=32)
    ap.add_argument("--scale", default="ml20m")
    ap.add_argument("--eval-users", type=int, default=2048)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card, 'cuda'; 'cpu' "
                         "for a CPU run)")
    args = ap.parse_args(argv)
    device = tool_device(args, "bench_bpr_batch")
    with json_stdout() as emit:
        return _run(args, device, emit)


def _run(args, device, emit) -> list:
    from ycnr_tpu_torch import full_precision_matmul
    from ycnr_tpu_torch.eval.ranking import hit_rate_at_n
    from ycnr_tpu_torch.models.base import init_state
    from ycnr_tpu_torch.models.bpr import BPRTrainer, prepare_bpr_data
    from ycnr_tpu_torch.tools.bench import cached_coo
    from ycnr_tpu_torch.tools.bench_ooc import SCALES

    full_precision_matmul()
    nu, ni, nr = SCALES[args.scale]
    # the test split: the cache holds train AND test under one tag
    (tu, ti, _), (su, si, _) = cached_coo(nu, ni, nr, 0)
    log(f"device: {device}")

    rows = []
    for B in args.batches:
        t0 = time.time()
        data = prepare_bpr_data(tu, ti, B, nu, ni, shuffle_rows_seed=0,
                                device=device)
        log(f"B={B}: prep {time.time() - t0:.1f}s "
            f"({data.u.shape[0] // B} batches)")
        trainer = BPRTrainer(lam=0.01, lr=0.05, lr_decay=0.98,
                             batch_size=B, seed=0, grad_mode="emean",
                             shuffle="batches")
        state = init_state(nu, ni, args.rank, seed=0, device=device)
        times, hits = [], []
        for ep in range(args.epochs):
            t0 = time.time()
            state = trainer.epoch(state, data, ep)
            sync(device)
            times.append(time.time() - t0)
            h = hit_rate_at_n(state, tu, ti, su, si, 10,
                              max_users=args.eval_users, seed=0)
            hits.append(round(float(h), 4))
            log(f"B={B} epoch {ep}: {times[-1]:.3f}s hit@10={hits[-1]}")
        steady = float(np.median(times[1:])) if len(times) > 1 else times[0]
        row = {"batch": B, "epochs": args.epochs,
               "first_s": round(times[0], 3), "steady_s": round(steady, 3),
               "hit10": hits}
        emit(row)
        rows.append(row)
        del data, state
    return rows


if __name__ == "__main__":
    main()
