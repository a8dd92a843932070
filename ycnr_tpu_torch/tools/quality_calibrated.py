"""BPR-vs-iALS ranking quality on the calibrated synthetic generator
(counterpart of the JAX package's ``tools/quality_calibrated.py``, with
its scales, flags and JSON line; ``--device`` added).

Runs the comparison on ``data/synthetic.synthetic_ratings_calibrated`` —
the published-ML-20M-marginals generator (exact rating histogram via
quantile mapping, Pareto user degrees with the >=20 floor) — holding
everything else fixed: ONE dataset object (identical split) feeds both
trainers through the port's ``train()``, same rank / top-N / eval
sampling.

    python -m ycnr_tpu_torch.tools.quality_calibrated \\
        [--generator calibrated|planted] [--epochs 6] \\
        [--scale ml20m|smoke] [--out runs/quality] [--device cpu]

Emits one JSON line per run on stdout: per-epoch hit@10 trajectories for
each algorithm plus the final ranking suite (``ranking_metrics_at_n`` over
2048 sampled users); the same summary goes to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import os
import time

from ycnr_tpu_torch.tools.bench import cached_dataset, json_stdout, \
    tool_device

SCALES = {
    # ML-20M shape
    "ml20m": dict(n_users=138_493, n_items=26_744, n_ratings=20_000_263),
    # tiny CPU smoke for CI
    "smoke": dict(n_users=700, n_items=300, n_ratings=30_000),
}


def data_config(generator: str = "calibrated", scale: str = "ml20m",
                seed: int = 0):
    """The one dataset every algorithm of a run trains on."""
    from ycnr_tpu_torch.config import DataConfig

    return DataConfig(source="synthetic", synthetic_mode=generator,
                      seed=seed, chunk_len=32, **SCALES[scale])


def _epoch_records(out_dir):
    recs = []
    path = os.path.join(out_dir, "metrics.jsonl")
    with open(path) as f:
        for line in f:
            recs.append(json.loads(line))
    return recs


def run(algo, cfg, ds, out_root, device):
    from ycnr_tpu_torch.train.loop import train

    out = os.path.join(out_root, cfg.name)
    t0 = time.time()
    train(cfg, dataset=ds, out_dir=out, device=device)
    wall = time.time() - t0
    recs = _epoch_records(out)
    traj = [r["hit_rate"] for r in recs if "hit_rate" in r and "epoch" in r]
    final = next((r for r in recs if r.get("event") == "ranking"), {})
    return dict(algo=algo, hit_at_n=traj, wall_s=round(wall, 1),
                ranking={k: v for k, v in final.items() if k != "event"})


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--generator", choices=["calibrated", "planted"],
                    default="calibrated")
    ap.add_argument("--scale", choices=sorted(SCALES), default="ml20m")
    ap.add_argument("--epochs", type=int, default=6)
    ap.add_argument("--rank", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="runs/quality")
    ap.add_argument("--algos", default="bpr,ials",
                    help="comma list from bpr,ials,als,sgd — als/sgd are "
                         "the explicit trainers scored with the same "
                         "hit@N machinery (RunConfig.log_hit_rate)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card, 'cuda'; 'cpu' "
                         "for a CPU run)")
    args = ap.parse_args(argv)
    device = tool_device(args, "quality_calibrated")
    with json_stdout() as emit:
        return _run(ap, args, device, emit)


def _run(ap, args, device, emit) -> dict:
    from ycnr_tpu_torch.config import (ALSConfig, BPRConfig, IALSConfig,
                                       RunConfig, SGDConfig)

    data = data_config(args.generator, args.scale, args.seed)
    tag = f"{args.generator}-{args.scale}-r{args.rank}"
    cfgs = {
        "bpr": RunConfig(
            name=f"bpr-{tag}", algorithm="bpr", data=data,
            bpr=BPRConfig(rank=args.rank, lam=0.01, lr=0.05,
                          epochs=args.epochs, batch_size=65_536),
            checkpoint_every=0),
        "ials": RunConfig(
            name=f"ials-{tag}", algorithm="ials", data=data,
            ials=IALSConfig(rank=args.rank, lam=0.1, alpha=40.0,
                            epochs=args.epochs, gather_dtype="bfloat16"),
            checkpoint_every=0),
        # the explicit trainers on the SAME split, scored with the same
        # hit@N machinery: their score ordering (U.V + biases) ranks the
        # top-N even though the training objective is squared error
        "als": RunConfig(
            name=f"als-{tag}", algorithm="als", data=data,
            als=ALSConfig(rank=args.rank, lam=0.05, epochs=args.epochs,
                          gather_dtype="bfloat16"),
            log_hit_rate=True, checkpoint_every=0),
        "sgd": RunConfig(
            name=f"sgd-{tag}", algorithm="sgd", data=data,
            sgd=SGDConfig(rank=args.rank, lam=0.02, lr=0.005,
                          epochs=args.epochs, batch_size=65_536,
                          method="stream", grad_mode="mean"),
            log_hit_rate=True, checkpoint_every=0),
    }
    algos = [a.strip() for a in args.algos.split(",") if a.strip()]
    unknown = set(algos) - set(cfgs)
    if unknown:
        ap.error(f"unknown algos: {sorted(unknown)}")
    # ONE dataset -> identical train/test split for every algorithm (from
    # the bench cache when a run made it before)
    ds = cached_dataset(data, rank_hint=args.rank)
    results = [run(a, cfgs[a], ds, args.out, device) for a in algos]
    summary = dict(generator=args.generator, scale=args.scale,
                   rank=args.rank, epochs=args.epochs, seed=args.seed,
                   results=results)
    emit(summary)
    with open(os.path.join(args.out, f"quality_{tag}.json"), "w") as f:
        json.dump(summary, f, indent=1)
    return summary


if __name__ == "__main__":
    main()
