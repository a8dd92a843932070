"""Hyperparameter sweep and item-similarity serving through the library
API: a lambda x seed grid (``train/tune.py``), then the winner serves user
top-N, "more like this" item queries and precomputed caches — the
``tune`` / ``recommend --similar`` / ``serve --precompute*`` commands as
library calls.

Run: python -m ycnr_tpu_torch.examples.tune_and_similar [--device cpu]
"""

import argparse
import dataclasses


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", help="torch device (default: the card)")
    args = ap.parse_args(argv)

    from ycnr_tpu_torch.config import get_preset
    from ycnr_tpu_torch.serve.engine import Recommender
    from ycnr_tpu_torch.train.tune import tune

    # sweep lambda x init seed on a small synthetic set
    cfg = get_preset("ml100k-als")
    cfg = dataclasses.replace(
        cfg, out_dir=None,
        data=dataclasses.replace(cfg.data, source="synthetic", n_users=300,
                                 n_items=500, n_ratings=10_000),
        als=dataclasses.replace(cfg.als, rank=8))
    res = tune(cfg, lams=[0.02, 0.05, 0.2], seeds=[0, 1], epochs=4,
               device=args.device)
    for e in res.leaderboard:
        print(f"lam={e['lam']:<5} seed={e['seed']} "
              f"rmse={e['rmse_final']:.4f} (best epoch {e['best_epoch']})")
    print(f"winner: lam={res.best['lam']} seed={res.best['seed']}")

    # the winner's trained state serves directly
    ds = res.dataset
    rec = Recommender(res.best_state, ds.train_u, ds.train_i,
                      train_r=ds.train_r)
    uid = int(ds.train_u[0])
    print("top-5 for user", uid, "->", list(map(int, rec.recommend(uid, 5))))

    # item-item: "more like this" over the trained item factors
    iid = int(ds.train_i[0])
    print("items similar to", iid, "->", list(map(int, rec.similar(iid, 5))))
    print("  (dot metric)   ->",
          list(map(int, rec.similar(iid, 5, metric="dot"))))

    # bulk precompute: every rated user + every live item become cache hits
    users_cached = rec.precompute_all(n=5)
    items_cached = rec.precompute_similar(n=5)
    hits0 = rec.cache.hits
    rec.recommend(uid, 5)
    rec.similar(iid, 5)
    if rec.cache.hits != hits0 + 2:
        raise SystemExit("expected pure cache hits")
    print(f"precomputed {users_cached} user lists + {items_cached} "
          f"similarity lists; follow-up requests were cache hits OK")


if __name__ == "__main__":
    main()
