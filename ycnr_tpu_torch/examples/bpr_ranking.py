"""Implicit-feedback ranking end to end: BPR-MF training and ranked
serving.

* trains BPR (``models/bpr.py``: pairwise ranking with negatives drawn on
  the device),
* compares ranking quality (hit-rate@10 / NDCG@10) against the pointwise
  implicit model (iALS) on the same data, and
* serves "because you liked X" recommendations plus point predictions
  from the trained factors.

(A popularity top-10 is printed for context: on this synthetic set which
items get interacted with is Zipf-sampled by construction, so popularity
is a strong random-holdout baseline; the model-to-model comparison is the
meaningful one.)

Run: python -m ycnr_tpu_torch.examples.bpr_ranking [--device cpu]
"""

import argparse

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", help="torch device (default: the card)")
    args = ap.parse_args(argv)

    from ycnr_tpu_torch.config import (BPRConfig, DataConfig, IALSConfig,
                                       RunConfig)
    from ycnr_tpu_torch.eval.ranking import ranking_metrics_at_n
    from ycnr_tpu_torch.eval.recommend import top_popular
    from ycnr_tpu_torch.serve.engine import Recommender
    from ycnr_tpu_torch.train.loop import train

    cfg = RunConfig(
        name="bpr-example", algorithm="bpr", out_dir="",
        data=DataConfig(source="synthetic", n_users=400, n_items=200,
                        n_ratings=12_000, true_rank=6, chunk_len=16),
        bpr=BPRConfig(rank=16, lam=0.01, lr=0.1, epochs=15,
                      batch_size=2048),
        topn=10)

    res = train(cfg, device=args.device)
    hr_traj = [round(1.0 - x, 3) for x in res.rmse_history]
    print("hit-rate@10 trajectory:", hr_traj)
    if not hr_traj[-1] > hr_traj[0]:
        raise SystemExit("ranking quality should improve")

    ds = res.dataset
    m = ranking_metrics_at_n(res.state, ds.train_u, ds.train_i,
                             ds.test_u, ds.test_i, n=10, max_users=512)
    print(f"BPR     hit@10={m['hit_rate']:.3f} ndcg@10={m['ndcg']:.3f}")

    # pointwise implicit model on the same data (same rank, same split)
    ials_res = train(RunConfig(
        name="ials-baseline", algorithm="ials", out_dir="",
        data=cfg.data, ials=IALSConfig(rank=16, lam=0.1, alpha=10.0,
                                       epochs=8),
        topn=10), dataset=ds, device=args.device)
    mi = ranking_metrics_at_n(ials_res.state, ds.train_u, ds.train_i,
                              ds.test_u, ds.test_i, n=10, max_users=512)
    print(f"iALS    hit@10={mi['hit_rate']:.3f} ndcg@10={mi['ndcg']:.3f}  "
          f"(pairwise lift {m['hit_rate'] / max(mi['hit_rate'], 1e-9):.2f}x)")
    if not m["hit_rate"] > mi["hit_rate"]:
        raise SystemExit("pairwise ranking should beat the pointwise model "
                         "at ranking")

    # popularity context (see the module docstring)
    pop = top_popular(ds.train_i, ds.n_items, 10)
    by_user = {}
    for u, i in zip(ds.test_u.tolist(), ds.test_i.tolist()):
        by_user.setdefault(u, set()).add(i)
    pop_hit = np.mean([bool(by_user[u] & set(pop.tolist()))
                       for u in by_user])
    print(f"popular hit@10={pop_hit:.3f}  (Zipf-sampled interactions: "
          f"popularity is a strong baseline on this synthetic set)")

    # serving from the ranked model: top-N, similar items, point predictions
    rec = Recommender(res.state, ds.train_u, ds.train_i, train_r=ds.train_r)
    uid = int(ds.test_u[0])
    top = rec.recommend(uid, 5)
    print(f"user {uid}: top-5 {top.tolist()}")
    if set(top.tolist()) & set(ds.train_i[ds.train_u == uid].tolist()):
        raise SystemExit("rated items must be masked")
    scores = rec.predict(uid, top[:3])
    print(f"user {uid}: predict({top[:3].tolist()}) -> "
          f"{[round(float(s), 3) for s in scores]}")
    liked = int(ds.train_i[ds.train_u == uid][0])
    print(f"because you liked {liked}: {rec.similar(liked, 5).tolist()}")
    print("OK")


if __name__ == "__main__":
    main()
