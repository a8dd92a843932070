"""Train on your own (user, item, rating) arrays through the library API.

Run: python -m ycnr_tpu_torch.examples.train_custom_data [--device cpu]
"""

import argparse

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", help="torch device (default: the card)")
    args = ap.parse_args(argv)

    from ycnr_tpu_torch.config import ALSConfig, DataConfig, RunConfig
    from ycnr_tpu_torch.data.dataset import Dataset
    from ycnr_tpu_torch.data.split import train_test_split
    from ycnr_tpu_torch.serve.engine import Recommender
    from ycnr_tpu_torch.train.loop import train

    # --- your ratings: three parallel arrays (dense 0-based ids) ----------
    rng = np.random.default_rng(0)
    n_users, n_items = 800, 300
    u = rng.integers(0, n_users, 30_000).astype(np.int32)
    i = rng.integers(0, n_items, 30_000).astype(np.int32)
    r = rng.uniform(1.0, 5.0, 30_000).astype(np.float32)

    (tu, ti, tr), (su, si, sr) = train_test_split(u, i, r,
                                                  test_fraction=0.1, seed=0)
    ds = Dataset(n_users=n_users, n_items=n_items,
                 train_u=tu, train_i=ti, train_r=tr,
                 test_u=su, test_i=si, test_r=sr,
                 mu=float(tr.mean()), chunk_len=16, rank_hint=16)

    cfg = RunConfig(name="custom", algorithm="als",
                    data=DataConfig(chunk_len=16),
                    als=ALSConfig(rank=16, lam=0.05, epochs=5),
                    out_dir="")  # no artifacts; pass a dir to checkpoint
    result = train(cfg, dataset=ds, out_dir=None, device=args.device)
    print("rmse per epoch:", [round(x, 4) for x in result.rmse_history])

    # --- top-N for one user from the trained state ------------------------
    rec = Recommender(result.state, tu, ti, train_r=tr)
    print("user 42 top-5:", rec.recommend(42, n=5))


if __name__ == "__main__":
    main()
