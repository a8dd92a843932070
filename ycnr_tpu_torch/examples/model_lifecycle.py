"""The model lifecycle, end to end on one synthetic catalog:

1. train ALS and checkpoint it,
2. new users, items and ratings arrive (the catalog grows),
3. warm-start a new run from the checkpoint (``train(warm_start=...)``:
   trained rows carry over, new entities get a fresh init),
4. serve the refreshed model and fetch many users in one ``batch:``
   request through the TCP server.

Run: python -m ycnr_tpu_torch.examples.model_lifecycle [--device cpu]
"""

import argparse
import json
import os
import socket
import tempfile
import threading

import numpy as np

OLD_U, OLD_I, NEW_U, NEW_I = 800, 300, 1000, 360


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", help="torch device (default: the card)")
    args = ap.parse_args(argv)

    from ycnr_tpu_torch.config import ALSConfig, DataConfig, RunConfig
    from ycnr_tpu_torch.data.dataset import Dataset
    from ycnr_tpu_torch.data.split import train_test_split
    from ycnr_tpu_torch.data.synthetic import synthetic_ratings
    from ycnr_tpu_torch.serve.engine import Recommender
    from ycnr_tpu_torch.serve.server import ServingApp, serve_tcp
    from ycnr_tpu_torch.train.loop import train

    def make_ds(u, i, r, n_users, n_items):
        (tu, ti, tr), (su, si, sr) = train_test_split(u, i, r, 0.1, seed=5)
        return Dataset(n_users=n_users, n_items=n_items, train_u=tu,
                       train_i=ti, train_r=tr, test_u=su, test_i=si,
                       test_r=sr, mu=float(tr.mean()), chunk_len=16,
                       rank_hint=8)

    def cfg(epochs):
        return RunConfig(name="lifecycle", algorithm="als",
                         data=DataConfig(source="synthetic", chunk_len=16),
                         als=ALSConfig(rank=8, lam=0.05, epochs=epochs),
                         out_dir="", seed=3, checkpoint_every=1,
                         log_train_rmse=False)

    # one planted model; the "old" dataset only saw part of the catalog
    u, i, r = synthetic_ratings(NEW_U, NEW_I, 50_000, true_rank=5, seed=11)
    old_mask = (u < OLD_U) & (i < OLD_I)
    old_ds = make_ds(u[old_mask], i[old_mask], r[old_mask], OLD_U, OLD_I)
    new_ds = make_ds(u, i, r, NEW_U, NEW_I)

    with tempfile.TemporaryDirectory() as tmp:
        base = train(cfg(4), dataset=old_ds, out_dir=tmp,
                     device=args.device)
        print(f"base run: {len(base.rmse_history)} epochs, "
              f"rmse {base.rmse_history[-1]:.4f} on {OLD_U}x{OLD_I}")
        warm = train(cfg(2), dataset=new_ds,
                     warm_start=os.path.join(tmp, "ckpt"), out_dir=None,
                     device=args.device)
        print(f"warm-start run: rmse {warm.rmse_history[-1]:.4f} on grown "
              f"{NEW_U}x{NEW_I} (+{NEW_U - OLD_U} users, "
              f"+{NEW_I - OLD_I} items)")

    # -- serve the refreshed model; fetch a whole cohort in one batch line -
    app = ServingApp(Recommender(warm.state, new_ds.train_u, new_ds.train_i,
                                 train_r=new_ds.train_r),
                     n=5, store_meta={"n_users": NEW_U, "n_items": NEW_I})
    srv = serve_tcp(app, "127.0.0.1", 0)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    cohort = [int(x) for x in
              np.random.default_rng(0).choice(NEW_U, 64, replace=False)]
    with socket.create_connection(srv.server_address[:2]) as s:
        f = s.makefile("rw")
        f.write("batch:" + ",".join(map(str, cohort)) + "\n")
        f.flush()
        resp = json.loads(f.readline())
    srv.shutdown()
    srv.server_close()
    app.close()
    if resp.get("users") != cohort or len(resp["items"]) != len(cohort):
        raise SystemExit(f"unexpected batch response: {resp}")
    new_user = NEW_U - 1  # existed only in the grown catalog
    top = (resp["items"][cohort.index(new_user)] if new_user in cohort
           else "n/a")
    print(f"batch response: {len(resp['items'])} users in one line; "
          f"new user {new_user} top-5 = {top}")
    print("served grown-catalog cohort OK")


if __name__ == "__main__":
    main()
