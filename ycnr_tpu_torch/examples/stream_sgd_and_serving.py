"""Stream-SGD training, then the concurrent TCP serving service with
dynamic micro-batching: trains SGD-MF with the stream epoch
(``models/sgd_stream.py``), serves the factors behind the
thread-per-connection TCP server (``serve/server.py``), fires a burst of
concurrent clients at it and prints the latency histogram from ``stats``.

Run: python -m ycnr_tpu_torch.examples.stream_sgd_and_serving [--device cpu]
"""

import argparse
import json
import socket
import threading

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", help="torch device (default: the card)")
    args = ap.parse_args(argv)

    from ycnr_tpu_torch.config import DataConfig, RunConfig, SGDConfig
    from ycnr_tpu_torch.serve.engine import Recommender
    from ycnr_tpu_torch.serve.server import ServingApp, serve_tcp
    from ycnr_tpu_torch.train.loop import train

    # -- train with the stream epoch ----------------------------------------
    cfg = RunConfig(
        name="stream-demo", algorithm="sgd",
        data=DataConfig(source="synthetic", n_users=1200, n_items=400,
                        n_ratings=60_000, true_rank=6, seed=11),
        sgd=SGDConfig(rank=8, lr=0.03, epochs=6, batch_size=2048,
                      method="stream"),
        out_dir="", checkpoint_every=0, log_train_rmse=False)
    res = train(cfg, out_dir=None, device=args.device)
    print(f"stream-SGD RMSE: {res.rmse_history[0]:.4f} -> "
          f"{res.rmse_history[-1]:.4f}")

    # -- serve it concurrently over TCP -------------------------------------
    ds = res.dataset
    rec = Recommender(res.state, ds.train_u, ds.train_i, train_r=ds.train_r)
    app = ServingApp(rec, n=10, store_meta={"n_users": ds.n_users,
                                            "n_items": ds.n_items})
    srv = serve_tcp(app, "127.0.0.1", 0)
    addr = srv.server_address[:2]
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    print(f"serving on {addr[0]}:{addr[1]}")

    def client(user_ids, out):
        with socket.create_connection(addr) as s:
            f = s.makefile("rw")
            for u in user_ids:
                f.write(f"{u}\n")
                f.flush()
                out.append(json.loads(f.readline()))

    rng = np.random.default_rng(0)
    outs = [[] for _ in range(8)]
    threads = [threading.Thread(
        target=client,
        args=(rng.integers(0, ds.n_users, 50).tolist(), outs[c]))
        for c in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if not all(len(o) == 50 and all("items" in r for r in o) for o in outs):
        raise SystemExit("a client got an error or a short answer")
    stats = json.loads(app.handle("stats"))
    lat = stats["latency"]
    print(f"served {lat['count']} requests; p50={lat['p50_ms']} ms "
          f"p99={lat['p99_ms']} ms batches={stats['batches']} (avg batch "
          f"{stats['batched_requests'] / max(stats['batches'], 1):.1f})")
    srv.shutdown()
    srv.server_close()
    app.close()
    print("OK")


if __name__ == "__main__":
    main()
