"""Sustained serving soak on the card (counterpart of the JAX package's
``tools/soak.py``, with its flags and JSON lines; ``--device`` in place of
``--platform``).

16+ concurrent mixed-request TCP clients against a ``ServingApp`` in shm
hot-reload mode with the cross-process cache (``ShmRecCache``), while a
trainer thread republishes new factors every ``--republish`` seconds.
Each request's wall time is bucketed on the client into two phases: STORM
(within ``--storm-window`` s after a republish) and CALM, so the p50 / p99
cost of hot-reload + cache invalidation churn is measured directly. Every
16th line of a client is a ``stats`` probe (not timed) whose epoch must
never go back on that connection (``epoch_regressions``).

    python -m ycnr_tpu_torch.tools.soak --users 138493 --items 26744 \\
        --rank 64 --duration 60 --clients 16 --republish 2

Prints a ready line and then one JSON line of the measurement on stdout;
the shared-memory segments get unique names and are unlinked at the end,
whatever happens.
"""

from __future__ import annotations

import argparse
import json
import socket
import threading
import time
import uuid

import numpy as np

from ycnr_tpu_torch.tools.bench import json_stdout, tool_device

PROBE_EVERY = 16  # every 16th line of a client asks for `stats`


def pctl(xs, p):
    return float(np.percentile(np.asarray(xs), p) * 1000) if xs else None


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--users", type=int, default=138_493)
    ap.add_argument("--items", type=int, default=26_744)
    ap.add_argument("--rank", type=int, default=64)
    ap.add_argument("--ratings", type=int, default=2_000_000)
    ap.add_argument("--duration", type=float, default=60.0)
    ap.add_argument("--clients", type=int, default=16)
    ap.add_argument("--republish", type=float, default=2.0)
    ap.add_argument("--storm-window", type=float, default=0.5,
                    help="seconds after a republish counted as 'storm'")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card, 'cuda'; 'cpu' "
                         "for a CPU run)")
    args = ap.parse_args(argv)
    device = tool_device(args, "soak")
    with json_stdout() as emit:
        return _run(args, device, emit)


def _run(args, device, emit) -> dict:
    from ycnr_tpu_torch import full_precision_matmul
    from ycnr_tpu_torch.models.base import init_state
    from ycnr_tpu_torch.native import get_cache_lib, get_shm_lib
    from ycnr_tpu_torch.serve.cache import ShmRecCache
    from ycnr_tpu_torch.serve.server import ServingApp, serve_tcp
    from ycnr_tpu_torch.serve.shm import FactorShmWriter, ShmRecommender

    full_precision_matmul()
    nu, ni, k = args.users, args.items, args.rank
    rng = np.random.default_rng(0)
    train_u = rng.integers(0, nu, args.ratings).astype(np.int32)
    train_i = rng.integers(0, ni, args.ratings).astype(np.int32)
    shm_name = f"/ycnr_soak_{uuid.uuid4().hex[:10]}"
    cache_name = f"/ycnr_soakc_{uuid.uuid4().hex[:10]}"

    def state(e):
        return init_state(nu, ni, k, seed=e, device=device)

    pub_times = []  # republish wall-clock stamps (shared, append-only)
    w = cache = rec = app = srv = None
    try:
        w = FactorShmWriter(shm_name, nu, ni, k)
        w.publish(state(1), 1)
        cache = ShmRecCache(cache_name, 1 << 16, epoch=1)
        rec = ShmRecommender(shm_name, train_u, train_i, cache=cache,
                             device=device)
        app = ServingApp(rec, n=10, shm=True, max_batch=64)
        srv = serve_tcp(app, "127.0.0.1", 0)
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        addr = srv.server_address
        emit({"event": "ready", "addr": list(addr), "device": str(device)})
        out = _soak(args, addr, w, state, pub_times)
        emit(out)
        return out
    finally:
        if srv is not None:
            srv.shutdown()
            srv.server_close()
        for x in (app, rec, cache, w):
            if x is not None:
                x.close()
        get_shm_lib().ycnr_shm_unlink(shm_name.encode())
        get_cache_lib().ycnr_cache_unlink(cache_name.encode())


def _soak(args, addr, w, state, pub_times) -> dict:
    nu, ni = args.users, args.items
    stop = threading.Event()

    def publisher():
        e = 2
        while not stop.wait(args.republish):
            w.publish(state(e), e)
            pub_times.append(time.time())
            e += 1

    calm, storm, errors = [], [], []
    regressions = [0]
    lock = threading.Lock()

    def client(cid):
        try:
            run_client(cid)
        except Exception as e:  # counted: a client that dies is an error
            with lock:
                errors.append({"error": repr(e), "client": cid})

    def run_client(cid):
        rng = np.random.default_rng(1000 + cid)
        s = socket.create_connection(addr)
        f = s.makefile("rw")
        my_calm, my_storm = [], []
        last_epoch = -1
        deadline = time.time() + args.duration
        sent = 0
        while time.time() < deadline:
            sent += 1
            if sent % PROBE_EVERY == 0:
                f.write("stats\n")
                f.flush()
                ep = json.loads(f.readline())["epoch"]
                if ep < last_epoch:
                    with lock:
                        regressions[0] += 1
                last_epoch = max(last_epoch, ep)
                continue
            kind = rng.integers(0, 8)
            u = int(rng.integers(0, nu))
            if kind <= 3:
                line = str(u)
            elif kind == 4:
                line = "batch:" + ",".join(
                    str(int(x)) for x in rng.integers(0, nu, 4))
            elif kind == 5:
                line = f"similar:{int(rng.integers(0, ni))}"
            elif kind == 6:
                line = f"predict:{u}:" + ",".join(
                    str(int(x)) for x in rng.integers(0, ni, 3))
            else:
                line = f"exclude:{u}:{int(rng.integers(0, ni))}"
            t0 = time.time()
            f.write(line + "\n")
            f.flush()
            r = json.loads(f.readline())
            dt = time.time() - t0
            if "error" in r:
                with lock:
                    errors.append(r)
            in_storm = any(t0 - p < args.storm_window for p in
                           pub_times[-3:])
            (my_storm if in_storm else my_calm).append(dt)
        f.close()
        s.close()
        with lock:
            calm.extend(my_calm)
            storm.extend(my_storm)

    threads = [threading.Thread(target=client, args=(c,), daemon=True)
               for c in range(args.clients)]
    t0 = time.time()
    pub = threading.Thread(target=publisher, daemon=True)
    pub.start()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    stop.set()
    pub.join()
    wall = time.time() - t0

    s = socket.create_connection(addr)
    f = s.makefile("rw")
    f.write("stats\n")
    f.flush()
    st = json.loads(f.readline())
    f.close()
    s.close()
    total = len(calm) + len(storm)
    out = {
        "event": "soak", "duration_s": round(wall, 1),
        "clients": args.clients, "republish_s": args.republish,
        "republishes": len(pub_times), "requests": total,
        "req_per_s": round(total / wall, 1), "errors": len(errors),
        "calm": {"n": len(calm),
                 "p50_ms": round(pctl(calm, 50), 2) if calm else None,
                 "p99_ms": round(pctl(calm, 99), 2) if calm else None},
        "storm": {"n": len(storm),
                  "p50_ms": round(pctl(storm, 50), 2) if storm else None,
                  "p99_ms": round(pctl(storm, 99), 2) if storm else None},
        "server_epoch": st["epoch"],
        "server_latency": st["latency"],
        "epoch_regressions": regressions[0],
        "error_samples": errors[:3]}
    return out


if __name__ == "__main__":
    main()
