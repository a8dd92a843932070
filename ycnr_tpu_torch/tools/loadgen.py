"""Concurrent serving load generator (counterpart of the JAX package's
``tools/loadgen.py``, with its flags and JSON line; ``--device`` in place
of ``--platform``).

Boots ``python -m ycnr_tpu_torch serve --listen 127.0.0.1:0`` with the
given factors and store, reads its ready line, drives it with N concurrent
per-line clients over TCP (request ids cycle through the user space) and
prints one JSON line: throughput + the server's own latency histogram from
``stats``. The server process is killed at the end, whatever happens.

    python -m ycnr_tpu_torch.tools.loadgen --ckpt runs/ml20m-als/ckpt \\
        --store /path/to/store --clients 32 --requests 400 \\
        --serve-arg=--precompute
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import threading
import time

from ycnr_tpu_torch.tools.bench import json_stdout, log, tool_device


def client_loop(host, port, cid, reqs, n_users, umap, errors):
    try:
        s = socket.create_connection((host, port))
        f = s.makefile("rw")
        for k in range(reqs):
            dense = (cid * 7919 + k) % n_users
            # MovieLens-prepared stores carry id maps and the server
            # expects ORIGINAL dataset ids; dense 0-based ids only work
            # map-free
            uid = int(umap[dense]) if umap is not None else dense
            f.write(f"{uid}\n")
            f.flush()
            r = json.loads(f.readline())
            if "items" not in r:
                errors.append(r)
        s.close()
    except Exception as e:  # counted: a client that dies is an error
        errors.append({"error": repr(e), "client": cid})


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--store", required=True)
    ap.add_argument("--ckpt")
    ap.add_argument("--shm")
    ap.add_argument("--clients", type=int, default=32)
    ap.add_argument("--requests", type=int, default=400,
                    help="requests per client")
    ap.add_argument("-n", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="torch device of the server (default: the card; "
                         "'cpu' for a CPU run)")
    ap.add_argument("--serve-arg", action="append", default=[],
                    help="extra flag forwarded to `serve` (repeatable), "
                         "e.g. --serve-arg=--precompute")
    args = ap.parse_args(argv)
    device = tool_device(args, "loadgen")
    with json_stdout() as emit:
        return _run(args, device, emit)


def _run(args, device, emit) -> dict:
    cmd = [sys.executable, "-m", "ycnr_tpu_torch", "serve", "--store",
           args.store, "-n", str(args.n), "--listen",
           "127.0.0.1:0"] + args.serve_arg
    if args.ckpt:
        cmd += ["--ckpt", args.ckpt]
    if args.shm:
        cmd += ["--shm", args.shm]
    cmd += ["--device", str(device)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, text=True,
                            env=os.environ.copy())
    try:
        line = proc.stdout.readline()
        if not line:
            raise RuntimeError(f"serve exited with {proc.wait()} before "
                               f"its ready line: {' '.join(cmd)}")
        ready = json.loads(line)
        log("ready:", json.dumps(ready))
        host, port = ready["listen"].rsplit(":", 1)
        port = int(port)
        n_users = int(ready["users"])
        from ycnr_tpu_torch.data.store import RatingsStore

        maps = RatingsStore(args.store).id_maps()
        umap = maps[0] if maps is not None else None

        errors: list = []
        # one warmup pass: first-use costs out of the measurement
        client_loop(host, port, 0, min(8, args.requests), n_users, umap,
                    errors)
        t0 = time.time()
        threads = [threading.Thread(target=client_loop,
                                    args=(host, port, c, args.requests,
                                          n_users, umap, errors))
                   for c in range(args.clients)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        dt = time.time() - t0

        s = socket.create_connection((host, port))
        f = s.makefile("rw")
        f.write("stats\n")
        f.flush()
        stats = json.loads(f.readline())
        s.close()
        total = args.clients * args.requests
        out = {"clients": args.clients, "requests": total,
               "wall_s": round(dt, 3), "req_per_s": round(total / dt),
               "errors": len(errors), "server_latency": stats["latency"],
               "batches": stats.get("batches")}
        emit(out)
        return out
    finally:
        proc.kill()
        proc.wait()
        proc.stdout.close()


if __name__ == "__main__":
    main()
