"""Traffic kind ``open_loop``: single-user top-n requests to the port's
TCP server, sent by a child process on a fixed schedule (an open loop),
at the rate that the cell's file fixes.

Set-up makes the ratings and the served factors on the device from the
seed (as ``passes`` does), writes a ratings store of the training split
and a checkpoint of the factors into a temporary directory, and builds
the server as the ``serve --ckpt --store --listen`` command does
(``RatingsStore.read_all``, ``load_checkpoint``, ``Recommender``,
``ServingApp``, ``serve_tcp``), in this process, without shared memory.
It warms the engine at every batch size the batcher can form.

The schedule holds ``rate * seconds`` requests, due at times drawn
uniformly over the window and sorted (arrivals of a Poisson process with
their count fixed), for users drawn in proportion to their number of
training ratings. A request is timed from its due time to the last byte
of its reply; one that fails or is never answered counts as the longest.
After the window every answered list is judged by the plain reference.
"""

from __future__ import annotations

import json
import os
import shutil
import socket
import subprocess
import sys
import tempfile
import threading
import time
from types import SimpleNamespace

import numpy as np
import torch

from portbench import harness
from portbench.gen import ratings as gen
from portbench.reference import topn as ref_topn

CLIENT = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "open_loop_client.py")


def stats(port: int) -> dict:
    """The server's ``stats`` reply."""
    with socket.create_connection(("127.0.0.1", port), timeout=30) as s:
        s.sendall(b"stats\n")
        f = s.makefile("rb")
        return json.loads(f.readline())


class Run:
    def __init__(self, spec, seed: int, device, phases, tracing: bool):
        self.spec, self.seed, self.device, self.ph = spec, seed, device, phases
        self.c, self.mix, self.tracing = spec.config, spec.mix, tracing

    def setup(self):
        from ycnr_tpu_torch.data.store import RatingsStore
        from ycnr_tpu_torch.models.base import state_from_numpy
        from ycnr_tpu_torch.serve.engine import Recommender
        from ycnr_tpu_torch.serve.server import ServingApp, serve_tcp
        from ycnr_tpu_torch.train.checkpoint import (load_checkpoint,
                                                     save_checkpoint)

        c, dev, ph, mix = self.c, self.device, self.ph, self.mix
        d = self.data = gen.make_for(c, self.seed, dev)
        nu, ni, k = d.n_users, d.n_items, c["rank"]
        ph.mark("generate")
        self.U = gen.served_factors(d.P, k, mix["factor_noise"], self.seed,
                                    dev, 3)
        self.V = gen.served_factors(d.Q, k, mix["factor_noise"], self.seed,
                                    dev, 4)
        tu = d.train_u.cpu().numpy().astype(np.int32)
        ti = d.train_i.cpu().numpy().astype(np.int32)
        tr = d.train_r.cpu().numpy()
        self.degree = np.bincount(tu, minlength=nu)
        self.tmp = tempfile.mkdtemp(prefix="portbench-online-")
        store_dir = os.path.join(self.tmp, "store")
        ckpt = os.path.join(self.tmp, "ckpt")
        RatingsStore(store_dir).append(tu, ti, tr)
        save_checkpoint(ckpt, state_from_numpy(
            self.U.cpu().numpy(), self.V.cpu().numpy(), np.zeros(nu + 1),
            np.zeros(ni + 1), 0.0, device=dev), 1,
            config={"algorithm": c["algorithm"], "als": {"lam": c["lam"]}})
        del tu, ti, tr
        ph.mark("store and checkpoint")
        store = RatingsStore(store_dir)
        u, i, r = store.read_all()
        state0, manifest = load_checkpoint(ckpt, device=dev)
        self.rec = Recommender(state0, u, i, train_r=r)
        self.app = ServingApp(self.rec, maps=store.id_maps(), n=mix["n"],
                              fold_lam=c["lam"], store_meta=store.meta,
                              source="ckpt", epoch=manifest.get("epoch"))
        self.srv = serve_tcp(self.app, "127.0.0.1", 0)
        self.port = self.srv.server_address[1]
        self.thread = threading.Thread(target=self.srv.serve_forever,
                                       daemon=True)
        self.thread.start()
        ph.mark("server")
        warm = np.flatnonzero(self.degree)[:self.app.batcher.max_batch]
        for b in range(1, len(warm) + 1):
            self.rec.recommend_batch(warm[:b], mix["n"])
        ph.mark("warm batches")

    def window(self, seconds: float) -> dict:
        mix, rate = self.mix, self.spec.cell["rate_per_s"]
        total = seconds + (mix["trace_seconds"] if self.tracing else 0.0)
        rng = np.random.default_rng(self.seed)
        N = int(round(rate * total))
        due = np.sort(rng.uniform(0.0, total, N))
        users = rng.choice(len(self.degree), N,
                           p=self.degree / self.degree.sum())
        sched = os.path.join(self.tmp, "schedule.npz")
        out = os.path.join(self.tmp, "replies.npz")
        np.savez(sched, due=due, users=users)
        self.users_due, self.last_due = users, due
        hits0 = (self.rec.cache.hits, self.rec.cache.misses)
        proc = subprocess.Popen(
            [sys.executable, CLIENT, "--port", str(self.port), "--schedule",
             sched, "--out", out, "--connections", str(mix["connections"]),
             "--n", str(mix["n"]), "--wait", str(mix["wait_s"])],
            stdout=subprocess.PIPE, text=True)
        try:
            t0 = json.loads(proc.stdout.readline())["t0"]
            if self.tracing:
                time.sleep(max(0.0, t0 + seconds - time.perf_counter()))
                self.stats = stats(self.port)
                self.traced_ctx = harness.traced(
                    lambda: time.sleep(mix["trace_seconds"]), self.device,
                    all_threads=True)[1]
            proc.wait(timeout=total + mix["wait_s"] + 60)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        if not self.tracing:
            self.stats = stats(self.port)
        with np.load(out) as z:
            r = {k: z[k] for k in z.files}
        in_window = due < seconds
        lat = r["done"] - (r["t0"] + due)
        failed = r["status"] != 0
        lat[failed] = mix["wait_s"] + total  # past any limit
        lat = lat[in_window]
        p99 = float(np.quantile(lat, 0.99, method="inverted_cdf"))
        late = (r["sent"] - (r["t0"] + due))[np.isfinite(r["sent"])]
        hits = (self.rec.cache.hits - hits0[0],
                self.rec.cache.misses - hits0[1])
        harness.log(
            f"window: {int(in_window.sum())} requests due at "
            f"{rate} /s over {mix['connections']} connections; latency ms "
            f"p50 {1e3 * np.median(lat):.3f} p99 {1e3 * p99:.3f} "
            f"max {1e3 * lat.max():.3f}; failed {int(failed.sum())}; "
            f"sender lateness ms p50 {1e3 * np.median(late):.3f} p99 "
            f"{1e3 * np.quantile(late, 0.99):.3f} max {1e3 * late.max():.3f};"
            f" cache hits {hits[0]} misses {hits[1]}; stats {self.stats}")
        self.replies = r
        return {"metrics": {"request_p99_ms": 1e3 * p99},
                "attempted": int(in_window.sum()),
                "failed": int((failed & in_window).sum())}

    def trace(self) -> SimpleNamespace:
        return SimpleNamespace(trace=self.traced_ctx, config=self.c,
                               counts={}, units=0, stats=self.stats)

    def release(self):
        self.srv.shutdown()
        self.srv.server_close()
        self.thread.join(timeout=30)
        self.app.close()
        del self.app, self.rec, self.srv
        shutil.rmtree(self.tmp, ignore_errors=True)
        if torch.device(self.device).type == "cuda":
            torch.cuda.empty_cache()

    # -- the check ---------------------------------------------------------

    def readings(self, users, lists) -> dict:
        d = self.data
        both = np.unique(np.concatenate([users[:, None], lists], 1), axis=0)
        dev = self.device
        index = ref_topn.rated_index(d.train_u, d.train_i)
        r = ref_topn.check_lists(
            self.U, self.V, torch.as_tensor(both[:, 0], device=dev),
            torch.as_tensor(both[:, 1:], device=dev), self.mix["n"], index)
        failed = int((self.replies["status"] != 0).sum())
        harness.log(f"check: {r}; failed requests {failed}")
        return {"served_gap": r["gap"],
                "wrong_answers": r["rated"] + r["unknown"] + r["dup"]
                + r["short"] + failed}

    def check(self) -> dict:
        ok = self.replies["status"] == 0
        return self.readings(self.users_due[ok].astype(np.int64),
                             self.replies["items"][ok].astype(np.int64))

    def control_readings(self) -> dict:
        d = self.data
        ok = self.replies["status"] == 0
        users = np.unique(self.users_due[ok])
        lists = ref_topn.top_lists(
            self.U, self.V, torch.as_tensor(users, device=self.device),
            self.mix["n"], ref_topn.rated_index(d.train_u, d.train_i),
            self.spec.cell["control"])
        return self.readings(users.astype(np.int64),
                             lists.cpu().numpy().astype(np.int64))
