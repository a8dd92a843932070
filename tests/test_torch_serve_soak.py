"""Sustained serving soak through the port, the counterpart of
``tests/test_serve_soak.py``: mixed request kinds (user / batch / cold /
similar / predict / exclude) from 16 concurrent TCP clients against a live
server in shm hot-reload mode with the cross-process recommendation cache,
while a trainer thread republishes new factors. Each published epoch plants
a +50 item bias on a reserved, never-rated marker item, so every list's
first item decodes the epoch it was computed against. Asserts:

- zero error responses under the publish storm;
- within one connection the decoded epoch never goes back (a stale cache
  hit surviving an epoch change would);
- after the last publish settles, requests serve the final epoch.

Duration: ``YCNR_SOAK_S`` seconds (default 8, so the CPU suite stays well
inside its time limit)."""

import json
import os
import socket
import threading
import time
import uuid

import numpy as np
import torch

from ycnr_tpu_torch.models.base import init_state
from ycnr_tpu_torch.native import get_cache_lib, get_shm_lib
from ycnr_tpu_torch.serve.cache import ShmRecCache
from ycnr_tpu_torch.serve.server import ServingApp, serve_tcp
from ycnr_tpu_torch.serve.shm import FactorShmWriter, ShmRecommender

torch.set_num_threads(1)

N_USERS, N_ITEMS, RANK = 300, 160, 6
MARKER0 = 100  # items >= MARKER0 are never rated; marker = MARKER0 + epoch


def _state(epoch: int):
    st = init_state(N_USERS, N_ITEMS, RANK, seed=0, device="cpu")
    bi = torch.zeros(N_ITEMS + 1)
    bi[MARKER0 + epoch] = 50.0  # dominates every user's scores
    return st._replace(bi=bi)


def _epoch_of(items) -> int:
    assert items and int(items[0]) >= MARKER0, items
    return int(items[0]) - MARKER0


class _Client(threading.Thread):
    def __init__(self, addr, rng_seed, deadline, errors, regressions):
        super().__init__(daemon=True)
        self.addr = addr
        self.rng = np.random.default_rng(rng_seed)
        self.deadline = deadline
        self.errors = errors
        self.regressions = regressions
        self.last_epoch = -1
        self.n_reqs = 0

    def _note_epoch(self, e: int):
        if e < self.last_epoch:
            self.regressions.append((self.last_epoch, e))
        self.last_epoch = max(self.last_epoch, e)

    def run(self):
        s = socket.create_connection(self.addr)
        f = s.makefile("rw")

        def ask(line):
            f.write(line + "\n")
            f.flush()
            r = json.loads(f.readline())
            self.n_reqs += 1
            if "error" in r:
                self.errors.append(r)
            return r

        while time.time() < self.deadline:
            kind = self.rng.integers(0, 8)
            u = int(self.rng.integers(0, N_USERS))
            if kind <= 2:  # plain user recs (the hot path)
                r = ask(str(u))
                if "items" in r:
                    self._note_epoch(_epoch_of(r["items"]))
            elif kind == 3:
                us = ",".join(str(int(x)) for x in
                              self.rng.integers(0, N_USERS, 3))
                r = ask(f"batch:{us}")
                for row in r.get("items", []):
                    self._note_epoch(_epoch_of(row))
            elif kind == 4:
                items = self.rng.choice(MARKER0, 4, replace=False)
                pairs = ",".join(f"{int(i)}:{4.5}" for i in items)
                r = ask(f"cold:{pairs}")
                if "items" in r:
                    self._note_epoch(_epoch_of(r["items"]))
            elif kind == 5:
                ask(f"similar:{int(self.rng.integers(0, MARKER0))}")
            elif kind == 6:
                items = ",".join(str(int(x)) for x in
                                 self.rng.integers(0, MARKER0, 3))
                r = ask(f"predict:{u}:{items}")
                assert "scores" not in r or len(r["scores"]) == 3
            else:
                # exclude a non-marker item: top-1 still decodes the epoch
                r = ask(f"exclude:{u}:{int(self.rng.integers(0, MARKER0))}")
                if "items" in r:
                    self._note_epoch(_epoch_of(r["items"]))
        f.close()
        s.close()


def test_serving_soak_under_republish_storm():
    dur = float(os.environ.get("YCNR_SOAK_S", "8"))
    shm_name = f"/ycnr_tsoak_{uuid.uuid4().hex[:10]}"
    cache_name = f"/ycnr_tsoakc_{uuid.uuid4().hex[:10]}"
    rng = np.random.default_rng(0)
    train_u = rng.integers(0, N_USERS, 5000).astype(np.int32)
    train_i = rng.integers(0, MARKER0, 5000).astype(np.int32)

    n_pubs = min(int(N_ITEMS - MARKER0 - 2), max(4, int(dur / 2)))
    interval = dur / (n_pubs + 1)
    pub_done = threading.Event()
    try:
        with FactorShmWriter(shm_name, N_USERS, N_ITEMS, RANK) as w:
            w.publish(_state(1), 1)
            cache = ShmRecCache(cache_name, 1 << 14, epoch=1)
            rec = ShmRecommender(shm_name, train_u, train_i, cache=cache,
                                 device="cpu")
            app = ServingApp(rec, n=10, shm=True, max_batch=16)
            srv = serve_tcp(app, "127.0.0.1", 0)
            threading.Thread(target=srv.serve_forever, daemon=True).start()
            addr = srv.server_address
            last_epoch = [1]

            def publisher():
                for e in range(2, n_pubs + 1):
                    time.sleep(interval)
                    w.publish(_state(e), e)
                    last_epoch[0] = e
                pub_done.set()

            errors, regressions = [], []
            deadline = time.time() + dur
            t_pub = threading.Thread(target=publisher, daemon=True)
            t_pub.start()
            clients = [_Client(addr, 100 + c, deadline, errors, regressions)
                       for c in range(16)]
            for c in clients:
                c.start()
            for c in clients:
                c.join(timeout=dur + 60)
                assert not c.is_alive(), "client wedged"
            t_pub.join(timeout=60)
            assert pub_done.is_set()

            assert errors == [], errors[:5]
            assert regressions == [], regressions[:5]
            total = sum(c.n_reqs for c in clients)
            assert total > 16 * 20, f"soak too thin: {total} requests"

            # convergence: a fresh request now serves the final epoch
            with socket.create_connection(addr) as s:
                f = s.makefile("rw")
                f.write("7\n")
                f.flush()
                r = json.loads(f.readline())
                assert _epoch_of(r["items"]) == last_epoch[0] == n_pubs
                f.write("stats\n")
                f.flush()
                st = json.loads(f.readline())
            assert st["epoch"] == n_pubs
            assert st["latency"]["count"] >= total
            srv.shutdown()
            srv.server_close()
            app.close()
            rec.close()
            cache.close()
    finally:
        get_shm_lib().ycnr_shm_unlink(shm_name.encode())
        get_cache_lib().ycnr_cache_unlink(cache_name.encode())
