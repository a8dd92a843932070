"""Concurrent line-protocol serving (counterpart of
``ycnr_tpu/serve/server.py``).

One ``ServingApp`` owns the recommender plus everything a request needs
(id maps, fold-in params, latency accounting). ``serve_tcp`` runs the app
behind a thread-per-connection TCP server: an idle or slow client does not
block the others, and every request is timed into a log-bucketed latency
histogram reported by ``stats``.

Protocol (one request per line, one JSON object per line back):

    42                  -> {"user": 42, "items": [...]}
    batch:42,17,99      -> {"users": [42, 17, 99], "items": [[...], ...]}
    cold:318:5.0,296:4  -> {"user": "cold", "items": [...]}
    predict:42:10,20    -> {"user": 42, "items": [...], "scores": [...]}
    exclude:42:10,20    -> {"user": 42, "items": [...]}  (items filtered)
    similar:318[:dot]   -> {"item": 318, "similar": [...]}
    popular             -> {"popular": [...]}
    stats               -> {"event": "stats", ..., "latency": {...}}

``batch:`` amortizes scoring and round trips: one line rides the bulk
scorer directly. Unknown ids fail the whole line (one error object), so
callers cannot misalign the response with their request list.

Concurrency. Mutations (the shm hot-reload, ``add_ratings``, state swaps)
are serialized by ``ServingApp.lock``; reads (scoring) run concurrently
without it, as in the JAX package. The JAX package swaps in a new state on
every mutation; the port's ``Recommender.add_ratings`` writes the user's
row ``U[user_id]`` in place (``serve/engine.py``), so a reader scoring that
user while the row is written is possible:

* on the card every thread launches on the one default CUDA stream, so the
  scoring kernels see the old row or the new one, never half of each;
* on the CPU a concurrent reader of that one user can read a half-written
  row and answer that one request from it. The answer is never cached for
  later requests: the reader's ``put_if`` finds the version that
  ``add_ratings`` bumps after the write and drops it, or, if it came
  first, the ``invalidate(user_id)`` that follows the bump removes it.

A hot reload (``ShmRecommender.refresh``) swaps in new tensors and writes
none in place. Batches are scored at their own size: the JAX package pads
them to powers of two to bound its compiles, which the port has none of.
"""

from __future__ import annotations

import json
import queue
import socketserver
import threading
import time

import numpy as np


class LatencyStats:
    """Log-bucketed latency histogram: ~4.4% resolution from 1 µs to ~71 min
    (512 buckets, 16 per octave = 32 octaves), constant memory, O(1)
    record. Percentiles are read from the bucket boundaries (upper edge)."""

    PER_OCT = 16
    N = 512
    BASE = 1e-6

    def __init__(self):
        self._counts = np.zeros(self.N, np.int64)
        self._lock = threading.Lock()
        self._total_s = 0.0
        self._max_s = 0.0

    def _bucket(self, dt: float) -> int:
        if dt <= self.BASE:
            return 0
        b = int(np.log2(dt / self.BASE) * self.PER_OCT)
        return min(max(b, 0), self.N - 1)

    def record(self, dt: float):
        with self._lock:
            self._counts[self._bucket(dt)] += 1
            self._total_s += dt
            self._max_s = max(self._max_s, dt)

    def _edge(self, b: int) -> float:
        return self.BASE * 2.0 ** ((b + 1) / self.PER_OCT)

    def snapshot(self) -> dict:
        with self._lock:
            counts = self._counts.copy()
            total_s, max_s = self._total_s, self._max_s
        n = int(counts.sum())
        if n == 0:
            return {"count": 0}
        cum = np.cumsum(counts)
        out = {"count": n, "mean_ms": round(1e3 * total_s / n, 3),
               "max_ms": round(1e3 * max_s, 3)}
        for p in (50, 90, 99):
            b = int(np.searchsorted(cum, np.ceil(n * p / 100)))
            out[f"p{p}_ms"] = round(1e3 * self._edge(b), 3)
        return out


class _Batcher:
    """Dynamic micro-batching for warm-user requests: requests queue up and
    a single worker drains everything pending (up to max_batch) into ONE
    recommend_batch call. Greedy draining adds no latency to a lone request
    (the worker never waits for a window); under load the batch size grows
    naturally, so scoring cost amortizes — one [B, n_items] matmul instead
    of B sequential [1, n_items] ones."""

    _STOP = object()

    def __init__(self, app: "ServingApp", max_batch: int = 64):
        self.app = app
        self.max_batch = max_batch
        self.q: queue.Queue = queue.Queue()
        self.batches = 0
        self.batched_reqs = 0
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def stop(self):
        """Drain and end the worker thread (apps are usually process-lived;
        tests and embedders that churn apps should call ServingApp.close)."""
        self.q.put(self._STOP)
        self._thread.join(timeout=10)

    def submit(self, dense_uid: int):
        done = threading.Event()
        cell = [None, None, done]  # result, error, signal
        self.q.put((dense_uid, cell))
        done.wait()
        if cell[1] is not None:
            raise cell[1]
        return cell[0]

    def _loop(self):
        while True:
            first = self.q.get()
            if first is self._STOP:
                return
            batch = [first]
            while len(batch) < self.max_batch:
                try:
                    item = self.q.get_nowait()
                except queue.Empty:
                    break
                if item is self._STOP:
                    self.q.put(item)  # re-deliver after this batch
                    break
                batch.append(item)
            self.batches += 1
            self.batched_reqs += len(batch)
            uids = [b[0] for b in batch]
            try:
                eng = self.app._engine()
                v0 = eng._version
                results = eng.recommend_batch(uids, self.app.n)
                for (uid, cell), res in zip(batch, results):
                    cell[0] = res
                    # atomic with the cache lock (see RecCache.put_if)
                    eng.cache.put_if((int(uid), int(self.app.n)), res,
                                     lambda: eng._version == v0)
                    cell[2].set()
            except Exception as e:  # noqa: BLE001 — delivered per-request
                for _, cell in batch:
                    cell[1] = e
                    cell[2].set()


class ServingApp:
    """The full request handler behind both the stdin loop and the TCP
    server. Mutations hold ``self.lock``; reads run without it (the
    module docstring says why that is safe with in-place row writes)."""

    def __init__(self, rec, maps=None, n: int = 10, fold_lam: float = 0.05,
                 fold_alpha=None, store_meta=None, source: str = "ckpt",
                 epoch=None, shm: bool = False, max_batch: int = 64):
        self.rec = rec
        self.maps = maps
        self.n = n
        self.fold_lam = fold_lam
        self.fold_alpha = fold_alpha
        self.store_meta = dict(store_meta or {})
        self.source = source
        self._epoch = epoch
        self.shm = shm
        self.lock = threading.RLock()
        self.latency = LatencyStats()
        self.started = time.time()
        # max_batch=0 disables micro-batching (requests score one by one)
        self.batcher = _Batcher(self, max_batch) if max_batch > 0 else None

    def close(self):
        """Stop the batching worker (for embedders that churn apps)."""
        if self.batcher is not None:
            self.batcher.stop()
            self.batcher = None

    # -- request handlers --------------------------------------------------

    def _stats(self) -> str:
        with self.lock:
            if self.shm:
                self.rec.refresh()
                epoch = self.rec.epoch
            else:
                epoch = self._epoch
        return json.dumps({
            "event": "stats", "epoch": epoch,
            "users": int(self.store_meta.get("n_users", -1)),
            "items": int(self.store_meta.get("n_items", -1)),
            "n": self.n, "source": self.source,
            "uptime_s": round(time.time() - self.started, 1),
            "batches": (None if self.batcher is None
                        else self.batcher.batches),
            "batched_requests": (None if self.batcher is None
                                 else self.batcher.batched_reqs),
            "latency": self.latency.snapshot()})

    def _engine(self):
        """Hot-reload (exclusive) then hand back the engine for lock-free
        reading."""
        if self.shm:
            with self.lock:
                self.rec.refresh()
            return self.rec.engine
        return self.rec

    def _lookup(self, map_col, ids, what: str):
        """Original dataset ids -> dense positions against one sorted
        id-map column; raises KeyError (-> JSON error response) listing
        the unknown ids. Shared by _cold/_similar/_predict/_batch/_user."""
        ids = np.asarray(ids)
        pos = np.searchsorted(map_col, ids)
        ok = (pos < len(map_col)) & (map_col[np.minimum(
            pos, len(map_col) - 1)] == ids)
        if not ok.all():
            raise KeyError(f"unknown {what} {ids[~ok].tolist()}")
        return pos

    def _cold(self, line: str) -> str:
        pairs = [p.split(":") for p in line[5:].split(",")]
        ii = np.asarray([int(a) for a, _ in pairs])
        rr = np.asarray([float(b) for _, b in pairs], np.float32)
        if self.maps is not None:
            ii = self._lookup(self.maps[1], ii, "items")
        # the engine path validates dense item ids (a raw negative id
        # would silently wrap in the gather) and drops masked tails
        items = self._engine().recommend_cold(ii, rr, n=self.n,
                                              lam=self.fold_lam,
                                              alpha=self.fold_alpha)
        return self._emit("cold", items)

    def _user_item_list(self, body: str, what: str):
        """Parse 'USER:ITEM[,ITEM...]' -> (uid, orig_items, dense_u,
        dense_i) with id maps applied — shared by predict: / exclude:."""
        head, _, rest = body.partition(":")
        uid = int(head)
        ii = np.asarray([int(x) for x in rest.split(",") if x.strip()],
                        np.int64)
        if len(ii) == 0:
            raise ValueError(f"{what}: empty item list")
        dense_u, dense_i = uid, ii
        if self.maps is not None:
            dense_u = int(self._lookup(self.maps[0], [uid], "user")[0])
            dense_i = self._lookup(self.maps[1], ii, "items")
        return uid, ii, dense_u, dense_i

    def _exclude(self, line: str) -> str:
        """exclude:USER:ITEM[,ITEM...] — top-n with the given catalog items
        filtered out (business rules: out-of-stock, region-blocked). Exact:
        the engine over-fetches past n + |exclude| then filters."""
        uid, _, dense_u, dense_i = self._user_item_list(line[8:],
                                                        "exclude")
        items = self._engine().recommend(dense_u, self.n,
                                         exclude=dense_i)
        return self._emit(uid, items)

    def _predict(self, line: str) -> str:
        """predict:USER:ITEM[,ITEM...] — predicted ratings for (user, item)
        pairs through the current serving state (engine.predict)."""
        uid, ii, dense_u, dense_i = self._user_item_list(line[8:],
                                                         "predict")
        scores = self._engine().predict(dense_u, dense_i)
        return json.dumps({"user": uid, "items": [int(x) for x in ii],
                           "scores": [round(float(s), 4) for s in scores]})

    def _similar(self, line: str) -> str:
        """similar:ITEM[:METRIC] — top-n most similar catalog items
        (engine.similar; metric cosine|dot, default cosine)."""
        parts = line[8:].split(":")
        iid = int(parts[0])
        metric = parts[1] if len(parts) > 1 else "cosine"
        dense = iid
        if self.maps is not None:
            dense = int(self._lookup(self.maps[1], [iid], "item")[0])
        items = self._engine().similar(dense, self.n, metric=metric)
        if self.maps is not None:
            items = self.maps[1][np.asarray(items)]
        return json.dumps({"item": iid,
                           "similar": [int(x) for x in items]})

    # bound per scoring call: [chunk, n_items] score rows stay ~a few
    # hundred MB at any catalog size instead of scaling with the batch
    BATCH_CHUNK = 1024

    def _batch(self, line: str) -> str:
        uids = [int(x) for x in line[6:].split(",") if x.strip()]
        if not uids:
            raise ValueError("empty batch request")
        dense = np.asarray(uids, np.int64)
        if self.maps is not None:
            dense = self._lookup(self.maps[0], dense, "users")
        eng = self._engine()
        eng._check_users(dense)
        v0 = eng._version
        out = [None] * len(uids)
        miss = []
        for k, d in enumerate(dense):
            hit = eng.cache.get((int(d), int(self.n)))
            if hit is not None:
                out[k] = hit
            else:
                miss.append(k)
        for lo in range(0, len(miss), self.BATCH_CHUNK):
            idxs = miss[lo:lo + self.BATCH_CHUNK]
            res = eng.recommend_batch([int(dense[k]) for k in idxs],
                                      self.n)
            for k, r in zip(idxs, res):
                out[k] = r
                eng.cache.put_if((int(dense[k]), int(self.n)), r,
                                 lambda: eng._version == v0)
        if self.maps is not None:
            out = [self.maps[1][np.asarray(r)] for r in out]
        return json.dumps({"users": uids,
                           "items": [[int(x) for x in r] for r in out]})

    def _user(self, line: str) -> str:
        uid = int(line)
        dense = uid
        if self.maps is not None:
            dense = int(self._lookup(self.maps[0], [uid], "user")[0])
        if self.batcher is not None:
            eng = self._engine()
            # validate BEFORE enqueueing: recommend_batch raises for the
            # whole batch, so one bad id must not fail co-batched requests
            eng._check_users(np.asarray([dense]))
            hit = eng.cache.get((int(dense), int(self.n)))
            items = hit if hit is not None else self.batcher.submit(dense)
        else:
            items = self._engine().recommend(dense, self.n)
        return self._emit(uid, items)

    def _emit(self, key, items) -> str:
        if self.maps is not None:
            items = self.maps[1][np.asarray(items)]
        return json.dumps({"user": key, "items": [int(x) for x in items]})

    def handle(self, line: str) -> str:
        t0 = time.perf_counter()
        try:
            if line == "stats":
                return self._stats()
            if line.startswith("cold:"):
                return self._cold(line)
            if line == "popular":
                items = self._engine().popular(self.n)
                if self.maps is not None:
                    items = self.maps[1][np.asarray(items)]
                return json.dumps({"popular":
                                   [int(x) for x in items]})
            if line.startswith("similar:"):
                return self._similar(line)
            if line.startswith("predict:"):
                return self._predict(line)
            if line.startswith("exclude:"):
                return self._exclude(line)
            if line.startswith("batch:"):
                return self._batch(line)
            return self._user(line)
        except (ValueError, KeyError, IndexError, RuntimeError) as e:
            # RuntimeError covers shm torn-read retry exhaustion during a
            # publish storm — one failed request must not kill the server
            return json.dumps({"error": str(e), "request": line})
        finally:
            self.latency.record(time.perf_counter() - t0)


class _ThreadingTCP(socketserver.ThreadingTCPServer):
    daemon_threads = True
    allow_reuse_address = True


def serve_tcp(app: ServingApp, host: str, port: int):
    """Build (not run) the thread-per-connection TCP server; callers print
    their ready line with `server.server_address` then `serve_forever()`."""

    class Handler(socketserver.StreamRequestHandler):
        def handle(self):
            for raw in self.rfile:
                line = raw.decode("utf-8", "replace").strip()
                if not line:
                    continue
                try:
                    self.wfile.write((app.handle(line) + "\n").encode())
                    self.wfile.flush()
                except (BrokenPipeError, ConnectionResetError):
                    return  # client went away mid-response

    return _ThreadingTCP((host or "127.0.0.1", int(port)), Handler)
