"""The port's concurrent serving service (``serve/server.py``) on the CPU:
the cases of ``tests/test_serve_server.py`` through the port
(thread-per-connection TCP, micro-batching, the app lock, the latency
histogram), and ``ServingApp.handle`` of both packages giving the same JSON
for every request kind on one store and one float64 state."""

from __future__ import annotations

import json
import socket
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ycnr_tpu.models.base import MFState as JState
from ycnr_tpu.serve.engine import Recommender as JRecommender
from ycnr_tpu.serve.server import ServingApp as JServingApp
from ycnr_tpu_torch.data.synthetic import synthetic_ratings
from ycnr_tpu_torch.models.base import init_state, predict, state_from_numpy
from ycnr_tpu_torch.serve.engine import Recommender
from ycnr_tpu_torch.serve.server import LatencyStats, ServingApp, serve_tcp

torch.set_num_threads(1)


def _init(n_users, n_items, rank, seed):
    return init_state(n_users, n_items, rank, seed=seed, device="cpu")


@pytest.fixture(scope="module")
def app():
    n_users, n_items = 60, 40
    u, i, r = synthetic_ratings(n_users, n_items, 900, true_rank=3, seed=4)
    rec = Recommender(_init(n_users, n_items, 6, 0), u, i, train_r=r)
    a = ServingApp(rec, n=5, store_meta={"n_users": n_users,
                                         "n_items": n_items})
    yield a
    a.close()


def _serve(app):
    srv = serve_tcp(app, "127.0.0.1", 0)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv, srv.server_address[:2]


def _stop(srv):
    srv.shutdown()
    srv.server_close()


def test_latency_histogram_percentiles():
    h = LatencyStats()
    for ms in range(1, 101):  # 1..100 ms uniform
        h.record(ms / 1e3)
    s = h.snapshot()
    assert s["count"] == 100
    # log-bucket edges are within ~4% of the true percentile values
    assert 45 <= s["p50_ms"] <= 56
    assert 85 <= s["p90_ms"] <= 96
    assert 94 <= s["p99_ms"] <= 105
    assert s["max_ms"] >= 99.0
    assert LatencyStats().snapshot() == {"count": 0}


def test_handle_protocol(app):
    r = json.loads(app.handle("3"))
    assert r["user"] == 3 and len(r["items"]) == 5
    cold = json.loads(app.handle("cold:1:5.0,2:4.0"))
    assert cold["user"] == "cold" and 1 not in cold["items"] \
        and 2 not in cold["items"]
    assert "error" in json.loads(app.handle("nonsense"))
    stats = json.loads(app.handle("stats"))
    assert stats["event"] == "stats"
    assert stats["latency"]["count"] >= 3  # the requests above were timed
    assert "p99_ms" in stats["latency"]


def _client(addr, requests, out):
    with socket.create_connection(addr) as s:
        f = s.makefile("rw")
        for q in requests:
            f.write(q + "\n")
            f.flush()
            out.append((q, json.loads(f.readline())))


def test_concurrent_tcp_clients(app):
    srv, addr = _serve(app)
    try:
        expect = {u: json.loads(app.handle(str(u)))["items"]
                  for u in range(20)}
        # an idle client that never sends must not block the others
        idle = socket.create_connection(addr)
        threads, outs = [], []
        for c in range(8):
            reqs = [str((3 * c + j) % 20) for j in range(25)] + ["stats"]
            out = []
            outs.append(out)
            threads.append(threading.Thread(target=_client,
                                            args=(addr, reqs, out)))
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
            assert not th.is_alive(), "client starved: server not concurrent"
        idle.close()
        for out in outs:
            assert len(out) == 26
            for q, resp in out:
                if q == "stats":
                    assert resp["event"] == "stats"
                else:
                    assert resp["items"] == expect[int(q)], q
        stats = json.loads(app.handle("stats"))
        assert stats["latency"]["count"] >= 8 * 26
    finally:
        _stop(srv)


def test_micro_batching_forms_batches_and_matches_unbatched():
    """Under concurrent load the batcher coalesces requests, and batched
    answers equal the unbatched single-user path."""
    n_users, n_items = 50, 30
    u, i, r = synthetic_ratings(n_users, n_items, 600, true_rank=2, seed=7)
    state = _init(n_users, n_items, 4, 1)
    app_b = ServingApp(Recommender(state, u, i, train_r=r), n=4,
                       store_meta={"n_users": n_users, "n_items": n_items})
    app_plain = ServingApp(Recommender(state, u, i, train_r=r), n=4,
                           max_batch=0, store_meta={"n_users": n_users,
                                                    "n_items": n_items})
    assert app_plain.batcher is None
    expect = {q: json.loads(app_plain.handle(str(q)))["items"]
              for q in range(n_users)}
    srv, addr = _serve(app_b)
    try:
        outs = [[] for _ in range(12)]
        threads = [threading.Thread(
            target=_client,
            args=(addr, [str((7 * c + j) % n_users) for j in range(40)],
                  outs[c])) for c in range(12)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
            assert not th.is_alive()
        for out in outs:
            for q, resp in out:
                assert resp["items"] == expect[int(q)], q
        st = json.loads(app_b.handle("stats"))
        assert st["batched_requests"] >= st["batches"]
        assert st["batched_requests"] > 0
    finally:
        _stop(srv)
        app_b.close()


def test_bad_user_does_not_poison_batch(app):
    """An out-of-range id errors alone; co-batched requests still answer."""
    assert "error" in json.loads(app.handle("999999"))
    assert "items" in json.loads(app.handle("1"))


def test_concurrent_with_hot_updates(app):
    """Requests racing add_ratings (which writes U[5] in place) under the
    app lock: every response is whole and the server survives."""
    srv, addr = _serve(app)
    stop = threading.Event()

    def updater():
        k = 0
        while not stop.is_set():
            with app.lock:
                app.rec.add_ratings(5, [k % 40], [4.0])
            k += 1

    up = threading.Thread(target=updater)
    up.start()
    try:
        outs = []
        threads = [threading.Thread(target=_client,
                                    args=(addr, [str(u % 20)
                                                 for u in range(30)], outs))
                   for _ in range(4)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
            assert not th.is_alive()
        assert len(outs) == 4 * 30
        for _, resp in outs:
            assert "items" in resp
    finally:
        stop.set()
        up.join(timeout=10)
        _stop(srv)
    assert not up.is_alive()


def test_batch_request_matches_single(app):
    """batch: answers row for row equal to the single-user path, and a bad
    id (or an empty list) fails the whole line."""
    singles = [json.loads(app.handle(str(q)))["items"] for q in (1, 2, 3)]
    b = json.loads(app.handle("batch:1,2,3"))
    assert b["users"] == [1, 2, 3] and b["items"] == singles
    assert "error" in json.loads(app.handle("batch:1,999999"))
    assert "error" in json.loads(app.handle("batch:"))


def test_protocol_garbage_never_kills_the_app(app):
    """A malformed request line gives a JSON error object, never an
    uncaught exception."""
    garbage = [
        "notanumber", "-1", "9" * 40, "batch:", "batch:,,,",
        "batch:a,b", "cold:", "cold:1", "cold:1:", "cold:x:y",
        "cold:1:notafloat", "similar:", "similar:abc", "similar:1:bogus",
        "predict:", "predict:1", "predict:1:", "predict:x:1",
        "predict:1:x", "predict:1:1,2,", "stats:extra", "batch:1:2",
        "popular:5", "\x00\x01", "predict::", "similar:9999999999",
    ]
    for line in garbage:
        out = json.loads(app.handle(line))
        assert isinstance(out, dict), line
        if "error" not in out:
            assert "items" in out or "popular" in out or \
                out.get("event") == "stats", (line, out)


def test_exclude_request(app):
    base = json.loads(app.handle("3"))["items"]
    out = json.loads(app.handle(f"exclude:3:{base[0]},{base[2]}"))
    assert base[0] not in out["items"] and base[2] not in out["items"]
    assert len(out["items"]) == len(base)  # exact: over-fetch then filter
    far = json.loads(app.handle("exclude:3:39"))
    if 39 not in base:
        assert far["items"] == base
    assert "error" in json.loads(app.handle("exclude:3:"))
    assert "error" in json.loads(app.handle("exclude:3:9999"))


def test_predict_request(app):
    out = json.loads(app.handle("predict:3:1,2,7"))
    assert out["user"] == 3 and out["items"] == [1, 2, 7]
    want = predict(app.rec.state, torch.tensor([3, 3, 3]),
                   torch.tensor([1, 2, 7])).numpy()
    np.testing.assert_allclose(out["scores"], np.round(want, 4), atol=1e-4)
    assert "error" in json.loads(app.handle("predict:3:"))
    assert "error" in json.loads(app.handle("predict:9999:1"))
    assert "error" in json.loads(app.handle("predict:3:9999"))


def _mapped_app():
    n_users, n_items = 30, 20
    u, i, r = synthetic_ratings(n_users, n_items, 300, true_rank=2, seed=9)
    state = _init(n_users, n_items, 4, 2)
    uu = np.arange(n_users, dtype=np.int64) * 7 + 5
    ii = np.arange(n_items, dtype=np.int64) * 3 + 2
    app = ServingApp(Recommender(state, u, i, train_r=r), maps=(uu, ii),
                     n=4, store_meta={"n_users": n_users,
                                      "n_items": n_items})
    return app, state, uu, ii


def test_predict_request_id_maps():
    app, state, uu, ii = _mapped_app()
    try:
        out = json.loads(app.handle(f"predict:{uu[3]}:{ii[1]},{ii[7]}"))
        assert out["items"] == [int(ii[1]), int(ii[7])]
        want = predict(state, torch.tensor([3, 3]),
                       torch.tensor([1, 7])).numpy()
        np.testing.assert_allclose(out["scores"], np.round(want, 4),
                                   atol=1e-4)
        assert "error" in json.loads(app.handle("predict:3:1"))
    finally:
        app.close()


def test_batch_request_id_maps():
    """Raw-id round trip: users by dataset id, items back in dataset item
    ids, identical to the mapped single-user path."""
    app, _, uu, ii = _mapped_app()
    try:
        raw = [int(uu[3]), int(uu[11])]
        singles = [json.loads(app.handle(str(q)))["items"] for q in raw]
        b = json.loads(app.handle(f"batch:{raw[0]},{raw[1]}"))
        assert b["items"] == singles
        assert all(x in ii for row in b["items"] for x in row)
        assert "error" in json.loads(app.handle("batch:4"))  # not a raw id
    finally:
        app.close()


# --- the JAX package's ServingApp on the same store and state --------------

_REQUESTS = {
    "user": ["3", "17", "42"],
    "batch": ["batch:1,2,3,44,9", "batch:5"],
    "cold": ["cold:1:5.0,2:4.0,9:1.5", "cold:30:3.0"],
    "predict": ["predict:3:1,2,7", "predict:50:0,39"],
    "exclude": ["exclude:3:1,2", "exclude:8:0,5,6,7"],
    "similar": ["similar:4", "similar:11:dot", "similar:0:cosine"],
    "popular": ["popular"],
    "errors": ["batch:1,999", "cold:999:1.0", "predict:3:", "nonsense"],
}


@pytest.fixture(scope="module")
def both_apps():
    """One store and one float64 state (random factors and biases) behind
    each package's ServingApp, with and without id maps."""
    n_users, n_items, k = 60, 40, 6
    u, i, r = synthetic_ratings(n_users, n_items, 900, true_rank=3, seed=4)
    rng = np.random.default_rng(11)
    U = np.zeros((n_users + 1, k))
    V = np.zeros((n_items + 1, k))
    U[:-1] = rng.normal(0, 0.5, (n_users, k))
    V[:-1] = rng.normal(0, 0.5, (n_items, k))
    bu = np.r_[rng.normal(0, 0.2, n_users), 0.0]
    bi = np.r_[rng.normal(0, 0.2, n_items), 0.0]
    mu = 3.5
    maps = (np.arange(n_users, dtype=np.int64) * 7 + 5,
            np.arange(n_items, dtype=np.int64) * 3 + 2)
    apps = {}
    for mapped in (False, True):
        tstate = state_from_numpy(U, V, bu, bi, mu, device="cpu",
                                  dtype=torch.float64)
        jstate = JState(jnp.asarray(U), jnp.asarray(V), jnp.asarray(bu),
                        jnp.asarray(bi), jnp.asarray(mu))
        kw = dict(n=5, maps=maps if mapped else None,
                  store_meta={"n_users": n_users, "n_items": n_items})
        apps[mapped] = (ServingApp(Recommender(tstate, u, i, train_r=r),
                                   **kw),
                        JServingApp(JRecommender(jstate, u, i, train_r=r),
                                    **kw), maps)
    yield apps
    for t, j, _ in apps.values():
        t.close()
        j.close()


def _mapped(line: str, maps) -> str:
    """The same request in dataset ids (users and items through maps)."""
    uu, ii = maps
    kind, _, body = line.partition(":")
    if not body:
        return line if not line.isdigit() else str(uu[int(line)])
    if kind == "batch":
        return "batch:" + ",".join(str(uu[int(x)]) if int(x) < len(uu)
                                   else x for x in body.split(","))
    if kind == "cold":
        return "cold:" + ",".join(
            f"{ii[int(a)] if int(a) < len(ii) else a}:{b}"
            for a, b in (p.split(":") for p in body.split(",")))
    if kind in ("predict", "exclude"):
        user, _, items = body.partition(":")
        items = ",".join(str(ii[int(x)]) for x in items.split(",") if x)
        return f"{kind}:{uu[int(user)]}:{items}"
    if kind == "similar":
        item, _, metric = body.partition(":")
        return f"similar:{ii[int(item)]}" + (f":{metric}" if metric else "")
    return line


@pytest.mark.parametrize("mapped", [False, True], ids=["dense", "maps"])
@pytest.mark.parametrize("kind", sorted(_REQUESTS))
def test_handle_equals_the_jax_package(both_apps, kind, mapped):
    tapp, japp, maps = both_apps[mapped]
    for line in _REQUESTS[kind]:
        if mapped:
            line = _mapped(line, maps)
        got, want = json.loads(tapp.handle(line)), json.loads(
            japp.handle(line))
        if kind == "errors":
            assert "error" in got and "error" in want, line
            continue
        assert got == want, line
