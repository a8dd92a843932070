"""The port's cross-process recommendation cache (``serve/cache.ShmRecCache``
over ``csrc/shm_cache.cc``): the cases of ``tests/test_shm_cache.py`` and
the ``sim`` namespace case of ``tests/test_similar.py`` through the port,
plus entries written by one package and read by the other. The JAX
package's library is compiled from its own source into a temporary
directory and handed to its loader (never ``ycnr_tpu.native``'s shared
build)."""

import ctypes
import json
import os
import subprocess
import sys
import threading
import time
import uuid

import numpy as np
import pytest
import torch

from ycnr_tpu import native as jnative
from ycnr_tpu.serve import cache as jcache
from ycnr_tpu_torch.native import get_cache_lib
from ycnr_tpu_torch.serve import cache as tcache
from ycnr_tpu_torch.serve.cache import ShmRecCache
from test_torch_shm import build_jax_library

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def jax_cache_path(tmp_path_factory):
    return build_jax_library(tmp_path_factory.mktemp("jaxcache"),
                             "shm_cache")


@pytest.fixture
def jax_cache(jax_cache_path, monkeypatch):
    monkeypatch.setitem(jnative._libs, "shm_cache",
                        ctypes.CDLL(jax_cache_path))
    return jnative.get_cache_lib()


@pytest.fixture
def cache_name():
    name = f"/ycnr_ttestc_{uuid.uuid4().hex[:12]}"
    yield name
    get_cache_lib().ycnr_cache_unlink(name.encode())


def test_roundtrip_and_epoch_invalidation(cache_name):
    with ShmRecCache(cache_name, 1 << 10, epoch=3) as c:
        assert c.get((7, 10)) is None
        c.put((7, 10), np.arange(10))
        np.testing.assert_array_equal(c.get((7, 10)), np.arange(10))
        assert c.get((7, 5)) is None  # same user, another n
        c.invalidate()  # a local epoch bump: everything misses
        assert c.get((7, 10)) is None
        c.put((7, 10), [1, 2])
        c.set_epoch(4)  # a republished factor epoch: a fresh key space
        assert c.get((7, 10)) is None


def test_per_user_tombstone_is_fleet_wide(cache_name):
    with ShmRecCache(cache_name, 1 << 10, epoch=2) as a, \
            ShmRecCache(cache_name, 1 << 10, epoch=2) as b:
        a.put((5, 10), [9, 8, 7])
        np.testing.assert_array_equal(b.get((5, 10)), [9, 8, 7])
        a.invalidate(5)  # after an online update for user 5
        assert a.get((5, 10)) is None
        assert b.get((5, 10)) is None


def test_popular_tombstone_is_fleet_wide(cache_name):
    with ShmRecCache(cache_name, 1 << 10, epoch=2) as a, \
            ShmRecCache(cache_name, 1 << 10, epoch=2) as b:
        a.put(("pop", 0, 10, "count"), [3, 1, 2])
        np.testing.assert_array_equal(b.get(("pop", 0, 10, "count")),
                                      [3, 1, 2])
        a.invalidate_popular()
        assert a.get(("pop", 0, 10, "count")) is None
        assert b.get(("pop", 0, 10, "count")) is None
        a.put((5, 10), [9])  # user entries survive the namespace flush
        a.invalidate_popular()
        np.testing.assert_array_equal(a.get((5, 10)), [9])


def test_wide_requests_bypass(cache_name):
    with ShmRecCache(cache_name, 1 << 10) as c:
        c.put((1, ShmRecCache.N_MAX + 10), np.arange(70))
        assert c.get((1, ShmRecCache.N_MAX + 10)) is None


def test_cross_process_sharing(cache_name):
    with ShmRecCache(cache_name, 1 << 10, epoch=5) as c:
        c.put((42, 10), [3, 1, 4, 1, 5])
        child = subprocess.run(
            [sys.executable, "-c", f"""
import json
from ycnr_tpu_torch.serve.cache import ShmRecCache
c = ShmRecCache({cache_name!r}, 1 << 10, epoch=5)
got = c.get((42, 10))
c.put((99, 10), [7, 7, 7])
print(json.dumps({{"got": None if got is None else got.tolist()}}))
c.close()
"""], capture_output=True, text=True, timeout=120, cwd=REPO,
            env=dict(os.environ, PYTHONPATH=REPO))
        assert child.returncode == 0, child.stderr[-2000:]
        out = json.loads(child.stdout.strip().splitlines()[-1])
        assert out["got"] == [3, 1, 4, 1, 5]
        np.testing.assert_array_equal(c.get((99, 10)), [7, 7, 7])


def test_engine_shares_computed_lists(cache_name):
    """Two engines (distinct processes in production) with one shared
    cache: the second serves the first's computed list without scoring."""
    from ycnr_tpu_torch.data.synthetic import synthetic_ratings
    from ycnr_tpu_torch.models.base import init_state
    from ycnr_tpu_torch.serve.engine import Recommender

    u, i, r = synthetic_ratings(40, 30, 500, true_rank=3, seed=1)
    state = init_state(40, 30, 4, seed=0, device="cpu")
    with ShmRecCache(cache_name, 1 << 10) as ca, \
            ShmRecCache(cache_name, 1 << 10) as cb:
        a = Recommender(state, u, i, cache=ca)
        b = Recommender(state, u, i, cache=cb)
        top = a.recommend(3, 10)
        hit = cb.get((3, 10))
        assert hit is not None
        np.testing.assert_array_equal(hit, top)
        np.testing.assert_array_equal(b.recommend(3, 10), top)
        assert cb.hits >= 2


def test_concurrent_hammer(cache_name):
    """Concurrent writers and readers on colliding keys: every get returns
    None or a complete value some writer stored (no torn reads)."""
    with ShmRecCache(cache_name, 1 << 4) as c:  # tiny: force collisions
        stop = threading.Event()
        bad = []

        def writer(uid):
            k = 0
            while not stop.is_set():
                c.put((uid, 10), np.full(10, uid * 1000 + (k % 7)))
                k += 1

        def reader():
            while not stop.is_set():
                for uid in range(6):
                    got = c.get((uid, 10))
                    if got is None:
                        continue
                    if not (len(got) == 10 and len(set(got.tolist())) == 1
                            and got[0] // 1000 == uid):
                        bad.append(got.tolist())

        threads = [threading.Thread(target=writer, args=(uid,))
                   for uid in range(6)] + [threading.Thread(target=reader)
                                           for _ in range(3)]
        for t in threads:
            t.start()
        time.sleep(1.5)
        stop.set()
        for t in threads:
            t.join(timeout=10)
            assert not t.is_alive()
        assert not bad, bad[:3]


def test_shm_cache_sim_namespace(cache_name):
    """("sim", item, n, metric) keys round-trip without colliding with
    (user, n) keys."""
    c = ShmRecCache(cache_name, capacity=1 << 10)
    try:
        c.put((7, 5), np.arange(5, dtype=np.int32))
        c.put(("sim", 7, 5, "cosine"), np.arange(10, 15, dtype=np.int32))
        c.put(("sim", 7, 5, "dot"), np.arange(20, 25, dtype=np.int32))
        np.testing.assert_array_equal(c.get((7, 5)), np.arange(5))
        np.testing.assert_array_equal(c.get(("sim", 7, 5, "cosine")),
                                      np.arange(10, 15))
        np.testing.assert_array_equal(c.get(("sim", 7, 5, "dot")),
                                      np.arange(20, 25))
        c.invalidate(7)  # per-user tombstones leave the sim namespace
        assert c.get((7, 5)) is None
        assert c.get(("sim", 7, 5, "cosine")) is not None
        # uncacheable widths report dropped, not stored
        assert c.put_if(("sim", 7, c.N_MAX + 1, "cosine"),
                        np.arange(c.N_MAX + 1, dtype=np.int32),
                        lambda: True) is False
        assert c.put((7, c.N_MAX + 1),
                     np.arange(c.N_MAX + 1, dtype=np.int32)) is False
    finally:
        c.close()


_KEYS = [(3, 10), (40, 5), ("sim", 7, 5, "cosine"), ("sim", 7, 5, "dot"),
         ("pop", 0, 10, "count")]


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_entries_read_across_the_packages(cache_name, jax_cache, writer):
    """An entry written by one package's ShmRecCache is read bit-equal by
    the other's, in every key namespace; a tombstone written by one makes
    the other miss; a later factor epoch misses in both."""
    W, R = ((tcache, jcache) if writer == "port" else (jcache, tcache))
    vals = {k: np.arange(j, j + 1 + 2 * j, dtype=np.int32)
            for j, k in enumerate(_KEYS)}
    with W.ShmRecCache(cache_name, 1 << 16, epoch=6) as w, \
            R.ShmRecCache(cache_name, 1 << 16, epoch=6) as r:
        for k, v in vals.items():
            assert w.put(k, v)
        for k, v in vals.items():
            got = r.get(k)
            assert got is not None and got.dtype == np.int32
            np.testing.assert_array_equal(got, v)
        assert r.stats()["entries"] == w.stats()["entries"] == len(vals)
        w.invalidate(3)
        w.invalidate_popular()
        assert r.get((3, 10)) is None
        assert r.get(("pop", 0, 10, "count")) is None
        np.testing.assert_array_equal(r.get((40, 5)), vals[(40, 5)])
        r.set_epoch(7)
        assert r.get((40, 5)) is None


@pytest.mark.parametrize("mutation", ["republish", "online_update"])
def test_put_if_is_atomic_with_an_epoch_change(cache_name, mutation):
    """A list whose version check passed just before a republish (or an
    online update of its user) lands in another thread is never served
    after it: put_if holds off the epoch change until the list is filed
    under the old epoch (or before the user's tombstones). The JAX
    package's put_if reads the epoch after the check and files the old
    list under the new epoch: one way for an epoch to go back on a
    connection."""
    with ShmRecCache(cache_name, 1 << 10, epoch=2) as c:
        change = threading.Thread(
            target=(c.set_epoch if mutation == "republish"
                    else c.invalidate), args=(3 if mutation == "republish"
                                              else 5,))

        def cond():  # the version check passes; the mutation starts now
            change.start()
            time.sleep(0.2)
            return True

        assert c.put_if((5, 10), [1, 2, 3], cond)
        change.join(timeout=10)
        assert not change.is_alive()
        assert c.get((5, 10)) is None
        if mutation == "republish":
            c.set_epoch(2)  # filed under the epoch it was computed in
            np.testing.assert_array_equal(c.get((5, 10)), [1, 2, 3])
