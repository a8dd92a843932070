"""The port's ``eval/ranking.py`` and ``eval/recommend.top_popular`` against
the JAX package's on the same float64 state and interactions: the metrics
are equal to the rounding the functions apply (6 places, novelty 4), the
hit rate to 1e-12."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ycnr_tpu.eval import ranking as jrank
from ycnr_tpu.eval import recommend as jrec
from ycnr_tpu.models import base as jbase
from ycnr_tpu_torch.data.synthetic import synthetic_ratings
from ycnr_tpu_torch.eval import ranking as trank
from ycnr_tpu_torch.eval import recommend as trec
from ycnr_tpu_torch.models import base as tbase

torch.set_num_threads(1)

NU, NI, K = 80, 60, 5


@pytest.fixture(scope="module")
def problem():
    u, i, _ = synthetic_ratings(NU, NI, 1600, true_rank=3, seed=3)
    rng = np.random.default_rng(0)
    held = rng.random(len(u)) < 0.2
    tu, ti = u[~held], i[~held]
    # duplicates among the held-out pairs collapse to one interaction
    su, si = np.r_[u[held], u[held][:7]], np.r_[i[held], i[held][:7]]
    # factors that know the held-out pairs a little: a nonzero hit rate
    U = np.r_[rng.normal(size=(NU, K)), np.zeros((1, K))]
    V = np.r_[rng.normal(size=(NI, K)), np.zeros((1, K))]
    for a, b in zip(su[::2], si[::2]):
        V[b] += 0.6 * U[a] / np.linalg.norm(U[a])
    z = (np.zeros(NU + 1), np.r_[rng.normal(0, 0.1, NI), 0.0], 0.0)
    js = jbase.MFState(*(jnp.asarray(x, jnp.float64) for x in (U, V, *z)))
    ts = tbase.state_from_numpy(U, V, *z, device="cpu", dtype=torch.float64)
    return js, ts, tu, ti, su, si


@pytest.mark.parametrize("n,max_users", [(10, 2048), (5, 30), (200, 2048)])
def test_ranking_metrics_equal_jax(problem, n, max_users):
    """All users, a sampled subset, and an n past the catalog (clamped)."""
    js, ts, tu, ti, su, si = problem
    want = jrank.ranking_metrics_at_n(js, tu, ti, su, si, n=n,
                                      max_users=max_users, seed=1)
    got = trank.ranking_metrics_at_n(ts, tu, ti, su, si, n=n,
                                     max_users=max_users, seed=1)
    assert got.keys() == want.keys()
    if n > NI - 20:
        # every user's list runs into the NEG_INF-masked tail (rated items
        # and the trash column, all tied): which of them fill it is the
        # top-k's tie order, which differs between the packages, and
        # novelty averages over them. Every other metric ignores the tail.
        got, want = dict(got, novelty=0.0), dict(want, novelty=0.0)
    assert got == want, (got, want)
    assert got["users"] == min(max_users, len(np.unique(su)))
    assert 0 < got["hit_rate"] <= 1 and got["n"] == min(n, NI)
    assert all(np.isfinite(v) for v in got.values())


@pytest.mark.parametrize("n,max_users", [(10, 2048), (3, 25)])
def test_hit_rate_equals_jax(problem, n, max_users):
    js, ts, tu, ti, su, si = problem
    want = jrank.hit_rate_at_n(js, tu, ti, su, si, n=n, max_users=max_users)
    got = trank.hit_rate_at_n(ts, tu, ti, su, si, n=n, max_users=max_users)
    assert abs(got - want) <= 1e-12 and got > 0
    if max_users == 2048:  # the suite's hit rate is the same definition
        full = trank.ranking_metrics_at_n(ts, tu, ti, su, si, n=n)
        assert full["hit_rate"] == round(got, 6)


def test_empty_test_set(problem):
    js, ts, tu, ti, _, _ = problem
    e = np.empty(0, np.int32)
    assert trank.hit_rate_at_n(ts, tu, ti, e, e) == 0.0
    assert trank.ranking_metrics_at_n(ts, tu, ti, e, e) == \
        jrank.ranking_metrics_at_n(js, tu, ti, e, e)


@pytest.mark.parametrize("n", [0, 3, 10, 500])
def test_top_popular_equals_jax(n):
    rng = np.random.default_rng(2)
    items = np.r_[rng.zipf(1.5, 900) % 50, [7, 7, 7]].astype(np.int32)
    want = np.asarray(jrec.top_popular(items, 64, n))
    got = trec.top_popular(items, 64, n)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    counts = np.bincount(items, minlength=64)
    assert np.all(counts[got] > 0) and np.all(np.diff(counts[got]) <= 0)


def test_recommend_users_probes_the_index_in_its_own_dtype(problem,
                                                           monkeypatch):
    """The sorted rating index is int32 and the user ids arrive as int64: a
    probe of another dtype would make NumPy convert the whole index on
    every user (tens of milliseconds each at 20M ratings). The lookup
    probes once, vectorized, in the index's dtype, and serves the same
    lists."""
    _, ts, tu, ti, su, _ = problem
    users = np.unique(su)[:40].astype(np.int64)
    want = trec.recommend_users(ts, None, None, users, 5, rated_lists=[
        ti[tu == u] for u in users])
    calls = []
    real = np.searchsorted

    def spy(a, v, *args, **kw):
        calls.append((a.dtype, np.asarray(v).dtype, np.ndim(v)))
        return real(a, v, *args, **kw)

    monkeypatch.setattr(trec.np, "searchsorted", spy)
    got = trec.recommend_users(ts, tu.astype(np.int32), ti, users, 5)
    assert len(calls) == 2  # not two per user
    assert all(a == v == np.int32 and nd == 1 for a, v, nd in calls)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("dtype", [np.int32, np.int64])
def test_rated_lists_of_the_sampled_users_equal_the_full_index(dtype):
    """The metrics sort only the sampled users' ratings: each list equals
    the slice of the whole user-sorted index, item order included, also for
    a user without ratings and for ids of another dtype than the index."""
    rng = np.random.default_rng(2)
    tu = rng.integers(0, 40, 600).astype(dtype)
    ti = rng.integers(0, 90, 600).astype(np.int32)
    tu[tu == 7] = 8  # user 7 has no rating
    users = np.array([39, 7, 0, 8, 21], np.int64)
    su, si = trec.sort_ratings_by_user(tu, ti)
    got = trank._rated_lists(tu, ti, users, 40)
    assert len(got) == len(users) and len(got[1]) == 0
    for u, lst in zip(users, got):
        np.testing.assert_array_equal(lst, si[su == u])


def test_sample_users_equals_jax():
    """The distinct (u, i) pairs and the sampled users, array for array
    and dtype for dtype, with duplicates in the held-out set."""
    rng = np.random.default_rng(8)
    su = rng.integers(0, 60, 900).astype(np.int32)
    si = rng.integers(0, 15, 900).astype(np.int32)
    for max_users in (20, 1000):
        for got, want in zip(trank._sample_users(su, si, max_users, 3),
                             jrank._sample_users(su, si, max_users, 3)):
            np.testing.assert_array_equal(got, want)
            assert got.dtype == want.dtype
