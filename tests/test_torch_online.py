"""The port's in-process ``Recommender`` (online updates, compaction,
popularity, similarity, cold users) against ``ycnr_tpu.serve.engine`` on the
same float64 state and the same sequence of calls: served ids equal, the
re-solved factor rows within 1e-9, the host-side rating arrays equal array
for array."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ycnr_tpu.models import base as jbase
from ycnr_tpu.serve.engine import Recommender as JRecommender
from ycnr_tpu_torch.data.synthetic import synthetic_ratings
from ycnr_tpu_torch.models import base as tbase
from ycnr_tpu_torch.serve.engine import Recommender as TRecommender

torch.set_num_threads(1)

NU, NI, K = 60, 80, 5


def setup(compact_threshold=10**9, mu=3.1, seed=0, with_r=True):
    u, i, r = synthetic_ratings(NU, NI, 1500, true_rank=3, seed=seed + 2)
    rng = np.random.default_rng(seed)
    U = np.r_[rng.normal(0, 0.3, (NU, K)), np.zeros((1, K))]
    V = np.r_[rng.normal(0, 0.3, (NI, K)), np.zeros((1, K))]
    V[[11, 40]] = 0  # cold items
    keep = ~np.isin(i, [11, 40])
    u, i, r = u[keep], i[keep], r[keep]
    bu = np.r_[rng.normal(0, 0.1, NU), 0.0]
    bi = np.r_[rng.normal(0, 0.1, NI), 0.0]
    bi[[11, 40]] = 0
    js = jbase.MFState(*(jnp.asarray(x, jnp.float64)
                         for x in (U, V, bu, bi, mu)))
    ts = tbase.state_from_numpy(U, V, bu, bi, mu, device="cpu",
                                dtype=torch.float64)
    kw = dict(train_r=r, compact_threshold=compact_threshold) if with_r \
        else {}
    return JRecommender(js, u, i, **kw), TRecommender(ts, u, i, **kw), (u, i, r)


def same_ids(a, b):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def same_rows(jr, tr, users):
    np.testing.assert_allclose(tr.state.U.numpy()[users],
                               np.asarray(jr.state.U)[users], rtol=1e-9,
                               atol=1e-12)


def same_arrays(jr, tr):
    for name in ("train_u", "train_i", "train_r"):
        a, b = getattr(jr, name), getattr(tr, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.mark.parametrize("alpha", [None, 2.0])
def test_add_ratings_matches_jax(alpha):
    jr, tr, (u, i, r) = setup()
    U0 = tr.state.U.clone()
    top = tr.recommend(3, 5)
    same_ids(top, jr.recommend(3, 5))
    new = top[:2]
    for rec in (jr, tr):
        rec.add_ratings(3, new, [5.0, 4.5], lam=0.05, alpha=alpha)
        rec.add_ratings(9, [0, 1, 0], [1.0, 2.0, 5.0], alpha=alpha)
        rec.add_ratings(3, [int(new[0]), 70], [2.0, 3.0], alpha=alpha)
    assert tr.pending_count() == jr.pending_count() == 3 + 2
    same_rows(jr, tr, [3, 9])
    # the write is in place, and only the updated rows moved
    moved = (tr.state.U != U0).any(1).nonzero().flatten().tolist()
    assert moved == [3, 9]
    assert tr._version == 3
    # no newly rated item is served, before and after compaction
    for phase in ("pending", "compacted"):
        got = tr.recommend(3, 8)
        same_ids(got, jr.recommend(3, 8))
        assert not set(new.tolist() + [70]) & set(got.tolist())
        for a, b in zip(tr._user_items_ratings(9), jr._user_items_ratings(9)):
            np.testing.assert_array_equal(a, b)
        jr.compact()
        tr.compact()
    assert tr.pending_count() == 0
    same_arrays(jr, tr)


def test_add_ratings_row_is_the_float64_solve():
    """The re-solved row is the ridge solution over the user's whole list
    against the residual r - (mu + b_i): held to a NumPy solve, 1e-9."""
    _, tr, (u, i, r) = setup()
    lam = 0.05
    tr.add_ratings(5, [2, 77], [4.0, 1.0], lam=lam)
    items, ratings = tr._user_items_ratings(5)
    V = tr.state.V.numpy()[items]
    resid = ratings.astype(np.float64) - (float(tr.state.mu)
                                          + tr.state.bi.numpy()[items])
    A = V.T @ V + lam * len(items) * np.eye(K)
    want = np.linalg.solve(A, V.T @ resid)
    np.testing.assert_allclose(tr.state.U.numpy()[5], want, rtol=1e-9,
                               atol=1e-12)


def test_add_ratings_in_place_and_cache():
    """The row write is in place (the state's tensor is the same storage),
    the user's cached lists are dropped, ("pop", ...) and ("sim", ...)
    entries survive the per-user invalidation."""
    _, tr, _ = setup()
    ptr = tr.state.U.data_ptr()
    tr.recommend(3, 5)
    tr.recommend(4, 5)
    tr.popular(5)
    tr.similar(2, 5)
    assert len(tr.cache) == 4
    tr.add_ratings(3, [1], [5.0])
    assert tr.state.U.data_ptr() == ptr
    assert tr.cache.get((3, 5)) is None and tr.cache.get((4, 5)) is not None
    assert tr.cache.get(("pop", 0, 5, "count")) is not None
    assert tr.cache.get(("sim", 2, 5, "cosine")) is not None
    tr.compact()  # base counts changed: popularity is stale, similarity not
    assert tr.cache.get(("pop", 0, 5, "count")) is None
    assert tr.cache.get(("sim", 2, 5, "cosine")) is not None
    tr.update_state(tr.state)
    assert len(tr.cache) == 0


def test_automatic_compaction_matches_jax():
    jr, tr, _ = setup(compact_threshold=7)
    rng = np.random.default_rng(1)
    for uid in range(12):
        items = rng.choice(NI, 3, replace=False)
        vals = rng.uniform(1, 5, 3)
        jr.add_ratings(uid, items, vals)
        tr.add_ratings(uid, items, vals)
        assert tr.pending_count() == jr.pending_count() < 7
    same_arrays(jr, tr)
    same_rows(jr, tr, list(range(12)))
    for uid in (0, 5, 11, 30):
        same_ids(np.sort(tr._user_items(uid)), np.sort(jr._user_items(uid)))
    for a, b in zip(tr.recommend_batch([0, 5, 11, 30], 6),
                    jr.recommend_batch([0, 5, 11, 30], 6)):
        same_ids(a, b)


def test_default_compaction_threshold():
    _, tr, (u, _, _) = setup(compact_threshold=None)
    tr.add_ratings(0, [1, 2], [3.0, 4.0])
    assert tr.pending_count() == 2  # below max(4096, nnz / 100)
    tr._pending_n = 4096
    tr._maybe_compact()
    assert tr.pending_count() == 0 and len(tr.train_u) >= len(u)


def test_popular_matches_jax_and_follows_compaction():
    jr, tr, _ = setup()
    same_ids(tr.popular(10), jr.popular(10))
    assert tr.popular(10) is tr.popular(10)  # cached
    cold_item = 11
    assert cold_item not in tr.popular(NI).tolist()  # never rated
    for uid in range(NU):
        for rec in (jr, tr):
            rec.add_ratings(uid, [cold_item], [5.0])
    for rec in (jr, tr):
        rec.compact()
    same_ids(tr.popular(10), jr.popular(10))
    assert cold_item in tr.popular(3).tolist()  # now rated by every user


@pytest.mark.parametrize("metric", ["cosine", "dot"])
def test_similar_and_precompute_similar_match_jax(metric):
    jr, tr, _ = setup()
    for item in (0, 7, 79):
        same_ids(tr.similar(item, 6, metric), jr.similar(item, 6, metric))
    assert len(tr.similar(11, 6, metric)) == 0  # a cold query: nothing
    assert 11 not in tr.similar(0, NI, metric).tolist()
    assert len(tr.similar(0, NI, metric)) == NI - 1 - 2
    jr.cache.invalidate()
    tr.cache.invalidate()
    assert tr.precompute_similar(6, metric, chunk=32) == \
        jr.precompute_similar(6, metric, chunk=32) == NI - 2
    for item in range(NI):
        a = tr.cache.get(("sim", item, 6, metric))
        b = jr.cache.get(("sim", item, 6, metric))
        assert (a is None) == (b is None) == (item in (11, 40))
        if a is not None:
            same_ids(a, b)
    with pytest.raises(ValueError, match="metric"):
        tr.similar(0, 5, "l2")
    with pytest.raises(IndexError, match="item ids"):
        tr.similar(NI, 5)


@pytest.mark.parametrize("alpha", [None, 1.5])
def test_recommend_cold_matches_jax(alpha):
    jr, tr, _ = setup()
    items, vals = [3, 9, 50, 62], [5.0, 1.0, 4.0, 3.5]
    got = tr.recommend_cold(items, vals, n=7, alpha=alpha)
    same_ids(got, jr.recommend_cold(items, vals, n=7, alpha=alpha))
    assert len(got) == 7 and not set(items) & set(got.tolist())
    with pytest.raises(IndexError, match="item ids"):
        tr.recommend_cold([0, NI], [4.0, 3.0])


def test_guards():
    _, no_r, _ = setup(with_r=False)
    with pytest.raises(ValueError, match="train_r"):
        no_r.add_ratings(0, [3], [4.0])
    _, tr, _ = setup()
    with pytest.raises(IndexError, match="recommend_cold"):
        tr.add_ratings(NU, [3], [4.0])
    with pytest.raises(IndexError, match="item ids"):
        tr.add_ratings(0, [NI], [4.0])
    tr.compact()  # nothing pending: a no-op
    assert tr.pending_count() == 0
