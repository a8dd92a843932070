"""The port's fold-in (``serve/fold_in.py``) against
``ycnr_tpu.serve.fold_in`` in float64 on the same state, explicit and
implicit, at 1e-9: users, items, and top-n with the rated items masked."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ycnr_tpu.models import base as jbase
from ycnr_tpu.serve import fold_in as jfi
from ycnr_tpu_torch.models import base as tbase
from ycnr_tpu_torch.serve import fold_in as tfi
from ycnr_tpu_torch.data.synthetic import synthetic_ratings

torch.set_num_threads(1)

NU, NI, K = 60, 40, 6
TOL = dict(rtol=1e-9, atol=1e-9)


@pytest.fixture(scope="module")
def setup():
    u, i, r = synthetic_ratings(NU, NI, 1200, true_rank=3, seed=4)
    rng = np.random.default_rng(9)
    bi = np.zeros(NI + 1)
    bi[:NI] = rng.normal(0, 0.2, NI)
    js = jbase.init_state(NU, NI, K, seed=1, dtype=jnp.float64)
    # a biased state (SGD-style mu and item biases): the explicit solve
    # fits the residual r - (mu + b_i)
    js = js._replace(mu=jnp.asarray(3.0, jnp.float64),
                     bi=jnp.asarray(bi, jnp.float64))
    ts = tbase.state_from_numpy(*[np.asarray(x) for x in js],
                                dtype=torch.float64, device="cpu")
    return u, i, r, js, ts


def _lists(key, other, r, ids):
    return ([other[key == x] for x in ids], [r[key == x] for x in ids])


@pytest.mark.parametrize("alpha", [None, 8.0])
def test_fold_in_users_matches_jax(setup, alpha):
    u, i, r, js, ts = setup
    il, rl = _lists(u, i, r, [0, 3, 17, 42, 59])
    il.append(np.array([], np.int64))  # an empty list solves I x = 0
    rl.append(np.array([], np.float32))
    got = tfi.fold_in_users(ts, il, rl, lam=0.07, alpha=alpha)
    want = jfi.fold_in_users(js, il, rl, lam=0.07, alpha=alpha)
    assert got.dtype == np.float64 and got.shape == (6, K)
    np.testing.assert_allclose(got, want, **TOL)
    if alpha is None:
        assert np.all(got[-1] == 0)


@pytest.mark.parametrize("alpha", [None, 8.0])
def test_fold_in_items_matches_jax(setup, alpha):
    u, i, r, js, ts = setup
    ul, rl = _lists(i, u, r, [1, 4, 21, 39])
    got = tfi.fold_in_items(ts, ul, rl, lam=0.06, alpha=alpha)
    want = jfi.fold_in_items(js, ul, rl, lam=0.06, alpha=alpha)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("alpha", [None, 8.0])
def test_recommend_fold_in_matches_jax(setup, alpha):
    u, i, r, js, ts = setup
    il, rl = _lists(u, i, r, [2, 7, 29])
    ti, tsc = tfi.recommend_fold_in(ts, il, rl, n=7, lam=0.05, alpha=alpha)
    ji, jsc = jfi.recommend_fold_in(js, il, rl, n=7, lam=0.05, alpha=alpha)
    np.testing.assert_allclose(tsc, jsc, **TOL)
    np.testing.assert_array_equal(ti, ji)  # distinct f64 scores: no ties
    for row, rated in zip(ti, il):
        assert not set(row.tolist()) & set(rated.tolist())
        assert NI not in row  # the trash column is never served
    ti2, _ = tfi.recommend_fold_in(ts, il, rl, n=NI + 25)
    assert ti2.shape[1] == NI  # clamped to the catalog


def test_base_gram_cache_follows_in_place_updates(setup):
    """The implicit solve's cached V^T V is reused for the same tensor and
    recomputed once the tensor is written in place (the port's phases
    update factors in place)."""
    *_, ts = setup
    V = ts.V.clone()
    G1 = tfi._item_gram(V)
    assert tfi._item_gram(V) is G1
    V[0] += 1.0
    G2 = tfi._item_gram(V)
    assert G2 is not G1
    np.testing.assert_allclose(G2.numpy(), (V[:-1].T @ V[:-1]).numpy(),
                               rtol=0, atol=0)
