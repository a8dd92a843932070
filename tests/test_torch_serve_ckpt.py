"""Port's Recommender and npz checkpoints vs the JAX package's, on the
same state; checkpoints cross between the packages in both directions."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ycnr_tpu.models.base import MFState as JState
from ycnr_tpu.serve.engine import Recommender as JRecommender
from ycnr_tpu.train import checkpoint as jckpt
from ycnr_tpu_torch.models.base import state_from_numpy, to_numpy
from ycnr_tpu_torch.serve.engine import Recommender as TRecommender
from ycnr_tpu_torch.train import checkpoint as tckpt

torch.set_num_threads(1)

N_USERS, N_ITEMS, K = 120, 700, 8


def _setup(dtype=np.float64, seed=0):
    rng = np.random.default_rng(seed)
    u = rng.integers(0, N_USERS, 3000)
    i = rng.integers(0, N_ITEMS, 3000)
    pairs = np.unique(np.stack([u, i], 1), axis=0)
    u, i = pairs[:, 0].astype(np.int32), pairs[:, 1].astype(np.int32)
    U = rng.normal(size=(N_USERS + 1, K))
    V = rng.normal(size=(N_ITEMS + 1, K))
    U[-1] = V[-1] = 0
    arrs = [x.astype(dtype) for x in (U, V, np.zeros(N_USERS + 1),
                                      np.zeros(N_ITEMS + 1))] + [dtype(0.0)]
    js = JState(*[jnp.asarray(x) for x in arrs])
    ts = state_from_numpy(*arrs, dtype=torch.from_numpy(arrs[0]).dtype)
    return js, ts, u, i, arrs


def _true_scores(arrs, user, ids):
    """Exact f64 scores of ids for user from bf16-rounded factors (the
    fused scorer's inputs), rounded so equal-score ties compare equal."""
    U = torch.tensor(arrs[0]).bfloat16().double().numpy()
    V = torch.tensor(arrs[1]).bfloat16().double().numpy()
    return sorted(np.round(V[np.asarray(ids)] @ U[user], 6).tolist())


def test_recommend_and_batch_match_jax():
    js, ts, u, i, _ = _setup()
    jr, tr = JRecommender(js, u, i), TRecommender(ts, u, i)
    for user in (0, 7, 119):
        np.testing.assert_array_equal(tr.recommend(user, 10),
                                      jr.recommend(user, 10))
        # served again from the cache
        np.testing.assert_array_equal(tr.recommend(user, 10),
                                      jr.recommend(user, 10))
    np.testing.assert_array_equal(tr.recommend(3, 5, exclude=[1, 2, 3]),
                                  jr.recommend(3, 5, exclude=[1, 2, 3]))
    users = [5, 1, 5, 44]
    for a, b in zip(tr.recommend_batch(users, 10),
                    jr.recommend_batch(users, 10)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(tr.predict(7, [0, 3, 699]),
                               np.asarray(jr.predict(7, [0, 3, 699])),
                               rtol=0, atol=1e-12)
    with pytest.raises(IndexError):
        tr.recommend(N_USERS, 10)


@pytest.mark.parametrize("method", ["exact", "fused", "fused32"])
def test_precompute_all_matches_jax(method):
    js, ts, u, i, arrs = _setup(np.float32, seed=1)
    jr, tr = JRecommender(js, u, i), TRecommender(ts, u, i)
    assert tr.precompute_all(10, method=method) == \
        jr.precompute_all(10, method=method)
    rated = set(zip(u.tolist(), i.tolist()))
    for user in np.unique(u)[::7]:
        a = tr.cache.get((int(user), 10))
        b = jr.cache.get((int(user), 10))
        if method == "exact":
            np.testing.assert_array_equal(a, b)
        else:  # same scores, ties in any order
            assert _true_scores(arrs, user, a) == _true_scores(arrs, user, b)
        assert not any((int(user), int(x)) in rated for x in a)


def test_update_state_flushes_cache():
    js, ts, u, i, _ = _setup()
    tr = TRecommender(ts, u, i)
    tr.recommend(0, 10)
    assert len(tr.cache) == 1
    tr.update_state(ts)
    assert len(tr.cache) == 0


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_checkpoints_cross_both_ways_bitwise(tmp_path, dtype):
    js, ts, *_ = _setup(dtype)
    jckpt.save_checkpoint(str(tmp_path / "j"), js, 3, config={"a": 1},
                          extra={"rmse_history": [1.0, 0.5]})
    got, man = tckpt.load_checkpoint(str(tmp_path / "j"))
    assert man["epoch"] == 3 and man["format"] == 3
    for a, b in zip(js, to_numpy(got)):
        assert np.asarray(a).dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a), b)
    tckpt.save_checkpoint(str(tmp_path / "t"), ts, 4, config={"a": 1})
    tckpt.save_checkpoint(str(tmp_path / "t"), ts, 5, config={"a": 1})
    back, man = jckpt.load_checkpoint(str(tmp_path / "t"))
    assert man["epoch"] == 5 and man["dtype"] == np.dtype(dtype).name
    assert sorted(p.name for p in (tmp_path / "t").iterdir()) == [
        "manifest.json", "state-5.npz"]  # the superseded epoch is gone
    for a, b in zip(back, to_numpy(ts)):
        np.testing.assert_array_equal(np.asarray(a), b)
