"""The port's ``eval/similar.py`` against ``ycnr_tpu.eval.similar`` on the
same float64 item factors: ids equal, scores within 1e-12, for both
metrics, a cold query, cold items and an n past the catalog."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ycnr_tpu.eval import similar as jsim
from ycnr_tpu.models import base as jbase
from ycnr_tpu_torch.eval import similar as tsim
from ycnr_tpu_torch.eval.recommend import NEG_INF
from ycnr_tpu_torch.models import base as tbase

torch.set_num_threads(1)

NU, NI, K = 20, 90, 6
COLD = [4, 17, 88]


def states(seed=0):
    rng = np.random.default_rng(seed)
    U = np.r_[rng.normal(size=(NU, K)), np.zeros((1, K))]
    V = np.r_[rng.normal(size=(NI, K)), np.zeros((1, K))]
    V[COLD] = 0  # never-rated items: zero rows
    z = (np.zeros(NU + 1), rng.normal(size=NI + 1), 0.5)
    js = jbase.MFState(*(jnp.asarray(x, jnp.float64) for x in (U, V, *z)))
    ts = tbase.state_from_numpy(U, V, *z, device="cpu", dtype=torch.float64)
    return V, js, ts


@pytest.mark.parametrize("metric", ["cosine", "dot"])
def test_similar_items_match_jax(metric):
    V, js, ts = states()
    q = [0, 5, 89, 5, 33]
    ji, jsc = jsim.similar_items(js, q, 10, metric)
    ti, tsc = tsim.similar_items(ts, q, 10, metric)
    assert ti.dtype == np.int32 and ti.shape == (5, 10)
    np.testing.assert_array_equal(ti, np.asarray(ji))
    np.testing.assert_allclose(tsc, np.asarray(jsc), rtol=0, atol=1e-12)
    # neither self, a cold item nor the trash row is ever served
    for row, item in zip(ti, q):
        assert item not in row and not set(COLD + [NI]) & set(row.tolist())
    # and the scores are the float64 similarity computed on the host
    Vn = V / np.maximum(np.linalg.norm(V, axis=1), 1e-12)[:, None] \
        if metric == "cosine" else V
    np.testing.assert_allclose(tsc[0], (Vn[ti[0]] @ Vn[0]), rtol=1e-12,
                               atol=1e-12)
    assert np.all(np.diff(tsc, axis=1) <= 0)


def test_cold_query_masks_its_whole_row():
    _, js, ts = states(1)
    ji, jsc = jsim.similar_items(js, [COLD[0], 2], 5)
    ti, tsc = tsim.similar_items(ts, [COLD[0], 2], 5)
    assert np.all(tsc[0] < NEG_INF / 2) and np.all(tsc[1] > NEG_INF / 2)
    np.testing.assert_array_equal(tsc[0], np.asarray(jsc)[0])
    np.testing.assert_array_equal(ti[1], np.asarray(ji)[1])


def test_n_is_clamped_and_masked_tail_is_neg_inf():
    """n past the catalog clamps to n_items - 1 (self is always excluded);
    the cold items fill the tail at NEG_INF, as in the JAX package."""
    _, js, ts = states(2)
    ji, jsc = jsim.similar_items(js, [1], 500)
    ti, tsc = tsim.similar_items(ts, [1], 500)
    assert ti.shape == (1, NI - 1) == np.asarray(ji).shape
    live = tsc[0] > NEG_INF / 2
    assert int(live.sum()) == NI - 1 - len(COLD)
    np.testing.assert_array_equal(ti[0][live], np.asarray(ji)[0][live])
    np.testing.assert_allclose(tsc, np.asarray(jsc), rtol=0, atol=1e-12)


def test_bad_metric_raises():
    _, _, ts = states()
    with pytest.raises(ValueError, match="metric"):
        tsim.similar_items(ts, [0], 5, "euclid")
