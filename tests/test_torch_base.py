"""Port's factor state vs ycnr_tpu.models.base, on the same NumPy inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ycnr_tpu.models import base as jbase
from ycnr_tpu.ops.layout import pad_coo
from ycnr_tpu_torch.models import base as tbase

torch.set_num_threads(1)

DTYPES = [(jnp.float64, torch.float64), (jnp.float32, torch.float32)]


def _np(x):
    return np.asarray(x)


@pytest.mark.parametrize("jdt,tdt", DTYPES)
def test_init_state_bitwise(jdt, tdt):
    js = jbase.init_state(37, 23, 6, seed=5, dtype=jdt)
    ts = tbase.init_state(37, 23, 6, seed=5, dtype=tdt)
    for a, b in zip(js, tbase.to_numpy(ts)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(_np(a), b)
    assert ts.n_users == 37 and ts.n_items == 23 and ts.rank == 6


def _state_pair(seed=0):
    """A JAX state with nonzero biases and mu, and the port's copy."""
    rng = np.random.default_rng(seed)
    U = rng.normal(size=(41, 5))
    V = rng.normal(size=(29, 5))
    bu, bi = rng.normal(size=41), rng.normal(size=29)
    U[-1] = V[-1] = 0
    bu[-1] = bi[-1] = 0
    js = jbase.MFState(jnp.asarray(U), jnp.asarray(V), jnp.asarray(bu),
                       jnp.asarray(bi), jnp.asarray(0.7))
    ts = tbase.state_from_numpy(U, V, bu, bi, 0.7, dtype=torch.float64)
    return js, ts


def test_state_from_numpy_round_trip_bitwise():
    js, ts = _state_pair()
    for a, b in zip(js, tbase.to_numpy(ts)):
        np.testing.assert_array_equal(_np(a), b)
    for a, b in zip(jbase.unpad(js), tbase.unpad(ts)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_zero_cold_entities_matches():
    js, ts = _state_pair(1)
    tu = np.array([0, 3, 3, 7, 39], np.int32)
    ti = np.array([1, 1, 2, 27, 5], np.int32)
    jz = jbase.zero_cold_entities(js, tu, ti)
    tz = tbase.zero_cold_entities(ts, tu, ti)
    for a, b in zip(jz, tbase.to_numpy(tz)):
        np.testing.assert_array_equal(_np(a), b)


def test_predict_matches():
    js, ts = _state_pair(2)
    rng = np.random.default_rng(3)
    u = rng.integers(0, 41, 200)
    i = rng.integers(0, 29, 200)
    pj = _np(jbase.predict(js, jnp.asarray(u), jnp.asarray(i)))
    pt = tbase.predict(ts, torch.as_tensor(u), torch.as_tensor(i)).numpy()
    np.testing.assert_allclose(pt, pj, rtol=0, atol=1e-12)


@pytest.mark.parametrize("chunk", [None, 64])
def test_rmse_padded_matches(monkeypatch, chunk):
    """Unchunked and chunked (many chunks, ragged last one) branches."""
    if chunk is not None:
        monkeypatch.setattr(jbase, "_RMSE_CHUNK", chunk)
        monkeypatch.setattr(tbase, "_RMSE_CHUNK", chunk)
    js, ts = _state_pair(4)
    rng = np.random.default_rng(5)
    u = rng.integers(0, 40, 300)
    i = rng.integers(0, 28, 300)
    r = rng.normal(3, 1, 300)
    pu, pi, pr, n = pad_coo(u, i, r, 40, 28, 128)
    pr = pr.astype(np.float64)
    rj = float(jbase.rmse_padded(js, jnp.asarray(pu), jnp.asarray(pi),
                                 jnp.asarray(pr), n))
    rt = float(tbase.rmse_padded(ts, pu, pi, pr, n))
    assert abs(rj - rt) <= 1e-12
    assert rt > 0
