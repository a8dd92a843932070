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
    ts = tbase.init_state(37, 23, 6, seed=5, dtype=tdt,
                          device="cpu")
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
    ts = tbase.state_from_numpy(U, V, bu, bi, 0.7, dtype=torch.float64,
                                device="cpu")
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


def test_init_state_without_a_device_needs_cuda(monkeypatch):
    """device=None means the card; without one it raises and says how to
    run on the CPU instead."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tbase.init_state(5, 4, 3, seed=0)
    assert tbase.init_state(5, 4, 3, seed=0, device="cpu").U.device.type \
        == "cpu"


def test_state_from_numpy_without_a_device_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    z = np.zeros((3, 2))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tbase.state_from_numpy(z, z, z[:, 0], z[:, 0], 0.0)
    assert tbase.state_from_numpy(z, z, z[:, 0], z[:, 0], 0.0,
                                  device="cpu").V.device.type == "cpu"


@pytest.mark.parametrize("jdt,tdt", DTYPES)
def test_grow_state_bitwise(jdt, tdt):
    """Grown rows come from SeedSequence([seed, ou, oi, n_users, n_items])
    in both packages: every array of the grown state is bit-equal."""
    rng = np.random.default_rng(8)
    U = np.r_[rng.normal(size=(40, 6)), np.zeros((1, 6))]
    V = np.r_[rng.normal(size=(20, 6)), np.zeros((1, 6))]
    bu = np.r_[rng.normal(size=40), 0.0]
    bi = np.r_[rng.normal(size=20), 0.0]
    js = jbase.MFState(*(jnp.asarray(x, jdt) for x in (U, V, bu, bi, 3.25)))
    ts = tbase.state_from_numpy(U, V, bu, bi, 3.25, dtype=tdt, device="cpu")
    for nu, ni in ((55, 26), (40, 33), (41, 20)):
        jg = jbase.grow_state(js, nu, ni, seed=2)
        tg = tbase.grow_state(ts, nu, ni, seed=2)
        assert (tg.n_users, tg.n_items, tg.rank) == (nu, ni, 6)
        for a, b in zip(jg, tbase.to_numpy(tg)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(_np(a), b)
        # old rows carried (through float32, as the JAX package carries
        # them), new rows drawn, trash rows zero, mu kept
        assert torch.equal(tg.U[:40], ts.U[:40].float().to(tdt))
        assert torch.equal(tg.bi[:20], ts.bi[:20].float().to(tdt))
        assert bool((tg.U[40:nu] != 0).all()) and not bool(tg.U[nu].any())
        assert not bool(tg.V[ni].any()) and float(tg.mu) == 3.25
    other = tbase.grow_state(ts, 55, 26, seed=3)
    assert not torch.equal(other.U[40:55],
                           tbase.grow_state(ts, 55, 26, seed=2).U[40:55])


def test_grow_state_refuses_to_shrink_and_passes_a_noop():
    ts = tbase.init_state(10, 8, 4, device="cpu")
    with pytest.raises(ValueError, match="shrink"):
        tbase.grow_state(ts, 9, 8)
    with pytest.raises(ValueError, match="shrink"):
        tbase.grow_state(ts, 10, 7)
    assert tbase.grow_state(ts, 10, 8) is ts


def test_device_layouts_without_a_device_need_cuda(monkeypatch):
    """``device_layout`` and ``device_bucketed`` place a layout on the card
    unless the caller names the CPU, as the JAX package's place theirs on
    its default device; without a card the default raises."""
    from ycnr_tpu_torch.models.bucketed_phase import device_bucketed
    from ycnr_tpu_torch.ops.bucketed import build_bucketed
    from ycnr_tpu_torch.ops.layout import build_blocked_csr

    rng = np.random.default_rng(0)
    u, i = rng.integers(0, 30, 200), rng.integers(0, 20, 200)
    r = rng.uniform(1, 5, 200).astype(np.float32)
    lay = build_blocked_csr(u, i, r, 30, 20, 8, rank_hint=4)
    groups = build_bucketed(u, i, r, 30, 20, rank_hint=4)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tbase.device_layout(lay)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        device_bucketed(groups)
    assert tbase.device_layout(lay, device="cpu").rating.device.type == "cpu"
    assert device_bucketed(groups, device="cpu")[0].rating.device.type == "cpu"


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_scatter_add_accumulates_duplicates_in_order(dtype):
    """``table[idx] += delta`` with duplicates, as ``np.add.at``; on the
    CPU the terms are added in index order, so two runs are bit-equal."""
    rng = np.random.default_rng(1)
    idx = rng.integers(0, 7, 500)
    delta = rng.normal(size=(500, 3))
    want = np.zeros((8, 3))
    np.add.at(want, idx, delta)
    runs = [tbase.scatter_add_(torch.zeros(8, 3, dtype=dtype),
                               torch.as_tensor(idx),
                               torch.as_tensor(delta, dtype=dtype))
            for _ in range(2)]
    assert torch.equal(runs[0], runs[1])
    np.testing.assert_allclose(runs[0].numpy(), want,
                               atol=1e-12 if dtype == torch.float64 else 1e-5)
    assert not bool(runs[0][7].any())
    v = tbase.scatter_add_(torch.zeros(8, dtype=dtype), torch.as_tensor(idx),
                           torch.ones(500, dtype=dtype))
    np.testing.assert_array_equal(v.numpy(), np.bincount(idx, minlength=8))


def test_scatter_add_is_ordered_on_the_cpu_above_the_thread_grain():
    """Enough float32 terms that a CPU op may split them over threads:
    ``scatter_add_`` still adds each row's terms in index order, so repeats
    give the same bits (``index_put_(accumulate=True)`` does not, here)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(4)
    try:
        gen = torch.Generator().manual_seed(0)
        idx = torch.randint(0, 50, (400_000,), generator=gen)
        delta = torch.randn(400_000, 16, generator=gen)
        runs = [tbase.scatter_add_(torch.zeros(51, 16), idx, delta)
                for _ in range(4)]
    finally:
        torch.set_num_threads(threads)
    assert all(torch.equal(runs[0], r) for r in runs[1:])
    want = torch.zeros(51, 16, dtype=torch.float64)
    for row in range(50):  # float64 sums of each row's terms
        want[row] = delta[idx == row].double().sum(0)
    np.testing.assert_allclose(runs[0].numpy(), want.numpy(), atol=5e-3)
    assert not bool(runs[0][50].any())
