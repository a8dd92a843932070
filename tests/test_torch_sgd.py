"""The port's biased SGD (``models/sgd.py``) against ``ycnr_tpu.models.sgd``
and the port's oracle copy: the same NumPy inputs and an explicit ``perm``
through both packages, float64 on the CPU, factors within 1e-9 relative
after 2 epochs; host-built data equal array for array; trash rows exactly
zero; same draws => bitwise same factors."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ycnr_tpu.models import base as jbase
from ycnr_tpu.models import sgd as jsgd
from ycnr_tpu_torch.data.synthetic import synthetic_ratings
from ycnr_tpu_torch.models import base as tbase
from ycnr_tpu_torch.models import sgd as tsgd
from ycnr_tpu_torch.oracle import numpy_mf as oracle

torch.set_num_threads(1)

NU, NI, K, B = 150, 90, 6, 256
TOL = dict(rtol=1e-9, atol=1e-12)


def states(seed=0, mu=3.4):
    rng = np.random.default_rng(seed)
    U = np.zeros((NU + 1, K))
    V = np.zeros((NI + 1, K))
    U[:NU] = rng.normal(0, 0.1, (NU, K))
    V[:NI] = rng.normal(0, 0.1, (NI, K))
    bu, bi = np.zeros(NU + 1), np.zeros(NI + 1)
    bu[:NU] = rng.normal(0, 0.05, NU)
    bi[:NI] = rng.normal(0, 0.05, NI)
    js = jbase.MFState(*(jnp.asarray(x, jnp.float64)
                         for x in (U, V, bu, bi, mu)))
    ts = tbase.state_from_numpy(U, V, bu, bi, mu, device="cpu",
                                dtype=torch.float64)
    return (U, V, bu, bi, mu), js, ts


@pytest.fixture(scope="module")
def coo():
    return synthetic_ratings(NU, NI, 1100, true_rank=3, seed=6)


def assert_trash_zero(ts):
    for x in (ts.U, ts.V, ts.bu, ts.bi):
        assert bool((x[-1] == 0).all())


def test_prepare_sgd_data_equals_jax(coo):
    u, i, r = coo
    jd = jsgd.prepare_sgd_data(u, i, r, B, NU, NI, jnp.float64)
    td = tsgd.prepare_sgd_data(u, i, r, B, NU, NI, torch.float64,
                               device="cpu")
    assert td.n_real == jd.n_real and td.u.shape[0] % B == 0
    for a, b in zip(jd[:3], td[:3]):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    assert td.r.dtype == torch.float64


@pytest.mark.parametrize("grad_mode", ["sum", "mean"])
def test_sgd_epoch_matches_jax(coo, grad_mode):
    u, i, r = coo
    _, js, ts = states()
    jd = jsgd.prepare_sgd_data(u, i, r, B, NU, NI, jnp.float64)
    td = tsgd.prepare_sgd_data(u, i, r, B, NU, NI, torch.float64,
                               device="cpu")
    rng = np.random.default_rng(1)
    for ep in range(2):
        perm = rng.permutation(td.u.shape[0])
        js = jsgd.sgd_epoch(js, jd, jnp.asarray(perm), 0.02, 0.01 * 0.9**ep,
                            B, grad_mode)
        ts = tsgd.sgd_epoch(ts, td, perm, 0.02, 0.01 * 0.9**ep, B,
                            grad_mode)
    for a, b in zip(js, tbase.to_numpy(ts)):
        np.testing.assert_allclose(b, np.asarray(a), **TOL)
    assert_trash_zero(ts)
    assert float(ts.mu) == 3.4


def test_sgd_epoch_matches_the_oracle_copy(coo):
    """"sum" mode is the oracle's semantics (padding masked out)."""
    u, i, r = coo
    (U, V, bu, bi, mu), _, ts = states(2)
    td = tsgd.prepare_sgd_data(u, i, r, B, NU, NI, torch.float64,
                               device="cpu")
    n_pad = td.u.shape[0]
    perm = np.random.default_rng(3).permutation(n_pad)
    ts = tsgd.sgd_epoch(ts, td, perm, 0.02, 0.01, B, "sum")
    # the oracle sees the padded COO: padding rows hit the trash rows with
    # rating 0, and the oracle has no mask, so rebuild them after
    pu, pi, pr = td.u.numpy(), td.i.numpy(), td.r.numpy()
    real = perm < len(r)  # keep the batch boundaries: slice per batch
    oU, oV, obu, obi = U.copy(), V.copy(), bu.copy(), bi.copy()
    for s in range(0, n_pad, B):
        sel = perm[s:s + B][real[s:s + B]]
        oU, oV, obu, obi = oracle.sgd_epoch_batched(
            oU, oV, obu, obi, mu, pu, pi, pr, 0.02, 0.01, len(sel) or 1,
            sel)
    for a, b in zip((oU, oV, obu, obi), tbase.to_numpy(ts)):
        np.testing.assert_allclose(b, a, rtol=1e-10, atol=1e-12)


def test_trainer_same_seed_bitwise_and_epochs_differ(coo):
    u, i, r = coo
    td = tsgd.prepare_sgd_data(u, i, r, B, NU, NI, device="cpu")
    tr = tsgd.BiasedSGD(lam=0.02, lr=0.02, batch_size=B, seed=9)

    def run(ep):
        st = tbase.init_state(NU, NI, K, seed=1, mu=3.0, device="cpu")
        return tr.epoch(st, td, ep)

    a, b, c = run(0), run(0), run(1)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert not torch.equal(a.U, c.U)
    assert_trash_zero(a)
    assert tr.lr_at(2) == pytest.approx(0.02 * 0.95**2)


def test_trainer_converges_like_the_jax_trainer():
    """Free-running draws differ between the packages (torch.Generator vs
    jax.random), so the trajectories agree within a band, as the JAX
    package's own convergence tests hold theirs."""
    from ycnr_tpu_torch.data.split import train_test_split
    from ycnr_tpu_torch.ops.layout import pad_coo

    nu, ni, k, b = 600, 200, 6, 1024
    u, i, r = synthetic_ratings(nu, ni, 30_000, true_rank=4, seed=11)
    (tu, ti, tr_), (su, si, sr) = train_test_split(u, i, r, 0.1, seed=11)
    mu = float(tr_.mean())
    pu, pi, pr, n = pad_coo(su, si, sr, nu, ni, 256)

    jst = jbase.init_state(nu, ni, k, seed=0, mu=mu)
    jd = jsgd.prepare_sgd_data(tu, ti, tr_, b, nu, ni)
    jt = jsgd.BiasedSGD(0.02, 0.03, 0.95, b, seed=0)
    tst = tbase.init_state(nu, ni, k, seed=0, mu=mu, device="cpu")
    td = tsgd.prepare_sgd_data(tu, ti, tr_, b, nu, ni, device="cpu")
    tt = tsgd.BiasedSGD(0.02, 0.03, 0.95, b, seed=0)
    start = float(tbase.rmse_padded(tst, pu, pi, pr, n))
    for ep in range(6):
        jst = jt.epoch(jst, jd, ep)
        tst = tt.epoch(tst, td, ep)
    rj = float(jbase.rmse_padded(jst, jnp.asarray(pu), jnp.asarray(pi),
                                 jnp.asarray(pr), n))
    rt = float(tbase.rmse_padded(tst, pu, pi, pr, n))
    assert rt < start - 0.05 and abs(rt - rj) < 0.02, (start, rt, rj)


def test_bad_grad_mode_raises(coo):
    u, i, r = coo
    _, _, ts = states()
    td = tsgd.prepare_sgd_data(u, i, r, B, NU, NI, torch.float64,
                               device="cpu")
    with pytest.raises(ValueError, match="grad_mode"):
        tsgd.sgd_epoch(ts, td, np.arange(td.u.shape[0]), 0.02, 0.01, B,
                       "emean")


def test_prepare_without_a_device_needs_cuda(coo, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tsgd.prepare_sgd_data(*coo, B, NU, NI)
