"""Port's bucketed ALS/iALS phases and epochs vs ycnr_tpu.models.
bucketed_phase, from the same start factors on a small synthetic set."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ycnr_tpu.data.split import train_test_split
from ycnr_tpu.data.synthetic import synthetic_ratings
from ycnr_tpu.models import base as jbase
from ycnr_tpu.models import bucketed_phase as jbp
from ycnr_tpu.ops.bucketed import build_bucketed
from ycnr_tpu.ops.layout import pad_coo
from ycnr_tpu_torch.models import base as tbase
from ycnr_tpu_torch.models import bucketed_phase as tbp

torch.set_num_threads(1)

NU, NI, NNZ, K = 300, 200, 6000, 8
LAM, ALPHA = 0.05, 2.0


@pytest.fixture(scope="module")
def problem():
    u, i, r = synthetic_ratings(NU, NI, NNZ, true_rank=4, noise=0.3, seed=3)
    (tu, ti, tr), (su, si, sr) = train_test_split(u, i, r, 0.1, 0)
    ul = build_bucketed(tu, ti, tr, NU, NI, 32, K, max_groups=3)
    il = build_bucketed(ti, tu, tr, NI, NU, 32, K, max_groups=3)
    pu, pi, pr, n = pad_coo(su, si, sr, NU, NI, 256)
    cold_u = np.setdiff1d(np.arange(NU), tu)
    cold_i = np.setdiff1d(np.arange(NI), ti)
    return dict(ul=ul, il=il, test=(pu, pi, pr, n), cold_u=cold_u,
                cold_i=cold_i)


def _states(jdt, tdt):
    return (jbase.init_state(NU, NI, K, seed=1, dtype=jdt),
            tbase.init_state(NU, NI, K, seed=1, dtype=tdt))


def _jtest(test, dt):
    pu, pi, pr, n = test
    return (jnp.asarray(pu), jnp.asarray(pi), jnp.asarray(pr, dt),
            jnp.asarray(n))


def _ttest(test, dt):
    pu, pi, pr, n = test
    return (torch.as_tensor(pu), torch.as_tensor(pi),
            torch.as_tensor(pr).to(dt), n)


@pytest.mark.parametrize("side", ["user", "item"])
@pytest.mark.parametrize("alpha", [None, ALPHA])
def test_phase_matches_f64(problem, alpha, side):
    js, ts = _states(jnp.float64, torch.float64)
    js = jbase.zero_cold_entities(js, *_active(problem))
    ts = tbase.zero_cold_entities(ts, *_active(problem))
    if side == "user":
        jE, jF, tE, tF, lay = js.U, js.V, ts.U, ts.V, problem["ul"]
        cold = problem["cold_u"]
    else:
        jE, jF, tE, tF, lay = js.V, js.U, ts.V, ts.U, problem["il"]
        cold = problem["cold_i"]
    base_j = jnp.einsum("nk,nm->km", jF, jF) if alpha else None
    base_t = tF.T @ tF if alpha else None
    Ej = jbp.phase_bucketed(jE, jF, jbp.device_bucketed(lay, jnp.float64),
                            LAM, alpha, base_j)
    Et = tbp.phase_bucketed(tE.clone(), tF, tbp.device_bucketed(
        lay, torch.float64), LAM, alpha, base_t)
    np.testing.assert_allclose(Et.numpy(), np.asarray(Ej), rtol=1e-9,
                               atol=1e-9)
    # the phase keeps the trash row and the cold rows exactly zero
    assert torch.all(Et[-1] == 0) and torch.all(Et[cold] == 0)


@pytest.mark.parametrize("algo", ["als", "ials"])
def test_epochs_match_f64(problem, algo):
    js, ts = _states(jnp.float64, torch.float64)
    js = jbase.zero_cold_entities(js, *_active(problem))
    ts = tbase.zero_cold_entities(ts, *_active(problem))
    jul = jbp.device_bucketed(problem["ul"], jnp.float64)
    jil = jbp.device_bucketed(problem["il"], jnp.float64)
    tul = tbp.device_bucketed(problem["ul"], torch.float64)
    til = tbp.device_bucketed(problem["il"], torch.float64)
    jt = _jtest(problem["test"], jnp.float64)
    tt = _ttest(problem["test"], torch.float64)
    if algo == "als":
        js2, (rj, _) = jbp.als_epochs_bucketed(js, jul, jil, LAM, 2, jt)
        ts2, (rt, _) = tbp.als_epochs_bucketed(ts, tul, til, LAM, 2, tt)
        one_j = jbp.als_epoch_fn(jul, jil, LAM)
        one_t = tbp.als_epoch_fn(tul, til, LAM)
    else:
        js2, (rj, _) = jbp.ials_epochs_bucketed(js, jul, jil, LAM, ALPHA, 2,
                                                jt)
        ts2, (rt, _) = tbp.ials_epochs_bucketed(ts, tul, til, LAM, ALPHA, 2,
                                                tt)
        one_j = jbp.ials_epoch_fn(jul, jil, LAM, ALPHA)
        one_t = tbp.ials_epoch_fn(tul, til, LAM, ALPHA)
    np.testing.assert_allclose(rt.numpy(), np.asarray(rj), rtol=0,
                               atol=1e-9)
    for a, b in zip(js2[:2], ts2[:2]):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-9,
                                   atol=1e-9)
    _assert_padding_zero(ts2, problem)
    # one more epoch through the epoch closures, from the JAX factors
    j3 = one_j(js2)
    t3 = one_t(tbase.state_from_numpy(*[np.asarray(x) for x in js2],
                                      dtype=torch.float64))
    for a, b in zip(j3[:2], t3[:2]):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-9,
                                   atol=1e-9)
    _assert_padding_zero(t3, problem)


def _assert_padding_zero(st, problem):
    """The trash rows and the cold (never-rated) rows are exactly zero."""
    assert torch.all(st.U[-1] == 0) and torch.all(st.V[-1] == 0)
    assert torch.all(st.U[problem["cold_u"]] == 0)
    assert torch.all(st.V[problem["cold_i"]] == 0)


def _active(problem):
    ul = problem["ul"]
    il = problem["il"]
    au = np.concatenate([g.entity_ids.reshape(-1) for g in ul])
    ai = np.concatenate([g.entity_ids.reshape(-1) for g in il])
    return au[au < NU], ai[ai < NI]


def test_bf16_gather_rmse_matches_jax(problem):
    js, ts = _states(jnp.float32, torch.float32)
    jul = jbp.device_bucketed(problem["ul"], jnp.float32)
    jil = jbp.device_bucketed(problem["il"], jnp.float32)
    tul = tbp.device_bucketed(problem["ul"], torch.float32)
    til = tbp.device_bucketed(problem["il"], torch.float32)
    _, (rj, _) = jbp.als_epochs_bucketed(
        js, jul, jil, LAM, 2, _jtest(problem["test"], jnp.float32),
        gather_bf16=True)
    _, (rt, _) = tbp.als_epochs_bucketed(
        ts, tul, til, LAM, 2, _ttest(problem["test"], torch.float32),
        gather_bf16=True)
    np.testing.assert_allclose(rt.numpy(), np.asarray(rj), rtol=0, atol=1e-3)
