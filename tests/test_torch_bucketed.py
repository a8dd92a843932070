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
            tbase.init_state(NU, NI, K, seed=1, dtype=tdt, device="cpu"))


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
        lay, torch.float64, "cpu"), LAM, alpha, base_t)
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
    tul = tbp.device_bucketed(problem["ul"], torch.float64, "cpu")
    til = tbp.device_bucketed(problem["il"], torch.float64, "cpu")
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
                                      dtype=torch.float64, device="cpu"))
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
    tul = tbp.device_bucketed(problem["ul"], torch.float32, "cpu")
    til = tbp.device_bucketed(problem["il"], torch.float32, "cpu")
    _, (rj, _) = jbp.als_epochs_bucketed(
        js, jul, jil, LAM, 2, _jtest(problem["test"], jnp.float32),
        gather_bf16=True)
    _, (rt, _) = tbp.als_epochs_bucketed(
        ts, tul, til, LAM, 2, _ttest(problem["test"], torch.float32),
        gather_bf16=True)
    np.testing.assert_allclose(rt.numpy(), np.asarray(rj), rtol=0, atol=1e-3)


def test_bf16_rating_copy_is_the_jax_rounding(problem):
    """device_bucketed(rating_dtype=torch.bfloat16) rounds each rating to
    bf16 once, to the bits JAX's bf16 cast gives the same values; by
    default the ratings stay in the layout's dtype."""
    for lay in (problem["ul"], problem["il"]):
        for g, dg, df in zip(lay, tbp.device_bucketed(
                lay, torch.float32, "cpu", rating_dtype=torch.bfloat16),
                tbp.device_bucketed(lay, torch.float32, "cpu")):
            want = np.asarray(jnp.asarray(g.rating).astype(jnp.bfloat16))
            assert np.array_equal(dg.rating.view(torch.int16).numpy(),
                                  want.view(np.int16))
            assert dg.entity_cnt.dtype == torch.float32
            assert torch.equal(df.rating, torch.as_tensor(g.rating))


def test_phase_refuses_ratings_of_another_dtype(problem):
    """Off the fused branch the phase reads ratings in the factors' dtype,
    so a bf16-rating layout (the fused branch's) raises instead of
    training on rounded ratings."""
    _, ts = _states(jnp.float32, torch.float32)
    lay = tbp.device_bucketed(problem["ul"], torch.float32, "cpu",
                              rating_dtype=torch.bfloat16)
    for gather_bf16 in (False, True):
        with pytest.raises(ValueError, match="ratings"):
            tbp.phase_bucketed(ts.U.clone(), ts.V, lay, LAM,
                               gather_bf16=gather_bf16)


@pytest.mark.parametrize("device,dtype,alpha,bf16,want", [
    ("cuda", torch.float32, None, True, True),
    ("cuda:0", torch.float32, None, True, True),
    ("cpu", torch.float32, None, True, False),
    ("cuda", torch.float32, ALPHA, True, True),
    ("cuda", torch.float32, None, False, False),
    ("cuda", torch.float64, None, True, False),
])
def test_uses_fused_only_for_bf16_gathers_into_f32_on_cuda(device, dtype,
                                                           alpha, bf16,
                                                           want):
    """At rank 64 the fused branch runs for ALS-WR and iALS alike (the
    4-warp body's weighted mode), only with bf16 gathers into f32 factors
    on CUDA."""
    assert tbp.uses_fused(device, dtype, alpha, bf16, 64) is want


@pytest.mark.parametrize("width,want", [(1, True), (64, True), (128, True),
                                        (129, True), (192, True),
                                        (256, True), (257, False)])
def test_uses_fused_only_up_to_fused_gram_width(width, want):
    """The fused branch only where fused_gram takes the width (MAX_W, 256:
    the 4-warp body to 128, the wide body above); above it the phase
    takes the row gather -> einsum -> K1 route."""
    from ycnr_tpu_torch.ops.fused_gram import MAX_W

    assert MAX_W == 256
    assert tbp.uses_fused("cuda", torch.float32, None, True, width) is want


@pytest.mark.parametrize("gather_bf16", [False, True])
def test_rank_136_epoch_matches_jax(gather_bf16):
    """On the CPU the phase takes the row gather -> einsum -> guarded
    solve route, bf16 gathers or not (on CUDA, rank 136 with bf16 gathers
    into f32 takes fused_gram's wide body); a rank-136 ALS-WR epoch of it
    equals the JAX package's als_epochs_bucketed (f64 at 1e-9: with bf16
    gathers both round the gathered rows alike, then sum in f64)."""
    k = 136
    u, i, r = synthetic_ratings(NU, NI, NNZ, true_rank=4, noise=0.3, seed=5)
    (tu, ti, tr), (su, si, sr) = train_test_split(u, i, r, 0.1, 0)
    ul = build_bucketed(tu, ti, tr, NU, NI, 32, k, max_groups=3)
    il = build_bucketed(ti, tu, tr, NI, NU, 32, k, max_groups=3)
    test = pad_coo(su, si, sr, NU, NI, 256)
    jdt, tdt = jnp.float64, torch.float64
    js = jbase.init_state(NU, NI, k, seed=2, dtype=jdt)
    ts = tbase.init_state(NU, NI, k, seed=2, dtype=tdt, device="cpu")
    assert not tbp.uses_fused("cpu", tdt, None, gather_bf16, k)
    assert tbp.uses_fused("cuda", torch.float32, None, gather_bf16,
                          k) is gather_bf16
    js2, (rj, _) = jbp.als_epochs_bucketed(
        js, jbp.device_bucketed(ul, jdt), jbp.device_bucketed(il, jdt), LAM,
        1, _jtest(test, jdt), gather_bf16=gather_bf16)
    ts2, (rt, _) = tbp.als_epochs_bucketed(
        ts, tbp.device_bucketed(ul, tdt, "cpu"),
        tbp.device_bucketed(il, tdt, "cpu"), LAM, 1, _ttest(test, tdt),
        gather_bf16=gather_bf16)
    np.testing.assert_allclose(rt.numpy(), np.asarray(rj), rtol=0,
                               atol=1e-9)
    for a, b in zip(js2[:2], ts2[:2]):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-9,
                                   atol=1e-9)
    assert torch.all(ts2.U[-1] == 0) and torch.all(ts2.V[-1] == 0)


@pytest.mark.parametrize("alpha", [None, ALPHA], ids=["als_wr", "ials"])
def test_fused_branch_equals_bucket_solve_rows(problem, alpha):
    """The fused branch (fused gather -> Gram with the ridge, for iALS
    weighted with the phase's symmetric base Gram, then the solve), run on
    the CPU with the plain versions on the bf16-rating layout, gives bit
    for bit what bucket_solve_rows gives with bf16 gathers on the f32
    layout, block by block."""
    _, ts = _states(jnp.float32, torch.float32)
    for lay, F in ((problem["ul"], ts.V), (problem["il"], ts.U)):
        F_g = F.to(torch.bfloat16)
        G = None if alpha is None else tbp.fused_base(F.T @ F)
        for g, g16 in zip(tbp.device_bucketed(lay, torch.float32, "cpu"),
                          tbp.device_bucketed(lay, torch.float32, "cpu",
                                              rating_dtype=torch.bfloat16)):
            for j in range(g.other_idx.shape[0]):
                oi, rr, cnt = g.other_idx[j], g.rating[j], g.entity_cnt[j]
                got = tbp.bucket_fused_rows(F_g, oi, g16.rating[j], cnt,
                                            LAM, alpha, G)
                want = tbp.bucket_solve_rows(F_g, oi, rr, cnt, LAM, alpha,
                                             G, torch.float32, True)
                assert got.dtype == torch.float32
                assert torch.equal(got, want)


def test_fused_base_is_symmetric_and_keeps_a_symmetric_gram():
    G = torch.randn(8, 8, dtype=torch.float32)
    S = tbp.fused_base(G)
    assert torch.equal(S, S.T)
    assert torch.equal(tbp.fused_base(S), S)
    assert tbp.fused_base(None) is None

