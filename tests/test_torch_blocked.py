"""The port's blocked-layout path (``ops/gram.py``, ``models/als.py``,
``models/ials.py``, ``models/base.device_layout``) against
``ycnr_tpu.ops.gram`` and ``ycnr_tpu.models.als`` / ``ials`` in float64,
from the same start factors (carried by ``state_from_numpy``), factor by
factor at 1e-9."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ycnr_tpu.models import als as jals
from ycnr_tpu.models import base as jbase
from ycnr_tpu.models import ials as jials
from ycnr_tpu.ops import gram as jgram
from ycnr_tpu_torch.models import ALSWR, ImplicitALS, device_layout
from ycnr_tpu_torch.models import base as tbase
from ycnr_tpu_torch.ops import gram as tgram
from ycnr_tpu_torch.data.synthetic import synthetic_ratings
from ycnr_tpu_torch.ops.layout import build_blocked_csr

torch.set_num_threads(1)

NU, NI, NNZ, K = 120, 80, 3000, 6
LAM, ALPHA = 0.05, 2.0
TOL = dict(rtol=1e-9, atol=1e-9)


@pytest.fixture(scope="module")
def problem():
    u, i, r = synthetic_ratings(NU, NI, NNZ, true_rank=4, seed=2)
    keep = (u >= 10) & (i >= 5)  # users 0-9, items 0-4 stay cold
    u, i, r = u[keep], i[keep], r[keep]
    # small blocks: entities with several chunks, several blocks, padding
    ul = build_blocked_csr(u, i, r, NU, NI, 8, 24)
    il = build_blocked_csr(i, u, r, NI, NU, 8, 24)
    rng = np.random.default_rng(4)
    U0 = np.zeros((NU + 1, K))
    V0 = np.zeros((NI + 1, K))
    U0[:NU] = rng.normal(0, 0.1, (NU, K))
    V0[:NI] = rng.normal(0, 0.1, (NI, K))
    return dict(ul=ul, il=il, U0=U0, V0=V0)


def _states(p):
    z = (np.zeros(NU + 1), np.zeros(NI + 1), 0.0)
    js = jbase.MFState(*(jnp.asarray(x, jnp.float64)
                         for x in (p["U0"], p["V0"], *z)))
    ts = tbase.state_from_numpy(p["U0"], p["V0"], *z, dtype=torch.float64,
                                device="cpu")
    return js, ts


def _block(lay, b, dt_j, dt_t):
    jb = jgram.BlockData(*(x[b] for x in jbase.device_layout(lay, dt_j)))
    tb = tgram.BlockData(*(x[b] for x in device_layout(lay, dt_t, "cpu")))
    return jb, tb


def test_device_layout_matches_jax(problem):
    jl = jbase.device_layout(problem["ul"], jnp.float32)
    tl = device_layout(problem["ul"], torch.float32, "cpu")
    for a, b in zip(jl, tl):
        assert str(b.dtype).split(".")[-1] == str(a.dtype)
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


@pytest.mark.parametrize("weighted", [False, True])
def test_chunk_gram_rhs_and_segment_reduce_match(problem, weighted):
    jb, tb = _block(problem["il"], 0, jnp.float64, torch.float64)
    F = problem["U0"]
    jF = jnp.asarray(F)[jb.other_idx]
    tF = torch.as_tensor(F)[tb.other_idx]
    if weighted:
        jw, tw = ALPHA * jb.rating, ALPHA * tb.rating
        Gj, bj = jgram.chunk_gram_rhs(jF, jb.rating, weight=jw,
                                      rhs_weight=1.0 + jw)
        Gt, bt = tgram.chunk_gram_rhs(tF, tb.rating, weight=tw,
                                      rhs_weight=1.0 + tw)
    else:
        Gj, bj = jgram.chunk_gram_rhs(jF, jb.rating)
        Gt, bt = tgram.chunk_gram_rhs(tF, tb.rating)
    np.testing.assert_allclose(Gt.numpy(), np.asarray(Gj), **TOL)
    np.testing.assert_allclose(bt.numpy(), np.asarray(bj), **TOL)
    n_slots = tb.entity_ids.shape[0]
    Aj, rj = jgram.segment_reduce_block(Gj, bj, jb.chunk_seg, n_slots)
    At, rt = tgram.segment_reduce_block(Gt, bt, tb.chunk_seg, n_slots)
    assert At.shape == (n_slots, K, K)
    np.testing.assert_allclose(At.numpy(), np.asarray(Aj), **TOL)
    np.testing.assert_allclose(rt.numpy(), np.asarray(rj), **TOL)


def test_segment_reduce_block_sums_in_chunk_order():
    """Each slot's chunks are summed one after another; padding chunks
    (slot n_slots) are dropped; empty slots are exactly 0; runs repeat."""
    rng = np.random.default_rng(0)
    G = torch.as_tensor(rng.normal(size=(9, 2, 2)))
    b = torch.as_tensor(rng.normal(size=(9, 2)))
    seg = torch.tensor([0, 0, 0, 2, 3, 3, 4, 4, 4], dtype=torch.int32)
    A, r = tgram.segment_reduce_block(G, b, seg, 4)
    want = torch.stack([G[0] + G[1] + G[2], torch.zeros(2, 2), G[3],
                        G[4] + G[5]])
    assert torch.equal(A, want)
    assert torch.equal(r[1], torch.zeros(2))
    A2, r2 = tgram.segment_reduce_block(G, b, seg, 4)
    assert torch.equal(A, A2) and torch.equal(r, r2)


@pytest.mark.parametrize("alpha", [None, ALPHA])
@pytest.mark.parametrize("side", ["user", "item"])
def test_solve_block_matches(problem, side, alpha):
    lay, F = ((problem["ul"], problem["V0"]) if side == "user"
              else (problem["il"], problem["U0"]))
    jF, tF = jnp.asarray(F), torch.as_tensor(F)
    for b in range(lay.n_blocks):
        jb, tb = _block(lay, b, jnp.float64, torch.float64)
        if alpha is None:
            je, jr = jgram.solve_block(jF, jb, LAM)
            te, tr = tgram.solve_block(tF, tb, LAM)
        else:
            je, jr = jgram.solve_block(jF, jb, LAM, gram_weight_alpha=alpha,
                                       base_gram=jF.T @ jF, base_reg=LAM)
            te, tr = tgram.solve_block(tF, tb, LAM, gram_weight_alpha=alpha,
                                       base_gram=tF.T @ tF, base_reg=LAM)
        np.testing.assert_array_equal(te.numpy(), np.asarray(je))
        np.testing.assert_allclose(tr.numpy(), np.asarray(jr), **TOL)
        pad = te.numpy() == (NU if side == "user" else NI)
        assert torch.all(tr[torch.as_tensor(pad)] == 0)


def test_solve_block_bf16_gather_matches(problem):
    """gather_bf16 (the option the reference's dual-mesh path passes):
    rows gathered in bf16, sums in F's dtype, float32 on both sides; only
    the summation order differs."""
    F = problem["V0"]
    jF = jnp.asarray(F, jnp.float32)
    tF = torch.as_tensor(F, dtype=torch.float32)
    for b in range(problem["ul"].n_blocks):
        jb, tb = _block(problem["ul"], b, jnp.float32, torch.float32)
        _, jr = jgram.solve_block(jF, jb, LAM, gather_bf16=True)
        _, tr = tgram.solve_block(tF, tb, LAM, gather_bf16=True)
        np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=1e-4,
                                   atol=1e-5)


@pytest.mark.parametrize("algo", ["als", "ials"])
def test_epochs_match(problem, algo):
    js, ts = _states(problem)
    jul = jbase.device_layout(problem["ul"], jnp.float64)
    jil = jbase.device_layout(problem["il"], jnp.float64)
    tul = device_layout(problem["ul"], torch.float64, "cpu")
    til = device_layout(problem["il"], torch.float64, "cpu")
    if algo == "als":
        jm, tm = jals.ALSWR(LAM), ALSWR(LAM)
    else:
        jm, tm = jials.ImplicitALS(0.1, ALPHA), ImplicitALS(0.1, ALPHA)
    for _ in range(2):
        js = jm.epoch(js, jul, jil)
        ts = tm.epoch(ts, tul, til)
        np.testing.assert_allclose(ts.U.numpy(), np.asarray(js.U), **TOL)
        np.testing.assert_allclose(ts.V.numpy(), np.asarray(js.V), **TOL)
    # trash rows stay zero; cold entities (never in a layout) keep init
    assert torch.all(ts.U[-1] == 0) and torch.all(ts.V[-1] == 0)
    np.testing.assert_array_equal(ts.U[:10].numpy(), problem["U0"][:10])
    np.testing.assert_array_equal(ts.V[:5].numpy(), problem["V0"][:5])
