"""The port's BPR (``models/bpr.py``) against ``ycnr_tpu.models.bpr`` and the
port's oracle copy: the same NumPy inputs, an explicit ``perm`` and explicit
``negs`` through both packages, float64 on the CPU, factors within 1e-9
relative after 2 epochs in every ``grad_mode`` and both shuffle modes;
host-built data equal array for array; a collision on bit 31; a padded last
batch; trash rows exactly zero; ``bu`` and ``mu`` untouched."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ycnr_tpu.models import base as jbase
from ycnr_tpu.models import bpr as jbpr
from ycnr_tpu_torch.data.synthetic import synthetic_ratings
from ycnr_tpu_torch.models import base as tbase
from ycnr_tpu_torch.models import bpr as tbpr
from ycnr_tpu_torch.oracle import numpy_mf as oracle

torch.set_num_threads(1)

NU, NI, K, B = 70, 45, 5, 128
TOL = dict(rtol=1e-9, atol=1e-12)
GRAD_MODES = ["sum", "mean", "emean"]


def implicit(nu=NU, ni=NI, nnz=900, seed=0):
    u, i, _ = synthetic_ratings(nu, ni, nnz, true_rank=3, seed=seed)
    return u, i


def states(nu=NU, ni=NI, seed=0):
    rng = np.random.default_rng(seed)
    U = np.zeros((nu + 1, K))
    V = np.zeros((ni + 1, K))
    U[:nu] = rng.normal(0, 0.1, (nu, K))
    V[:ni] = rng.normal(0, 0.1, (ni, K))
    bu, bi = np.zeros(nu + 1), np.zeros(ni + 1)
    bu[:nu] = rng.normal(0, 0.05, nu)
    bi[:ni] = rng.normal(0, 0.05, ni)
    js = jbase.MFState(*(jnp.asarray(x, jnp.float64)
                         for x in (U, V, bu, bi, 0.3)))
    ts = tbase.state_from_numpy(U, V, bu, bi, 0.3, device="cpu",
                                dtype=torch.float64)
    return (U, V, bu, bi), js, ts


def draws(rng, u, n_pad, ni, n_perm):
    """A permutation and uniform negatives: with ~13 of 45 items rated per
    user, about a quarter of the negatives collide with a rated item."""
    perm = rng.permutation(n_perm)
    negs = rng.integers(0, ni, n_pad).astype(np.int32)
    return perm, negs


def assert_close(js, ts):
    for a, b in zip(js, tbase.to_numpy(ts)):
        np.testing.assert_allclose(b, np.asarray(a), **TOL)
    for x in (ts.U, ts.V, ts.bu, ts.bi):
        assert bool((x[-1] == 0).all())


@pytest.mark.parametrize("shuffle_rows_seed", [None, 0])
def test_prepare_bpr_data_equals_jax(shuffle_rows_seed):
    u, i = implicit()
    jd = jbpr.prepare_bpr_data(u, i, B, NU, NI, shuffle_rows_seed)
    td = tbpr.prepare_bpr_data(u, i, B, NU, NI, shuffle_rows_seed,
                               device="cpu")
    assert len(u) % B != 0 and td.u.shape[0] % B == 0  # a padded last batch
    assert td.n_real == jd.n_real == len(u)
    np.testing.assert_array_equal(np.asarray(jd.u), td.u.numpy())
    np.testing.assert_array_equal(np.asarray(jd.i), td.i.numpy())
    # the same words; the port holds them as int32
    assert td.bits.dtype == torch.int32
    np.testing.assert_array_equal(np.asarray(jd.bits),
                                  td.bits.numpy().view(np.uint32))
    for a, b in ((jd.wu, td.wu), (jd.wi, td.wi)):
        assert b.dtype == torch.float32
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_pack_rated_bits_and_weights_equal_jax_with_bit_31():
    rng = np.random.default_rng(4)
    u = np.r_[rng.integers(0, 20, 300), [3, 3, 7]].astype(np.int32)
    i = np.r_[rng.integers(0, 70, 300), [31, 63, 31]].astype(np.int32)
    tb = tbpr.pack_rated_bits(u, i, 20, 70)
    assert tb.dtype == np.uint32 and tb.shape == (21, 3)
    np.testing.assert_array_equal(jbpr.pack_rated_bits(u, i, 20, 70), tb)
    assert tb[3, 0] >> np.uint32(31) == 1 and tb[3, 1] >> np.uint32(31) == 1
    for a, b in zip(jbpr.expected_weights(u, i, 64, 20, 70),
                    tbpr.expected_weights(u, i, 64, 20, 70)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("grad_mode", GRAD_MODES)
def test_bpr_epoch_matches_jax(grad_mode):
    u, i = implicit()
    _, js, ts = states()
    jd = jbpr.prepare_bpr_data(u, i, B, NU, NI)
    td = tbpr.prepare_bpr_data(u, i, B, NU, NI, device="cpu")
    n_pad = td.u.shape[0]
    rng = np.random.default_rng(1)
    for ep in range(2):
        perm, negs = draws(rng, u, n_pad, NI, n_pad)
        js = jbpr.bpr_epoch(js, jd, jnp.asarray(perm), jnp.asarray(negs),
                            0.02, 0.05 * 0.9**ep, B, grad_mode)
        ts = tbpr.bpr_epoch(ts, td, perm, negs, 0.02, 0.05 * 0.9**ep, B,
                            grad_mode)
    assert_close(js, ts)


@pytest.mark.parametrize("grad_mode", GRAD_MODES)
def test_bpr_epoch_batches_matches_jax(grad_mode):
    u, i = implicit(seed=2)
    _, js, ts = states(seed=1)
    jd = jbpr.prepare_bpr_data(u, i, B, NU, NI, shuffle_rows_seed=0)
    td = tbpr.prepare_bpr_data(u, i, B, NU, NI, shuffle_rows_seed=0,
                               device="cpu")
    n_pad = td.u.shape[0]
    rng = np.random.default_rng(3)
    for ep in range(2):
        border, negs = draws(rng, u, n_pad, NI, n_pad // B)
        js = jbpr.bpr_epoch_batches(js, jd, jnp.asarray(border),
                                    jnp.asarray(negs), 0.02, 0.05 * 0.9**ep,
                                    B, grad_mode)
        ts = tbpr.bpr_epoch_batches(ts, td, border, negs, 0.02,
                                    0.05 * 0.9**ep, B, grad_mode)
    assert_close(js, ts)


@pytest.mark.parametrize("grad_mode", GRAD_MODES)
def test_bpr_epoch_matches_the_oracle_copy(grad_mode):
    """The oracle has no padding, so the set is cut to whole batches (as the
    JAX package's own parity test does); tolerance as there, 1e-12."""
    u, i = implicit()
    n = (len(u) // B) * B
    u, i = u[:n], i[:n]
    (U, V, bu, bi), _, ts = states(seed=2)
    td = tbpr.prepare_bpr_data(u, i, B, NU, NI, device="cpu")
    rng = np.random.default_rng(5)
    perm, negs = draws(rng, u, n, NI, n)
    out = tbpr.bpr_epoch(ts, td, perm, negs, 0.02, 0.05, B, grad_mode)
    oU, oV, obi = oracle.bpr_epoch_batched(
        U[:-1], V[:-1], bi[:-1], u[perm], i[perm], negs, 0.02, 0.05, B,
        grad_mode)
    np.testing.assert_allclose(out.U.numpy()[:-1], oU, atol=1e-12)
    np.testing.assert_allclose(out.V.numpy()[:-1], oV, atol=1e-12)
    np.testing.assert_allclose(out.bi.numpy()[:-1], obi, atol=1e-12)
    assert bool((out.U[-1] == 0).all()) and bool((out.V[-1] == 0).all())
    np.testing.assert_array_equal(out.bu.numpy(), bu)  # bu, mu untouched
    assert float(out.mu) == 0.3


def test_collision_on_bit_31_zero_weights_the_triple():
    """One user, positives 31 and 63 (bit 31 of words 0 and 1: the sign bit
    of the int32 words). A negative equal to either is a collision and
    leaves every table as it was; any other negative updates them. Same
    answer from the JAX package, which shifts uint32 words."""
    ni = 70
    u = np.zeros(2, np.int32)
    i = np.array([31, 63], np.int32)
    td = tbpr.prepare_bpr_data(u, i, 2, 1, ni, device="cpu")
    jd = jbpr.prepare_bpr_data(u, i, 2, 1, ni)
    assert int(td.bits[0, 0]) < 0 and int(td.bits[0, 1]) < 0  # sign bits
    perm = np.arange(2)

    def run(negs):
        rng = np.random.default_rng(0)
        U = np.r_[rng.normal(0, 0.1, (1, K)), np.zeros((1, K))]
        V = np.r_[rng.normal(0, 0.1, (ni, K)), np.zeros((1, K))]
        z = (np.zeros(2), np.zeros(ni + 1), 0.0)
        ts = tbase.state_from_numpy(U, V, *z, device="cpu",
                                    dtype=torch.float64)
        js = jbase.MFState(*(jnp.asarray(x, jnp.float64)
                             for x in (U, V, *z)))
        negs = np.asarray(negs, np.int32)
        out = tbpr.bpr_epoch(ts, td, perm, negs, 0.02, 0.1, 2, "sum")
        jout = jbpr.bpr_epoch(js, jd, jnp.asarray(perm), jnp.asarray(negs),
                              0.02, 0.1, 2, "sum")
        assert_close(jout, out)
        return U, V, out

    U, V, out = run([63, 31])  # both collide
    np.testing.assert_array_equal(out.U.numpy(), U)
    np.testing.assert_array_equal(out.V.numpy(), V)
    U, V, out = run([30, 62])  # neighbours of bit 31 do not
    assert not np.array_equal(out.U.numpy(), U)
    assert not np.array_equal(out.V.numpy()[30], V[30])


@pytest.mark.parametrize("shuffle", ["rows", "batches"])
def test_trainer_same_seed_bitwise_and_leaves_bu_mu(shuffle):
    u, i = implicit(seed=3)
    td = tbpr.prepare_bpr_data(
        u, i, B, NU, NI, device="cpu",
        shuffle_rows_seed=0 if shuffle == "batches" else None)
    tr = tbpr.BPRTrainer(lam=0.01, lr=0.1, batch_size=B, seed=5,
                         grad_mode="emean", shuffle=shuffle)

    def run(ep):
        st = tbase.init_state(NU, NI, K, seed=7, device="cpu")
        st = st._replace(bu=st.bu + 0.25, mu=st.mu + 1.5)
        return st, tr.epoch(st, td, ep)

    (s0, a), (_, b), (_, c) = run(0), run(0), run(1)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert not torch.equal(a.U, c.U)
    assert torch.equal(a.bu, s0.bu) and torch.equal(a.mu, s0.mu)
    assert a.bi.dtype == s0.bi.dtype and a.bi.is_contiguous()
    for x in (a.U, a.V, a.bi):
        assert bool((x[-1] == 0).all())
    assert tr.lr_at(3) == pytest.approx(0.1 * 0.98**3)


def test_trainer_guards():
    u, i = implicit(seed=3)
    td = tbpr.prepare_bpr_data(u, i, B, NU, NI, device="cpu")
    st = tbase.init_state(NU, NI, K, seed=7, device="cpu")
    n_pad = td.u.shape[0]
    with pytest.raises(ValueError, match="shuffle"):
        tbpr.BPRTrainer(shuffle="batch")
    with pytest.raises(ValueError, match="together"):
        tbpr.BPRTrainer(batch_size=B).epoch(st, td, 0,
                                            perm=np.arange(n_pad))
    with pytest.raises(ValueError, match="perm length"):
        tbpr.BPRTrainer(batch_size=B, shuffle="batches").epoch(
            st, td, 0, perm=np.arange(n_pad), negs=np.zeros(n_pad, np.int32))
    with pytest.raises(ValueError, match="grad_mode"):
        tbpr.BPRTrainer(batch_size=B, grad_mode="avg").epoch(st, td, 0)
    with pytest.raises(ValueError, match="grad_mode"):
        tbpr.fuse_bpr_state(st.U, st.V, st.bi, td.wu, td.wi, "avg")


def test_fuse_bpr_state_columns():
    u, i = implicit(seed=3)
    td = tbpr.prepare_bpr_data(u, i, B, NU, NI, device="cpu")
    st = tbase.init_state(NU, NI, K, seed=7, device="cpu")
    st = st._replace(bi=st.bi + 0.5)
    Uf, Vf = tbpr.fuse_bpr_state(st.U, st.V, st.bi, td.wu, td.wi, "emean")
    assert Uf.shape == (NU + 1, K + 2) and Vf.shape == (NI + 1, K + 2)
    assert torch.equal(Uf[:, K], torch.ones(NU + 1))
    assert torch.equal(Vf[:, K], st.bi) and torch.equal(Vf[:, K + 1], td.wi)
    assert torch.equal(Uf[:, K + 1], td.wu)
    Uf, Vf = tbpr.fuse_bpr_state(st.U, st.V, st.bi, td.wu, td.wi, "sum")
    assert Uf.shape == (NU + 1, K + 1) and Vf.shape == (NI + 1, K + 1)


def test_trainer_learns_to_rank():
    """Free-running draws (torch.Generator, not jax.random): observed pairs
    outscore unobserved ones after training, the band the JAX package's
    tests/test_bpr_parity.py holds its own trainer to."""
    nu, ni = 60, 40
    u, i = implicit(nu, ni, nnz=1200, seed=3)
    data = tbpr.prepare_bpr_data(u, i, 256, nu, ni, device="cpu")
    tr = tbpr.BPRTrainer(lam=0.01, lr=0.15, batch_size=256, seed=5)
    st = tbase.init_state(nu, ni, 8, seed=7, device="cpu")
    for e in range(30):
        st = tr.epoch(st, data, e)
    U, V, _, bi, _ = tbase.to_numpy(st)
    pos = np.einsum("nk,nk->n", U[u], V[i]) + bi[i]
    rated = set(zip(u.tolist(), i.tolist()))
    rng = np.random.default_rng(0)
    cand = [(int(a), int(b)) for a, b in zip(rng.integers(0, nu, 6000),
                                             rng.integers(0, ni, 6000))]
    cand = np.array([p for p in cand if p not in rated][:len(u)])
    neg = np.einsum("nk,nk->n", U[cand[:, 0]], V[cand[:, 1]]) + bi[cand[:, 1]]
    auc = float(np.mean(pos[:, None] > neg[None, :]))
    assert auc > 0.8, auc


def test_prepare_without_a_device_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tbpr.prepare_bpr_data(*implicit(), B, NU, NI)


def test_native_bit_packer_equals_the_numpy_path(monkeypatch):
    """``pack_rated_bits`` goes through the native loop of ``csrc/ingest.cc``
    (built here with g++); with the library absent it packs with NumPy. The
    same words either way, and ids out of range raise from both."""
    from ycnr_tpu_torch.data import native
    from ycnr_tpu_torch.native import get_ingest_lib

    assert get_ingest_lib() is not None
    rng = np.random.default_rng(6)
    u = np.r_[rng.integers(0, 300, 5000), [299, 0]]
    i = np.r_[rng.integers(0, 1000, 5000), [31, 999]]
    got = tbpr.pack_rated_bits(u, i, 300, 1000)
    with pytest.raises(IndexError):
        tbpr.pack_rated_bits(u, i, 298, 1000)
    monkeypatch.setattr(native, "pack_bits_native", lambda *a: None)
    want = tbpr.pack_rated_bits(u, i, 300, 1000)
    assert got.dtype == want.dtype == np.uint32
    np.testing.assert_array_equal(got, want)
    assert not got[300].any()  # the trash user's row stays empty
    with pytest.raises(IndexError):
        tbpr.pack_rated_bits(u, i, 298, 1000)
