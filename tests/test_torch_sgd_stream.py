"""The port's stream-SGD (``models/sgd_stream.py``) against
``ycnr_tpu.models.sgd_stream``: the host-built stream equal array for
array (``order`` too), and ``sgd_stream_epoch`` with an explicit batch
order within 1e-9 relative after 2 epochs in float64, for "sum", "mean" and
"capped", one pass and several, and a tile clamped at the table's end; also
against the port's batched ``sgd_epoch`` replaying the stream order, and
through that the oracle's semantics."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ycnr_tpu.models import base as jbase
from ycnr_tpu.models import sgd_stream as jss
from ycnr_tpu_torch.data.synthetic import synthetic_ratings
from ycnr_tpu_torch.models import base as tbase
from ycnr_tpu_torch.models import sgd as tsgd
from ycnr_tpu_torch.models import sgd_stream as tss

torch.set_num_threads(1)

NU, NI, K, B = 120, 50, 5, 64
TOL = dict(rtol=1e-9, atol=1e-12)


def states(nu=NU, ni=NI, seed=0, mu=3.2):
    rng = np.random.default_rng(seed)
    U = np.zeros((nu + 1, K))
    V = np.zeros((ni + 1, K))
    U[:nu] = rng.normal(0, 0.1, (nu, K))
    V[:ni] = rng.normal(0, 0.1, (ni, K))
    bu, bi = np.zeros(nu + 1), np.zeros(ni + 1)
    bu[:nu] = rng.normal(0, 0.05, nu)
    bi[:ni] = rng.normal(0, 0.05, ni)
    js = jbase.MFState(*(jnp.asarray(x, jnp.float64)
                         for x in (U, V, bu, bi, mu)))
    ts = tbase.state_from_numpy(U, V, bu, bi, mu, device="cpu",
                                dtype=torch.float64)
    return js, ts


def prepare_both(u, i, r, nu, ni, **kw):
    jd, jo = jss.prepare_stream_sgd(u, i, r, B, nu, ni, dtype=jnp.float64,
                                    **kw)
    td, to = tss.prepare_stream_sgd(u, i, r, B, nu, ni, dtype=torch.float64,
                                    device="cpu", **kw)
    return jd, jo, td, to


def assert_same_stream(jd, jo, td, to):
    np.testing.assert_array_equal(jo, to)
    assert jo.dtype == to.dtype
    for name in ("ul", "ib", "rb", "wu", "wi"):
        a, b = np.asarray(getattr(jd, name)), getattr(td, name).numpy()
        np.testing.assert_array_equal(a, b, err_msg=name)
    np.testing.assert_array_equal(np.asarray(jd.u_lo), td.u_lo)
    assert isinstance(td.u_lo, np.ndarray)  # tile starts stay on the host
    assert (jd.n_real, jd.tile, jd.grad_mode) == (td.n_real, td.tile,
                                                  td.grad_mode)


def two_epochs(js, ts, jd, td, seed):
    rng = np.random.default_rng(seed)
    nb = td.ul.shape[0]
    for ep in range(2):
        order = rng.permutation(nb)
        js = jss.sgd_stream_epoch(js, jd.ul, jd.ib, jd.rb, jd.wu, jd.wi,
                                  jd.u_lo, jnp.asarray(order), 0.02,
                                  0.01 * 0.9**ep, jd.tile)
        ts = tss.sgd_stream_epoch(ts, td.ul, td.ib, td.rb, td.wu, td.wi,
                                  td.u_lo, order, 0.02, 0.01 * 0.9**ep,
                                  td.tile)
    return js, ts


def assert_states_close(js, ts):
    for a, b in zip(js, tbase.to_numpy(ts)):
        np.testing.assert_allclose(b, np.asarray(a), **TOL)
    for x in (ts.U, ts.V, ts.bu, ts.bi):
        assert bool((x[-1] == 0).all())


@pytest.mark.parametrize("grad_mode,passes", [
    ("sum", 1), ("mean", 1), ("capped", 1), ("sum", 4), ("mean", None),
    ("capped", None)])
def test_stream_and_epoch_match_jax(grad_mode, passes):
    u, i, r = synthetic_ratings(NU, NI, 1300, true_rank=3, seed=2)
    jd, jo, td, to = prepare_both(u, i, r, NU, NI, seed=5,
                                  grad_mode=grad_mode, passes=passes, cap=3)
    assert_same_stream(jd, jo, td, to)
    assert td.ul.shape[0] > 4
    js, ts = states()
    js, ts = two_epochs(js, ts, jd, td, seed=1)
    assert_states_close(js, ts)
    assert float(ts.mu) == 3.2


def test_tile_clamped_at_the_tables_end():
    """The last users are rated once each over a wide id range, so the
    last batches' tiles would run past row n_users: u_lo is clamped to
    n_users + 1 - tile and the local rows shift."""
    nu, ni = 900, 30
    rng = np.random.default_rng(0)
    u = np.concatenate([rng.choice(nu, 400, replace=False),
                        np.full(40, nu - 1)])
    i = rng.integers(0, ni, len(u))
    r = rng.uniform(1, 5, len(u)).astype(np.float32)
    jd, jo, td, to = prepare_both(u, i, r, nu, ni, seed=3, grad_mode="sum",
                                  passes=1)
    assert_same_stream(jd, jo, td, to)
    assert int(td.u_lo.max()) == nu + 1 - td.tile  # a clamped tile
    assert int(td.ul.max()) == td.tile - 1  # the trash row, local
    js, ts = states(nu, ni, seed=1)
    js, ts = two_epochs(js, ts, jd, td, seed=2)
    assert_states_close(js, ts)


def test_stream_sum_equals_batched_epoch_on_the_stream_order():
    """"sum" mode = the port's sgd_epoch (the oracle's semantics) run with
    the stream order as its permutation: same terms, another association
    order."""
    u, i, r = synthetic_ratings(NU, NI, 900, true_rank=3, seed=4)
    td, order = tss.prepare_stream_sgd(u, i, r, B, NU, NI, seed=5,
                                       dtype=torch.float64,
                                       grad_mode="sum", device="cpu")
    n = len(r)
    uu = np.full(len(order), NU, np.int64)
    ii = np.full(len(order), NI, np.int64)
    rr = np.zeros(len(order))
    real = (order >= 0) & (order < n)  # else pass or batch padding
    uu[real], ii[real], rr[real] = (u[order[real]], i[order[real]],
                                    r[order[real]])
    rdata = tsgd.SGDData(torch.as_tensor(uu), torch.as_tensor(ii),
                         torch.as_tensor(rr), n)
    _, ta = states(seed=3)
    _, tb = states(seed=3)
    nb = td.ul.shape[0]
    got = tss.sgd_stream_epoch(ta, td.ul, td.ib, td.rb, td.wu, td.wi,
                               td.u_lo, np.arange(nb), 0.02, 0.01, td.tile)
    ref = tsgd.sgd_epoch(tb, rdata, np.arange(len(order)), 0.02, 0.01, B,
                         "sum")
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-12,
                                   atol=1e-12)


def test_trainer_determinism_reshuffle_and_guards():
    u, i, r = synthetic_ratings(60, 30, 700, true_rank=2, seed=4)
    data, _ = tss.prepare_stream_sgd(u, i, r, B, 60, 30, seed=1,
                                     device="cpu")
    tr = tss.StreamSGD(lam=0.02, lr=0.02, seed=9)

    def run(ep):
        return tr.epoch(tbase.init_state(60, 30, 4, seed=2, mu=3.0,
                                         device="cpu"), data, ep)

    a, b, c = run(0), run(0), run(1)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert not torch.equal(a.U, c.U)
    for x in (a.U, a.V, a.bu, a.bi):
        assert bool((x[-1] == 0).all()) and x.is_contiguous()
    with pytest.raises(ValueError, match="grad_mode"):
        tss.StreamSGD(grad_mode="mean").epoch(a, data, 0)


def test_host_stream_is_built_but_not_trained():
    """device=False keeps the stream on the host as NumPy, equal to the JAX
    package's; it is not trained where it lies: its out-of-core epoch
    moves it to the state's device chunk by chunk and gives the resident
    epoch's factors bit for bit."""
    u, i, r = synthetic_ratings(60, 30, 700, true_rank=2, seed=4)
    jd, jo = jss.prepare_stream_sgd(u, i, r, B, 60, 30, seed=1,
                                    device=False)
    td, to = tss.prepare_stream_sgd(u, i, r, B, 60, 30, seed=1,
                                    device=False)
    np.testing.assert_array_equal(jo, to)
    for name in ("ul", "ib", "rb", "wu", "wi", "u_lo"):
        a, b = getattr(jd, name), getattr(td, name)
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    dev, _ = tss.prepare_stream_sgd(u, i, r, B, 60, 30, seed=1,
                                    device="cpu")
    st = tbase.init_state(60, 30, 4, seed=2, device="cpu")
    got = tss.StreamSGD().epoch(st, td, 0)
    st = tbase.init_state(60, 30, 4, seed=2, device="cpu")
    ref = tss.StreamSGD().epoch(st, dev, 0)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    assert isinstance(td.ul, np.ndarray)  # the stream stayed on the host


def test_stream_converges_like_the_batched_trainer():
    """The stream default (capped weights + pass striping) tracks the
    uniformly-shuffled batched path in its default "sum" mode, within the
    band the JAX package's tests/test_sgd_stream.py pins (0.02 RMSE)."""
    from ycnr_tpu_torch.data.split import train_test_split
    from ycnr_tpu_torch.ops.layout import pad_coo

    nu, ni, k, b = 1200, 400, 8, 2048
    u, i, r = synthetic_ratings(nu, ni, 60_000, true_rank=6, seed=11)
    (tu, ti, tr_), (su, si, sr) = train_test_split(u, i, r, 0.1, seed=11)
    mu = float(tr_.mean())
    pu, pi, pr, n = pad_coo(su, si, sr, nu, ni, 256)

    def final(trainer, data):
        st = tbase.init_state(nu, ni, k, seed=0, mu=mu, device="cpu")
        for ep in range(8):
            st = trainer.epoch(st, data, ep)
        return float(tbase.rmse_padded(st, pu, pi, pr, n))

    sdata, _ = tss.prepare_stream_sgd(tu, ti, tr_, b, nu, ni, seed=0,
                                      device="cpu")
    a = final(tss.StreamSGD(0.02, 0.03, 0.95, seed=0), sdata)
    bdata = tsgd.prepare_sgd_data(tu, ti, tr_, b, nu, ni, device="cpu")
    c = final(tsgd.BiasedSGD(0.02, 0.03, 0.95, b, seed=0), bdata)
    assert a < 0.55 and c < 0.55, (a, c)
    assert abs(a - c) < 0.02, (a, c)
