"""The port's wire-order storage phase (``models/ooc.phase_packed_wire``,
factor tables kept in wire order) against ``ycnr_tpu.models.ooc``: the
cases of ``tests/test_ooc_wire.py``, each through both packages.

A wire-order storage epoch computes the same per-entity normal equations
as the classic OOC epoch; each row's ratings are sorted by storage id
instead of entity id, so float64 agreement is ~1e-12, not bitwise (the
JAX test's 1e-11). The storage init, the plan and the builds equal the
JAX package's bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import torch

from ycnr_tpu.models import ooc as jooc
from ycnr_tpu.ops import packed as jpacked
from ycnr_tpu_torch.data.synthetic import synthetic_ratings
from ycnr_tpu_torch.models import base as tbase
from ycnr_tpu_torch.models import ooc as tooc
from ycnr_tpu_torch.ops import packed as tpacked

torch.set_num_threads(1)

NU, NI, K = 210, 80, 8
LAM, ALPHA = 0.05, 20.0


def _data(seed=3):
    u, i, r = synthetic_ratings(NU, NI, 4000, true_rank=4, seed=seed)
    keep = u >= 5  # users 0..4 lose every rating: cold
    return u[keep], i[keep], r[keep]


def _builds(u, i, r, groups=4):
    up = tpacked.wire_storage_plan(np.bincount(u, minlength=NU),
                                   rank_hint=8, max_groups=groups)
    ip = tpacked.wire_storage_plan(np.bincount(i, minlength=NI),
                                   rank_hint=8, max_groups=groups)
    kw = dict(rank_hint=8, max_groups=groups)
    return (up, ip,
            tpacked.build_packed(u, i, r, NU, NI, **kw),
            tpacked.build_packed(i, u, r, NI, NU, **kw),
            tpacked.build_packed(u, i, r, NU, NI, other_plan=ip, **kw),
            tpacked.build_packed(i, u, r, NI, NU, other_plan=up, **kw))


def _run_pair(algo="als", epochs=2):
    """The port's classic OOC run, its wire-order storage run and the JAX
    package's wire-order storage run, from the same init."""
    up, ip, cu, ci, wu, wi = _builds(*_data())
    st = tbase.init_state(NU, NI, K, seed=0, dtype=torch.float64,
                          device="cpu")
    U = tooc.wire_storage_init(up, K, seed=0, dtype=torch.float64,
                               device="cpu")
    V = tooc.wire_storage_init(ip, K, seed=0, entity_offset=NU,
                               dtype=torch.float64, device="cpu")
    jU = jooc.wire_storage_init(up, K, seed=0, dtype=jnp.float64)
    jV = jooc.wire_storage_init(ip, K, seed=0, entity_offset=NU,
                                dtype=jnp.float64)
    tu_p, ti_p = tooc.DeviceWirePlan(up), tooc.DeviceWirePlan(ip)
    ju_p, ji_p = jooc.DeviceWirePlan(up), jooc.DeviceWirePlan(ip)
    for _ in range(epochs):
        if algo == "als":
            st = tooc.als_epoch_ooc(st, cu, ci, LAM)
            U, V = tooc.als_epoch_wire(U, V, wu, wi, LAM, tu_p, ti_p)
            jU, jV = jooc.als_epoch_wire(jU, jV, wu, wi, LAM, ju_p, ji_p)
        else:
            st = tooc.ials_epoch_ooc(st, cu, ci, LAM, ALPHA)
            U, V = tooc.ials_epoch_wire(U, V, wu, wi, LAM, ALPHA, tu_p,
                                        ti_p)
            jU, jV = jooc.ials_epoch_wire(jU, jV, wu, wi, LAM, ALPHA, ju_p,
                                          ji_p)
    return st, U.numpy(), V.numpy(), np.asarray(jU), np.asarray(jV), up, ip


def test_storage_init_matches_classic_init():
    u, i, _ = _data()
    up = tpacked.wire_storage_plan(np.bincount(u, minlength=NU),
                                   rank_hint=8)
    ip = tpacked.wire_storage_plan(np.bincount(i, minlength=NI),
                                   rank_hint=8)
    st = tbase.init_state(NU, NI, K, seed=7, dtype=torch.float64,
                          device="cpu")
    U = tooc.wire_storage_init(up, K, seed=7, dtype=torch.float64,
                               device="cpu").numpy()
    V = tooc.wire_storage_init(ip, K, seed=7, entity_offset=NU,
                               dtype=torch.float64, device="cpu").numpy()
    np.testing.assert_array_equal(U[up.perm], st.U.numpy()[:NU])
    np.testing.assert_array_equal(V[ip.perm], st.V.numpy()[:NI])
    # the JAX package's storage init, bit for bit
    np.testing.assert_array_equal(
        U, np.asarray(jooc.wire_storage_init(up, K, seed=7,
                                             dtype=jnp.float64)))
    np.testing.assert_array_equal(
        V, np.asarray(jooc.wire_storage_init(ip, K, seed=7,
                                             entity_offset=NU,
                                             dtype=jnp.float64)))
    mask = np.ones(up.table_rows, bool)
    mask[up.perm] = False
    assert np.all(U[mask] == 0)  # group padding / scratch / zero start 0


def _assert_pair(st, U, V, jU, jV, up, ip):
    np.testing.assert_allclose(U[up.perm], st.U.numpy()[:NU], rtol=0,
                               atol=1e-11)
    np.testing.assert_allclose(V[ip.perm], st.V.numpy()[:NI], rtol=0,
                               atol=1e-11)
    np.testing.assert_allclose(U, jU, rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(V, jV, rtol=1e-9, atol=1e-12)


def test_als_parity_f64():
    _assert_pair(*_run_pair("als"))


def test_ials_parity_f64():
    _assert_pair(*_run_pair("ials", epochs=1))


def test_cold_rows_and_zero_row_persist():
    st, U, V, _, _, up, ip = _run_pair("als", epochs=1)
    init_U = tooc.wire_storage_init(up, K, seed=0, dtype=torch.float64,
                                    device="cpu").numpy()
    cold = up.perm[:5]  # users 0..4 have no ratings
    assert np.all(cold >= up.rows)  # cold region by construction
    np.testing.assert_array_equal(U[cold], init_U[cold])
    # the twin-gather sentinel row stays exactly zero after training
    assert np.all(U[up.zero_row] == 0)
    assert np.all(V[ip.zero_row] == 0)


def test_plan_lockstep_with_build():
    """plan.perm from counts == the positions the built wire assigns, and
    plan and wire equal the JAX package's."""
    u, i, r = _data()
    up, ip, _, _, ws_u, _ = _builds(u, i, r)
    jup = jpacked.wire_storage_plan(np.bincount(u, minlength=NU),
                                    rank_hint=8, max_groups=4)
    for a, b in zip(up, jup):
        if isinstance(a, tuple):
            assert all(np.array_equal(x, y) for x, y in zip(a, b))
        else:
            assert np.array_equal(a, b)
    jws_u = jpacked.build_packed(u, i, r, NU, NI, other_plan=jpacked.
                                 wire_storage_plan(np.bincount(
                                     i, minlength=NI), rank_hint=8,
                                     max_groups=4),
                                 rank_hint=8, max_groups=4)
    pos = 0
    for g, off, jg in zip(ws_u, up.offs, jws_u, strict=True):
        for name, a, b in zip(g._fields, g, jg):
            assert np.array_equal(a, b), name
        nb, ne = g.eid.shape
        rows = off[:, None] + np.arange(ne)[None, :]
        real = g.eid < NU
        assert np.array_equal(up.perm[g.eid[real]], rows[real])
        pos += nb * ne
        assert g.n_other == ip.zero_row  # the decode sentinel
    assert pos == up.rows


def test_storage_init_chunked_burn_matches():
    """The chunked RNG burn (2^20 rows a chunk) consumes the same stream
    as one call, across a chunk edge, as the JAX package's does."""
    ip = tpacked.wire_storage_plan(np.bincount(_data()[1], minlength=NI),
                                   rank_hint=8)
    offset = (1 << 20) + 37
    a = tooc.wire_storage_init(ip, K, seed=3, entity_offset=offset,
                               dtype=torch.float64, device="cpu").numpy()
    rng = np.random.default_rng(3)
    rng.normal(0.0, 0.1, (offset, K))  # one-shot burn
    vals = rng.normal(0.0, 0.1, (NI, K))
    np.testing.assert_array_equal(a[ip.perm], vals)
    np.testing.assert_array_equal(
        a, np.asarray(jooc.wire_storage_init(ip, K, seed=3,
                                             entity_offset=offset,
                                             dtype=jnp.float64)))
