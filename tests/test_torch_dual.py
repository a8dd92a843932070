"""The port's item-sharded V-step (``ycnr_tpu_torch.parallel.dual``) as D
gloo thread ranks on the CPU, against ``ycnr_tpu.parallel.dual`` on a
D-device mesh of fake CPU devices: float64 factors and held-out RMSE to
1e-9 after every epoch, every shard's trash rows exactly 0, and the
cat-space top-N equal to the reference's and to the single-GPU
``recommend_all`` on the gathered state."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ycnr_tpu.models.base import state_from_numpy as jstate_from_numpy
from ycnr_tpu.parallel import make_mesh as jmake_mesh
from ycnr_tpu.parallel import dual as jdual
from ycnr_tpu_torch.eval.recommend import recommend_all
from ycnr_tpu_torch.ops.layout import build_blocked_csr
from ycnr_tpu_torch.parallel import dual as tdual
from ycnr_tpu_torch.parallel.mesh import run_ranks
from ycnr_tpu_torch.parallel.shard import put_shard
from test_torch_sharding import assert_same_lists, port_state, setup

torch.set_num_threads(1)
DT = jnp.float64


def run_both(algo, D, epochs=2, lam=0.05, alpha=8.0):
    coo, test, U0, V0, nu, ni = setup(seed=1 if algo == "als" else 2)
    mesh = jmake_mesh(D)
    jdata, jmeta = jdual.build_dual_sharded_data(
        *coo, nu, ni, D, chunk_len=8, block_chunks=32, test_u=test[0],
        test_i=test[1], test_r=test[2], dtype=DT, mesh=mesh)
    jst = jdual.dual_scatter_state(jstate_from_numpy(U0, V0, dtype=DT),
                                   jmeta, mesh)
    want = []
    for _ in range(epochs):
        jst = (jdual.dual_als_epoch(mesh, jst, jdata, lam) if algo == "als"
               else jdual.dual_ials_epoch(mesh, jst, jdata, lam, alpha))
        g = jdual.dual_gather_state(jst, jmeta)
        want.append((np.asarray(g.U), np.asarray(g.V),
                     jdual.dual_rmse(mesh, jst, jdata, jmeta.test_n)))

    data, meta = tdual.build_dual_sharded_data(
        *coo, nu, ni, D, chunk_len=8, block_chunks=32, test_u=test[0],
        test_i=test[1], test_r=test[2], dtype=torch.float64)

    def rank(m):
        local = put_shard(data, m)
        st = tdual.dual_scatter_state(port_state(U0, V0), meta, m)
        out = []
        for _ in range(epochs):
            st = (tdual.dual_als_epoch(m, st, local, lam) if algo == "als"
                  else tdual.dual_ials_epoch(m, st, local, lam, alpha))
            assert not st.U[-1].any() and not st.V[-1].any()
            g = tdual.dual_gather_state(st, meta, m)
            out.append((g.U.numpy(), g.V.numpy(),
                        tdual.dual_rmse(m, st, local, meta.test_n)))
        return out

    return run_ranks(rank, D), want


@pytest.mark.parametrize("D", [1, 2, 4])
@pytest.mark.parametrize("algo", ["als", "ials"])
def test_dual_epochs_match_jax(algo, D):
    got, want = run_both(algo, D)
    for per_rank in got:
        for (gu, gv, gr), (ju, jv, jr) in zip(per_rank, want):
            np.testing.assert_allclose(gu, ju, rtol=1e-9, atol=1e-9)
            np.testing.assert_allclose(gv, jv, rtol=1e-9, atol=1e-9)
            assert abs(gr - jr) < 1e-9
            assert not gu[-1].any() and not gv[-1].any()


@pytest.mark.parametrize("D", [2, 4])
def test_dual_recommend_all_matches_jax_and_single_gpu(D):
    coo, _, U0, V0, nu, ni = setup(seed=3)
    mesh = jmake_mesh(D)
    jdata, jmeta = jdual.build_dual_sharded_data(
        *coo, nu, ni, D, chunk_len=8, block_chunks=32, dtype=DT, mesh=mesh,
        host_user_layout=True)
    jst = jdual.dual_scatter_state(jstate_from_numpy(U0, V0, dtype=DT),
                                   jmeta, mesh)
    jst = jdual.dual_als_epoch(mesh, jst, jdata, 0.05)
    ju, ji, js = jdual.dual_recommend_all(mesh, jst, jdata, jmeta, n=5)

    data, meta = tdual.build_dual_sharded_data(
        *coo, nu, ni, D, chunk_len=8, block_chunks=32, dtype=torch.float64,
        host_user_layout=True)
    bits = tdual.dual_rated_bits(meta)

    def rank(m):
        local = put_shard(data, m)
        st = tdual.dual_scatter_state(port_state(U0, V0), meta, m)
        st = tdual.dual_als_epoch(m, st, local, 0.05)
        return (tdual.dual_recommend_all(m, st, local, meta, n=5,
                                         rated_bits=bits),
                tdual.dual_gather_state(st, meta, m))

    res = run_ranks(rank, D)
    for (tu, ti, ts), _ in res:
        np.testing.assert_array_equal(tu, ju)
        assert_same_lists(ti, ts, ji, js, atol=1e-9)
    g = res[0][1]
    lay = build_blocked_csr(coo[0], coo[1], coo[2], nu, ni, 8, 32)
    su, si, ss = recommend_all(g, lay, n=5)
    o_t, o_s = np.argsort(tu), np.argsort(su)
    np.testing.assert_array_equal(tu[o_t], su[o_s])
    assert_same_lists(ti[o_t], ts[o_t], si[o_s], ss[o_s], atol=1e-9)
