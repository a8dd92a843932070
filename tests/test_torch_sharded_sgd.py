"""The port's data-parallel SGD, BPR and stream SGD
(``ycnr_tpu_torch.parallel.shard`` / ``parallel.sgd_stream``) as D gloo
thread ranks on the CPU, against ``ycnr_tpu.parallel`` on a D-device mesh
of fake CPU devices. ``jax.random`` has no torch twin, so each rank is
handed the JAX package's own per-shard draws (``fold_in(key, d)``); the
float64 factors then agree to 1e-9 after every epoch, trash rows 0."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ycnr_tpu.models.base import state_from_numpy as jstate_from_numpy
from ycnr_tpu.parallel import (
    build_bpr_bits as jbpr_bits,
    build_sharded_data as jbuild,
    gather_state as jgather,
    make_mesh as jmake_mesh,
    scatter_state as jscatter,
    sharded_bpr_epoch as jbpr,
    sharded_sgd_epoch as jsgd,
)
from ycnr_tpu.parallel.sgd_stream import (
    build_sharded_stream_sgd as jbuild_stream,
    sharded_sgd_stream_epoch as jstream,
)
from ycnr_tpu_torch.models.base import state_from_numpy
from ycnr_tpu_torch.parallel import shard as tsh
from ycnr_tpu_torch.parallel import sgd_stream as tss
from ycnr_tpu_torch.parallel.mesh import run_ranks
from test_torch_sharding import padded, setup

torch.set_num_threads(1)
DT = jnp.float64
EPOCHS = 2


def _start(U0, V0, nu, ni, mu):
    rng = np.random.default_rng(11)
    bu, bi = rng.normal(0, 0.05, nu), rng.normal(0, 0.05, ni)
    j = jstate_from_numpy(U0, V0, bu, bi, mu=mu, dtype=DT)
    t = state_from_numpy(padded(U0), padded(V0), padded(bu), padded(bi), mu,
                         device="cpu", dtype=torch.float64)
    return j, t


def _same_state(got, want):
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-9,
                                   atol=1e-9)
    for x in got[:4]:
        assert not x[-1].any()  # trash rows stay zero


@pytest.mark.parametrize("D", [1, 2, 4])
def test_sharded_sgd_matches_jax(D):
    coo, _, U0, V0, nu, ni = setup(seed=3)
    B, lam = 256, 0.02
    mu = float(coo[2].mean())
    mesh = jmake_mesh(D)
    jdata, jmeta = jbuild(*coo, nu, ni, D, chunk_len=8, block_chunks=32,
                          sgd_batch=B, dtype=DT, mesh=mesh, algo="sgd")
    js, ts = _start(U0, V0, nu, ni, mu)
    jst = jscatter(js, jmeta, mesh)
    key = jax.random.key(5)
    n = jdata.sgd_u.shape[1]
    perms = []
    for ep in range(EPOCHS):
        k = jax.random.fold_in(key, ep)
        perms.append([np.asarray(jax.random.permutation(
            jax.random.fold_in(k, d), n)) for d in range(D)])
        jst = jsgd(mesh, jst, jdata, lam, 0.05 * 0.9**ep, k, B)
    want = jgather(jst, jmeta)

    data, meta = tsh.build_sharded_data(*coo, nu, ni, D, chunk_len=8,
                                        block_chunks=32, sgd_batch=B,
                                        dtype=torch.float64, algo="sgd")

    def rank(m):
        local = tsh.put_shard(data, m)
        st = tsh.scatter_state(ts, meta, m)
        for ep in range(EPOCHS):
            st = tsh.sharded_sgd_epoch(m, st, local, lam, 0.05 * 0.9**ep, B,
                                       perm=perms[ep][m.rank])
        return tsh.gather_state(st, meta, m)

    for got in run_ranks(rank, D):
        _same_state(got, want)


@pytest.mark.parametrize("grad_mode", ["mean", "emean"])
@pytest.mark.parametrize("shuffle", ["rows", "batches"])
@pytest.mark.parametrize("D", [2, 4])
def test_sharded_bpr_matches_jax(D, shuffle, grad_mode):
    coo, _, U0, V0, nu, ni = setup(seed=8)
    B, lam = 128, 0.01
    b_local = B // D
    mesh = jmake_mesh(D)
    jdata, jmeta = jbuild(*coo, nu, ni, D, chunk_len=8, block_chunks=32,
                          sgd_batch=B, dtype=DT, mesh=mesh, algo="bpr")
    jaux = jbpr_bits(coo[0], coo[1], jmeta, B, mesh=mesh)
    js, ts = _start(U0, V0, nu, ni, 0.0)
    jst = jscatter(js, jmeta, mesh)
    key = jax.random.key(9)
    n = jdata.sgd_u.shape[1]
    draws = []
    for ep in range(EPOCHS):
        k = jax.random.fold_in(key, ep)
        per = []
        for d in range(D):
            kp, kn = jax.random.split(jax.random.fold_in(k, d))
            negs = np.asarray(jax.random.randint(kn, (n,), 0, ni, jnp.int32))
            perm = np.asarray(jax.random.permutation(
                kp, n // b_local if shuffle == "batches" else n))
            per.append((perm, negs))
        draws.append(per)
        jst = jbpr(mesh, jst, jdata, jaux, lam, 0.05, k, B,
                   grad_mode=grad_mode, shuffle=shuffle)
    want = jgather(jst, jmeta)

    data, meta = tsh.build_sharded_data(*coo, nu, ni, D, chunk_len=8,
                                        block_chunks=32, sgd_batch=B,
                                        dtype=torch.float64, algo="bpr")
    aux = tsh.build_bpr_bits(coo[0], coo[1], meta, B)

    def rank(m):
        local, laux = tsh.put_shard(data, m), tsh.put_shard(aux, m)
        st = tsh.scatter_state(ts, meta, m)
        for ep in range(EPOCHS):
            perm, negs = draws[ep][m.rank]
            st = tsh.sharded_bpr_epoch(m, st, local, laux, lam, 0.05, B,
                                       grad_mode=grad_mode, shuffle=shuffle,
                                       perm=perm, negs=negs)
        return tsh.gather_state(st, meta, m)

    for got in run_ranks(rank, D):
        _same_state(got, want)


@pytest.mark.parametrize("grad_mode", ["mean", "capped"])
@pytest.mark.parametrize("D", [1, 2, 4])
def test_sharded_stream_sgd_matches_jax(D, grad_mode):
    coo, _, U0, V0, nu, ni = setup(seed=4)
    B, lam = 256, 0.02
    mu = float(coo[2].mean())
    mesh = jmake_mesh(D)
    _, jmeta = jbuild(*coo, nu, ni, D, chunk_len=8, block_chunks=32,
                      dtype=DT, algo="stream-sgd")
    jdata, _ = jbuild_stream(*coo, jmeta, B, seed=1, dtype=DT,
                             grad_mode=grad_mode, mesh=mesh)
    js, ts = _start(U0, V0, nu, ni, mu)
    jst = jscatter(js, jmeta, mesh)
    key = jax.random.key(2)
    orders = []
    for ep in range(EPOCHS):
        k = jax.random.fold_in(key, ep)
        orders.append(np.asarray(jax.random.permutation(k,
                                                        jdata.ul.shape[1])))
        jst = jstream(mesh, jst, jdata, lam, 0.02 * 0.95**ep, k)
    want = jgather(jst, jmeta)

    _, meta = tsh.build_sharded_data(*coo, nu, ni, D, chunk_len=8,
                                     block_chunks=32, dtype=torch.float64,
                                     algo="stream-sgd")
    data, _ = tss.build_sharded_stream_sgd(*coo, meta, B, seed=1,
                                           dtype=torch.float64,
                                           grad_mode=grad_mode)

    def rank(m):
        local = tss.put_stream(data, m)
        st = tsh.scatter_state(ts, meta, m)
        for ep in range(EPOCHS):
            st = tss.sharded_sgd_stream_epoch(m, st, local, lam,
                                              0.02 * 0.95**ep,
                                              order=orders[ep])
        return tsh.gather_state(st, meta, m)

    for got in run_ranks(rank, D):
        _same_state(got, want)


def test_free_running_draws_are_per_rank_and_repeat():
    """Without explicit draws a rank draws from rank_seed(seed, epoch,
    rank): two runs give the same bits, the ranks' streams differ, and
    the replicated V agrees bit for bit on every rank."""
    coo, _, U0, V0, nu, ni = setup(seed=3)
    data, meta = tsh.build_sharded_data(*coo, nu, ni, 2, chunk_len=8,
                                        block_chunks=32, sgd_batch=128,
                                        dtype=torch.float64, algo="bpr")
    aux = tsh.build_bpr_bits(coo[0], coo[1], meta, 128)
    _, ts = _start(U0, V0, nu, ni, 0.0)

    def rank(m):
        local, laux = tsh.put_shard(data, m), tsh.put_shard(aux, m)
        st = tsh.scatter_state(ts, meta, m)
        for ep in range(2):
            st = tsh.sharded_bpr_epoch(m, st, local, laux, 0.01, 0.05, 128,
                                       seed=4, epoch=ep)
        return st.V.clone(), tsh.gather_state(st, meta, m)

    a, b = run_ranks(rank, 2), run_ranks(rank, 2)
    assert torch.equal(a[0][0], a[1][0])  # replicas agree
    for x, y in zip(a[0][1], b[0][1]):
        assert torch.equal(x, y)
    assert tsh.rank_seed(4, 1, 0) != tsh.rank_seed(4, 1, 1)
