"""The port's user-sharded ALS-WR / iALS (``ycnr_tpu_torch.parallel.shard``)
run as D gloo thread ranks on the CPU, against ``ycnr_tpu.parallel`` on a
D-device mesh of the JAX conftest's fake CPU devices: the same float64
inputs and start factors, factors and held-out RMSE to 1e-9 after every
epoch, the trash rows exactly 0, the top-N lists equal."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ycnr_tpu.data.split import train_test_split
from ycnr_tpu.data.synthetic import synthetic_ratings
from ycnr_tpu.eval.recommend import build_rated_bits as jbuild_rated_bits
from ycnr_tpu.models.base import state_from_numpy as jstate_from_numpy
from ycnr_tpu.parallel import (
    build_sharded_data as jbuild,
    gather_state as jgather,
    make_mesh as jmake_mesh,
    scatter_state as jscatter,
    sharded_als_epoch as jals,
    sharded_ials_epoch as jials,
    sharded_recommend_all as jrecommend,
    sharded_rmse as jrmse,
)
from ycnr_tpu_torch.eval.recommend import build_rated_bits, recommend_all
from ycnr_tpu_torch.models.base import state_from_numpy
from ycnr_tpu_torch.ops.layout import build_blocked_csr
from ycnr_tpu_torch.parallel import shard as tsh
from ycnr_tpu_torch.parallel.mesh import run_ranks

torch.set_num_threads(1)
DT = jnp.float64


def setup(seed=0, n_users=70, n_items=50, nnz=3000, k=6):
    u, i, r = synthetic_ratings(n_users, n_items, nnz, true_rank=4,
                                seed=seed)
    (tu, ti, tr), (su, si, sr) = train_test_split(u, i, r, 0.1, seed)
    rng = np.random.default_rng(seed)
    U0 = rng.normal(0, 0.1, (n_users, k))
    V0 = rng.normal(0, 0.1, (n_items, k))
    return (tu, ti, tr), (su, si, sr), U0, V0, n_users, n_items


def padded(x):
    return np.concatenate([x, np.zeros((1,) + x.shape[1:])])


def port_state(U0, V0, mu=0.0):
    return state_from_numpy(padded(U0), padded(V0),
                            np.zeros(len(U0) + 1), np.zeros(len(V0) + 1),
                            mu, device="cpu", dtype=torch.float64)


def assert_same_lists(ids, sc, want_ids, want_sc, atol=1e-12):
    """Equal scores, and equal ids wherever the score is not the masked
    tail (users with fewer than n unrated items: NEG_INF ties, whose order
    torch.topk and lax.top_k break differently)."""
    np.testing.assert_allclose(sc, want_sc, rtol=0, atol=atol)
    live = want_sc > -1e38
    np.testing.assert_array_equal(ids[live], want_ids[live])
    assert live.mean() > 0.5


def run_jax(algo, D, coo, test, U0, V0, nu, ni, epochs=2, lam=0.05,
            alpha=8.0):
    mesh = jmake_mesh(D)
    data, meta = jbuild(*coo, nu, ni, D, chunk_len=8, block_chunks=32,
                        test_u=test[0], test_i=test[1], test_r=test[2],
                        dtype=DT, mesh=mesh)
    st = jscatter(jstate_from_numpy(U0, V0, dtype=DT), meta, mesh)
    out = []
    for _ in range(epochs):
        st = (jals(mesh, st, data, lam) if algo == "als"
              else jials(mesh, st, data, lam, alpha))
        g = jgather(st, meta)
        out.append((np.asarray(g.U), np.asarray(g.V),
                    jrmse(mesh, st, data, meta.test_n)))
    return out


def run_port(algo, D, coo, test, U0, V0, nu, ni, epochs=2, lam=0.05,
             alpha=8.0):
    data, meta = tsh.build_sharded_data(
        *coo, nu, ni, D, chunk_len=8, block_chunks=32, test_u=test[0],
        test_i=test[1], test_r=test[2], dtype=torch.float64)

    def rank(mesh):
        local = tsh.put_shard(data, mesh)
        st = tsh.scatter_state(port_state(U0, V0), meta, mesh)
        out = []
        for _ in range(epochs):
            st = (tsh.sharded_als_epoch(mesh, st, local, lam)
                  if algo == "als"
                  else tsh.sharded_ials_epoch(mesh, st, local, lam, alpha))
            assert bool((st.U[-1] == 0).all()), "local trash row"
            assert bool((st.V[-1] == 0).all()), "item trash row"
            g = tsh.gather_state(st, meta, mesh)
            out.append((g.U.numpy(), g.V.numpy(),
                        tsh.sharded_rmse(mesh, st, local, meta.test_n)))
        return out

    return run_ranks(rank, D)


@pytest.mark.parametrize("D", [1, 2, 4])
@pytest.mark.parametrize("algo", ["als", "ials"])
def test_sharded_epochs_match_jax(algo, D):
    coo, test, U0, V0, nu, ni = setup(seed=2 if algo == "ials" else 0)
    want = run_jax(algo, D, coo, test, U0, V0, nu, ni)
    got = run_port(algo, D, coo, test, U0, V0, nu, ni)
    for r in range(D):  # every rank holds the same gathered state
        for (gu, gv, gr), (ju, jv, jr) in zip(got[r], want):
            np.testing.assert_allclose(gu, ju, rtol=1e-9, atol=1e-9)
            np.testing.assert_allclose(gv, jv, rtol=1e-9, atol=1e-9)
            assert abs(gr - jr) < 1e-9
            assert not gu[-1].any() and not gv[-1].any()


@pytest.mark.parametrize("D", [2, 3])
def test_sharded_rmse_matches_jax(D):
    """A state with biases and mu: every prediction term is summed."""
    coo, test, U0, V0, nu, ni = setup(seed=5)
    rng = np.random.default_rng(1)
    bu, bi = rng.normal(0, 0.1, nu), rng.normal(0, 0.1, ni)
    mesh = jmake_mesh(D)
    jdata, jmeta = jbuild(*coo, nu, ni, D, chunk_len=8, block_chunks=32,
                          test_u=test[0], test_i=test[1], test_r=test[2],
                          dtype=DT, mesh=mesh)
    jst = jscatter(jstate_from_numpy(U0, V0, bu, bi, mu=3.1, dtype=DT),
                   jmeta, mesh)
    want = jrmse(mesh, jst, jdata, jmeta.test_n)
    data, meta = tsh.build_sharded_data(
        *coo, nu, ni, D, chunk_len=8, block_chunks=32, test_u=test[0],
        test_i=test[1], test_r=test[2], dtype=torch.float64)
    gstate = state_from_numpy(padded(U0), padded(V0), padded(bu), padded(bi),
                              3.1, device="cpu", dtype=torch.float64)
    got = run_ranks(lambda mesh: tsh.sharded_rmse(
        mesh, tsh.scatter_state(gstate, meta, mesh),
        tsh.put_shard(data, mesh), meta.test_n), D)
    assert all(abs(g - want) < 1e-12 for g in got)


@pytest.mark.parametrize("bits", [False, True])
@pytest.mark.parametrize("D", [2, 4])
def test_sharded_recommend_all_matches_jax_and_single_gpu(D, bits):
    coo, _, U0, V0, nu, ni = setup(seed=6)
    mesh = jmake_mesh(D)
    jdata, jmeta = jbuild(*coo, nu, ni, D, chunk_len=8, block_chunks=32,
                          dtype=DT)  # host arrays, as the reference's test
    jst = jscatter(jstate_from_numpy(U0, V0, dtype=DT), jmeta, mesh)
    jb = jbuild_rated_bits(jdata.user_layout, ni) if bits else None
    ju, ji, js = jrecommend(mesh, jst, jdata, jmeta, n=7, rated_bits=jb)

    data, meta = tsh.build_sharded_data(*coo, nu, ni, D, chunk_len=8,
                                        block_chunks=32,
                                        dtype=torch.float64,
                                        host_user_layout=True)
    tb = build_rated_bits(meta.user_layout_host, ni) if bits else None
    gstate = port_state(U0, V0)

    def rank(mesh):
        st = tsh.scatter_state(gstate, meta, mesh)
        return tsh.sharded_recommend_all(mesh, st, tsh.put_shard(data, mesh),
                                         meta, n=7, rated_bits=tb)

    for tu, ti, ts in run_ranks(rank, D):
        np.testing.assert_array_equal(tu, ju)
        assert_same_lists(ti, ts, ji, js)
    # and the single-GPU recommend_all on the gathered (= start) state
    lay = build_blocked_csr(coo[0], coo[1], coo[2], nu, ni, 8, 32)
    su, si, ss = recommend_all(gstate, lay, n=7)
    o_t, o_s = np.argsort(tu), np.argsort(su)
    np.testing.assert_array_equal(tu[o_t], su[o_s])
    assert_same_lists(ti[o_t], ts[o_t], si[o_s], ss[o_s])


def test_sharded_recommend_all_fused_plain_on_cpu():
    """method="fused" on CPU tensors runs K2's plain version on every rank
    (a catalog big enough for the two-level select): the ids equal the
    single-GPU fused pass on the gathered state."""
    nu, ni, k = 60, 700, 4
    u, i, r = synthetic_ratings(nu, ni, 2500, true_rank=3, seed=4)
    rng = np.random.default_rng(3)
    U0, V0 = rng.normal(0, 0.3, (nu, k)), rng.normal(0, 0.3, (ni, k))
    data, meta = tsh.build_sharded_data(u, i, r, nu, ni, 2, chunk_len=8,
                                        block_chunks=32,
                                        host_user_layout=True)
    bits = build_rated_bits(meta.user_layout_host, ni)
    gstate = state_from_numpy(padded(U0), padded(V0), np.zeros(nu + 1),
                              np.zeros(ni + 1), 0.0, device="cpu")

    def rank(mesh):
        st = tsh.scatter_state(gstate, meta, mesh)
        return tsh.sharded_recommend_all(mesh, st, tsh.put_shard(data, mesh),
                                         meta, n=5, rated_bits=bits,
                                         method="fused")

    got_u, got_i, got_s = run_ranks(rank, 2)[0]
    lay = build_blocked_csr(u, i, r, nu, ni, 8, 32)
    su, si, ss = recommend_all(gstate, lay, n=5, method="fused")
    o_t, o_s = np.argsort(got_u), np.argsort(su)
    np.testing.assert_array_equal(got_u[o_t], su[o_s])
    assert_same_lists(got_i[o_t], got_s[o_t], si[o_s], ss[o_s], atol=0)


# --- train(cfg) with cfg.mesh.n_shards > 1 ---------------------------------

def _train_cfg(algo="als", D=2, epochs=3, **kw):
    import dataclasses

    from ycnr_tpu_torch.config import MeshConfig, get_preset

    base = {"als": "ml100k-als", "ials": "ml20m-ials", "sgd": "ml1m-sgd",
            "bpr": "ml20m-bpr"}[algo]
    cfg = get_preset(base)
    p = dataclasses.replace(getattr(cfg, algo), dtype="float64",
                            epochs=epochs, rank=5)
    if algo in ("sgd", "bpr"):
        p = dataclasses.replace(p, batch_size=256)
    mesh = MeshConfig(n_shards=D, vstep_mode=kw.pop("vstep_mode",
                                                    "gram_psum"))
    return dataclasses.replace(
        cfg, out_dir=None, topn=5, mesh=mesh,
        data=dataclasses.replace(cfg.data, source="synthetic", n_users=90,
                                 n_items=60, n_ratings=3000, chunk_len=8),
        **{algo: p}, **kw)


def _events(path):
    import json

    drop = ("t", "epoch_s")
    with open(path) as f:
        return [{k: v for k, v in json.loads(x).items() if k not in drop}
                for x in f]


@pytest.mark.parametrize("algo,mode", [("als", "gram_psum"),
                                       ("ials", "gram_psum"),
                                       ("als", "item_sharded"),
                                       ("ials", "item_sharded")])
def test_train_on_thread_ranks_matches_jax(tmp_path, algo, mode):
    """train(cfg, mesh=) on 2 thread ranks against the JAX package's
    train() at n_shards=2: RMSE history and final factors to 1e-9, the
    same metrics records (shards=2, mode="item_sharded"), the same
    checkpoint epochs; early stopping on the all-reduced RMSE stops both
    at the same epoch."""
    from ycnr_tpu.data.dataset import load_dataset as jload
    from ycnr_tpu.train.loop import train as jtrain
    from ycnr_tpu_torch.data.dataset import load_dataset
    from ycnr_tpu_torch.train.loop import train

    cfg = _train_cfg(algo, epochs=5, vstep_mode=mode,
                     early_stop_patience=1, early_stop_min_delta=0.2)
    ds = load_dataset(cfg.data, rank_hint=5)
    jr = jtrain(cfg, jload(cfg.data, rank_hint=5), out_dir=str(tmp_path / "j"))
    got = run_ranks(lambda m: train(cfg, ds, out_dir=str(tmp_path / "t"),
                                    mesh=m), 2)
    for res in got:
        np.testing.assert_allclose(res.rmse_history, jr.rmse_history,
                                   rtol=0, atol=1e-9)
        for a, b in zip(res.state, jr.state):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-9,
                                       atol=1e-9)
        assert not res.state.U[-1].any() and not res.state.V[-1].any()
    te, je = _events(tmp_path / "t" / "metrics.jsonl"), \
        _events(tmp_path / "j" / "metrics.jsonl")
    assert te == je and te[0]["shards"] == 2
    assert (te[0].get("mode") == "item_sharded") == (mode == "item_sharded")
    assert any(e.get("event") == "early_stop" for e in te)
    assert len(jr.rmse_history) < 5


@pytest.mark.parametrize("algo,method", [("sgd", "batched"),
                                         ("sgd", "stream"), ("bpr", None)])
def test_train_sgd_bpr_on_thread_ranks(tmp_path, algo, method):
    """The SGD / BPR branches through train(): the JAX package's metrics
    record keys, its trajectory within a band (the draws differ), trash
    rows 0, the ranks agree bit for bit, and a second run repeats the
    first."""
    import dataclasses

    from ycnr_tpu.data.dataset import load_dataset as jload
    from ycnr_tpu.train.loop import train as jtrain
    from ycnr_tpu_torch.data.dataset import load_dataset
    from ycnr_tpu_torch.train.loop import train

    cfg = _train_cfg(algo)
    if method:
        cfg = dataclasses.replace(cfg, sgd=dataclasses.replace(
            cfg.sgd, method=method, lr=0.02))
    ds = load_dataset(cfg.data, rank_hint=5)
    jtrain(cfg, jload(cfg.data, rank_hint=5), out_dir=str(tmp_path / "j"))

    def run(tag):
        return run_ranks(lambda m: train(cfg, ds, out_dir=str(
            tmp_path / tag), mesh=m), 2)

    a, b = run("t"), run("t2")
    for x, y in zip(a[0].state, a[1].state):
        assert torch.equal(x, y)
    for x, y in zip(a[0].state, b[0].state):
        assert torch.equal(x, y)
    assert not a[0].state.U[-1].any() and not a[0].state.V[-1].any()
    te, je = _events(tmp_path / "t" / "metrics.jsonl"), \
        _events(tmp_path / "j" / "metrics.jsonl")
    assert [sorted(e) for e in te] == [sorted(e) for e in je]
    hist = a[0].rmse_history
    jhist = [1.0 - e["hit_rate"] if algo == "bpr" else e["rmse_test"]
             for e in je if "epoch" in e and "event" not in e]
    assert len(hist) == 3 and all(np.isfinite(hist))
    # other draws (torch.Generator, not jax.random): the same trajectory
    # within a band, as the single-GPU trainers are held
    np.testing.assert_allclose(hist, jhist, rtol=0, atol=0.05)


@pytest.mark.parametrize("mode", ["gram_psum", "item_sharded"])
def test_ranks_of_one_process_group_share_one_out(tmp_path, monkeypatch,
                                                  mode):
    """train(cfg) inside a process group (no mesh given: the CLI's
    --distributed, torchrun) on 2 thread ranks with one shared out dir and
    shm name, as torchrun --nproc-per-node gives them: rank 0 alone writes
    the metrics, the checkpoints and the shm segment, every rank gathers,
    and the run equals the one on a given mesh."""
    import importlib
    import threading

    import torch.distributed as dist

    from ycnr_tpu_torch.data.dataset import load_dataset
    from ycnr_tpu_torch.train.loop import train

    pmesh = importlib.import_module("ycnr_tpu_torch.parallel.mesh")
    tloop = importlib.import_module("ycnr_tpu_torch.train.loop")
    tsharded = importlib.import_module("ycnr_tpu_torch.train.sharded")

    cfg = _train_cfg("als", vstep_mode=mode, publish_shm="/unused")
    ds = load_dataset(cfg.data, rank_hint=5)
    local, lock, calls = threading.local(), threading.Lock(), []
    save = tsharded.save_checkpoint

    def record(what):
        with lock:
            calls.append((what, local.mesh.rank))

    class Writer:  # stands in for FactorShmWriter: records who publishes
        def publish(self, state, epoch):
            record(f"publish {epoch}")

        def close(self):
            record("close")

    def save_checkpoint(*a, **kw):
        record(f"ckpt {a[2]}")
        return save(*a, **kw)

    def shm_writer(cfg, state):
        record("open")
        return Writer()

    want = run_ranks(lambda m: train(cfg.replace(publish_shm=None), ds,
                                     out_dir=str(tmp_path / "m"), mesh=m),
                     2)[0]
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(pmesh, "make_mesh", lambda D, device=None:
                        local.mesh)
    monkeypatch.setattr(tsharded, "save_checkpoint", save_checkpoint)
    monkeypatch.setattr(tloop, "_shm_writer", shm_writer)

    def rank(m):
        local.mesh = m
        return train(cfg, ds, out_dir=str(tmp_path / "g"))

    got = run_ranks(rank, 2)
    assert cfg.checkpoint_every == 1
    assert sorted(calls) == sorted(
        [("open", 0), ("close", 0)]
        + [(f"{what} {e}", 0) for e in (1, 2, 3)
           for what in ("ckpt", "publish")])
    for res in got:
        assert res.rmse_history == want.rmse_history
        for a, b in zip(res.state, want.state):
            assert torch.equal(a, b)
    assert _events(tmp_path / "g" / "metrics.jsonl") == \
        _events(tmp_path / "m" / "metrics.jsonl")
    assert sorted(p.name for p in (tmp_path / "g" / "ckpt").iterdir()) == \
        sorted(p.name for p in (tmp_path / "m" / "ckpt").iterdir())


def test_train_resumes_from_a_sharded_checkpoint(tmp_path):
    """A 2-epoch sharded run, resumed for a third epoch from its
    checkpoint (gathered state, scattered again), equals the
    uninterrupted 3-epoch run, which the JAX package's load_checkpoint
    reads."""
    import dataclasses

    from ycnr_tpu.train.checkpoint import load_checkpoint as jload_ckpt
    from ycnr_tpu_torch.data.dataset import load_dataset
    from ycnr_tpu_torch.train.loop import train

    cfg = _train_cfg("als")
    ds = load_dataset(cfg.data, rank_hint=5)
    full = run_ranks(lambda m: train(cfg, ds, out_dir=str(tmp_path / "f"),
                                     mesh=m), 2)[0]
    two = dataclasses.replace(cfg, als=dataclasses.replace(cfg.als,
                                                           epochs=2))
    run_ranks(lambda m: train(two, ds, out_dir=str(tmp_path / "r"), mesh=m),
              2)
    res = run_ranks(lambda m: train(cfg, ds, out_dir=str(tmp_path / "r"),
                                    resume=str(tmp_path / "r" / "ckpt"),
                                    mesh=m), 2)[0]
    # the manifest carries the earlier epochs rounded to 6 digits
    assert res.rmse_history[:2] == [round(x, 6) for x in
                                    full.rmse_history[:2]]
    assert res.rmse_history[2] == full.rmse_history[2]
    assert torch.equal(res.state.U, full.state.U)
    jst, man = jload_ckpt(str(tmp_path / "f" / "ckpt"))
    assert man["epoch"] == 3
    np.testing.assert_array_equal(np.asarray(jst.V), full.state.V.numpy())


def test_train_launches_two_rank_processes_and_matches_jax(tmp_path):
    """train(cfg) at n_shards=2 outside any process group starts two gloo
    rank processes (``spawn_ranks``) and returns the gathered result:
    equal to the JAX package's train() at n_shards=2, metrics.jsonl
    written once, by rank 0."""
    from ycnr_tpu.data.dataset import load_dataset as jload
    from ycnr_tpu.train.loop import train as jtrain
    from ycnr_tpu_torch.data.dataset import load_dataset
    from ycnr_tpu_torch.train.loop import train

    cfg = _train_cfg("als")
    ds = load_dataset(cfg.data, rank_hint=5)
    jr = jtrain(cfg, jload(cfg.data, rank_hint=5), out_dir=str(tmp_path / "j"))
    tr = train(cfg, ds, out_dir=str(tmp_path / "t"), device="cpu")
    np.testing.assert_allclose(tr.rmse_history, jr.rmse_history, rtol=0,
                               atol=1e-9)
    for a, b in zip(tr.state, jr.state):
        assert a.dtype == torch.float64
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-9,
                                   atol=1e-9)
    te = _events(tmp_path / "t" / "metrics.jsonl")
    assert te == _events(tmp_path / "j" / "metrics.jsonl")
    assert [e["epoch"] for e in te] == [1, 2, 3]
    assert (tmp_path / "t" / "ckpt" / "manifest.json").exists()
