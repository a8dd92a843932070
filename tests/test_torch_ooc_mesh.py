"""The port's sharded out-of-core ALS-WR / iALS
(``ycnr_tpu_torch.parallel.ooc_mesh``) on D gloo thread ranks on the CPU,
against ``ycnr_tpu.parallel.ooc_mesh`` on a D-device mesh of the JAX
conftest's fake CPU devices and against the port's single-GPU out-of-core
epoch: the same float64 inputs and start factors, U and V within 1e-9
after two epochs (torch and XLA sum in other orders; the item slots also
sum in another order than on one device, since the item views index local
user rows). Within the port the streamed tier equals the pinned one bit
for bit, and a rank reads no other rank's rows of the stacked host wire.
``train(ooc=True)`` at n_shards 2 and 4 is held to the JAX package's."""

import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ycnr_tpu.models.base import state_from_numpy as jstate_from_numpy
from ycnr_tpu.parallel import ooc_mesh as jom
from ycnr_tpu.parallel.mesh import make_mesh as jmake_mesh
from ycnr_tpu.parallel.shard import gather_state as jgather
from ycnr_tpu.parallel.shard import scatter_state as jscatter
from ycnr_tpu_torch.data.synthetic import synthetic_ratings
from ycnr_tpu_torch.models import ooc as tooc
from ycnr_tpu_torch.models.base import state_from_numpy
from ycnr_tpu_torch.ops.packed import build_packed
from ycnr_tpu_torch.parallel import ooc_mesh as tom
from ycnr_tpu_torch.parallel import shard as tsh
from ycnr_tpu_torch.parallel.mesh import run_ranks

torch.set_num_threads(1)

NU, NI, K = 401, 157, 8
# small blocks: every group spans several, so each rank holds some and a
# slice ends in padding blocks where NB % D != 0
BUILD = dict(rank_hint=8, max_groups=4, target_bytes=1 << 14)
LAM, ALPHA = 0.05, 20.0
TOL = dict(rtol=0, atol=1e-9)


@pytest.fixture(scope="module")
def coo():
    """12,000 ratings; users 392-400 and items 153-156 hold none (cold)."""
    u, i, r = synthetic_ratings(NU, NI, 12_000, true_rank=4, noise=0.2,
                                seed=3)[:3]
    keep = (u < NU - 9) & (i < NI - 4)
    return u[keep], i[keep], r[keep]


@pytest.fixture(scope="module")
def start(coo):
    """Start factors (padded, float64): cold rows 0, as train() starts."""
    u, i, _ = coo
    rng = np.random.default_rng(0)
    U = np.zeros((NU + 1, K))
    V = np.zeros((NI + 1, K))
    U[:NU] = rng.normal(0, 0.1, (NU, K))
    V[:NI] = rng.normal(0, 0.1, (NI, K))
    U[np.bincount(u, minlength=NU + 1) == 0] = 0
    V[np.bincount(i, minlength=NI + 1) == 0] = 0
    return U, V


def port_state(start):
    return state_from_numpy(*start, np.zeros(NU + 1), np.zeros(NI + 1), 0.0,
                            device="cpu", dtype=torch.float64)


def port_sharded(coo, start, D, alpha=None, epochs=2, tier="pinned",
                 wire=None, **kw):
    """The port's sharded epochs on D thread ranks from ``start``: every
    rank's gathered (U, V) and its local trash-row U as NumPy."""
    sw, meta = wire or tom.build_sharded_wire(*coo, NU, NI, D, **BUILD)

    def rank(m):
        st = tsh.scatter_state(port_state(start), meta, m)
        if tier == "pinned":
            ep = tom.make_sharded_ooc_epoch(m, tom.put_sharded_wire(sw, m),
                                            LAM, alpha=alpha, **kw)
            for _ in range(epochs):
                st = ep(st)
        else:
            ep = tom.make_sharded_ooc_epoch(m, None, LAM, alpha=alpha,
                                            wire_as_args=True, **kw)
            for _ in range(epochs):  # fed again every epoch
                st = ep(st, tom.feed_sharded_wire(sw, m))
        g = tsh.gather_state(st, meta, m)
        return g.U.numpy(), g.V.numpy(), st.U[-1].numpy()

    return run_ranks(rank, D)


def jax_sharded(coo, start, D, alpha=None, epochs=2):
    mesh = jmake_mesh(D)
    sw, meta = jom.build_sharded_wire(*coo, NU, NI, D, **BUILD)
    sw = jom.put_sharded_wire(sw, mesh)
    st = jscatter(jstate_from_numpy(start[0][:NU], start[1][:NI],
                                    dtype=jnp.float64), meta, mesh)
    ep = jom.make_sharded_ooc_epoch(mesh, sw, LAM, alpha=alpha,
                                    dtype=jnp.float64)
    for _ in range(epochs):
        st = ep(st)
    g = jgather(st, meta)
    return np.asarray(g.U), np.asarray(g.V)


def single_gpu(coo, start, alpha=None, epochs=2):
    u, i, r = coo
    ug = build_packed(u, i, r, NU, NI, **BUILD)
    ig = build_packed(i, u, r, NI, NU, **BUILD)
    st = port_state(start)
    for _ in range(epochs):
        st = (tooc.als_epoch_ooc(st, ug, ig, LAM) if alpha is None
              else tooc.ials_epoch_ooc(st, ug, ig, LAM, alpha))
    return st.U.numpy(), st.V.numpy()


def assert_close(got, want):
    np.testing.assert_allclose(got[0], want[0], **TOL)
    np.testing.assert_allclose(got[1], want[1], **TOL)


def test_slices_hold_padding_blocks(coo):
    """The shapes the suite runs: NB % D != 0 for D = 3 and 4 (a slice
    ends in padding blocks: cnt 0, eid 2**31 - 2), and every rank holds
    users."""
    for D in (3, 4):
        sw, _ = tom.build_sharded_wire(*coo, NU, NI, D, **BUILD)
        pads = [g.eid[:, :, 0] == 2**31 - 2 for g in sw.ugroups]
        assert any(p.any() for p in pads)
        assert all(g.cnt[p].sum() == 0 for g, p in zip(sw.ugroups, pads))
        # every rank solves some users
        assert all(any((g.eid[d] < NU).any() for g in sw.ugroups)
                   for d in range(D))


@pytest.mark.parametrize("D,alpha", [(1, None), (2, None), (4, None),
                                     (2, ALPHA), (4, ALPHA)])
def test_epochs_match_jax(coo, start, D, alpha):
    got = port_sharded(coo, start, D, alpha)
    want = jax_sharded(coo, start, D, alpha)
    for res in got:
        assert_close(res, want)


@pytest.mark.parametrize("D,alpha,split", [
    (1, None, False), (2, None, False), (3, None, False), (4, None, False),
    (2, ALPHA, False), (3, ALPHA, False), (3, None, True), (2, ALPHA, True)])
def test_epochs_match_single_gpu(coo, start, D, alpha, split, monkeypatch):
    """Against the port's single-GPU out-of-core epoch (itself bitwise the
    resident one). ``split``: the gathers sub-chunked (rows and rating
    axis) in both, the item phase's normal equations through
    ``gather_normal_eq``'s split path."""
    if split:
        monkeypatch.setattr(tooc, "_GATHER_CHUNK_BYTES", 2048)
    assert_close(port_sharded(coo, start, D, alpha)[0],
                 single_gpu(coo, start, alpha))


@pytest.mark.parametrize("D,alpha,cb", [(2, None, 1), (3, None, 2),
                                        (3, ALPHA, 1)])
def test_streamed_equals_pinned_bitwise(coo, start, D, alpha, cb):
    """The streamed tier (host slice re-fed every epoch, chunks of ``cb``
    blocks through ChunkStream) gives the pinned tier's bits."""
    pinned = port_sharded(coo, start, D, alpha)
    streamed = port_sharded(coo, start, D, alpha, tier="streamed",
                            chunk_blocks=cb)
    for a, b in zip(pinned, streamed):
        for x, y in zip(a, b):
            assert np.array_equal(x, y)


def _poisoned(sw, D, keep):
    """A copy of the stacked wire whose rows of every rank but ``keep``
    hold NaN ratings and saturated ints."""
    def poison(a):
        a = np.array(a)
        bad = [d for d in range(D) if d != keep]
        if a.dtype.kind == "f":
            a[bad] = np.nan
        else:
            a[bad] = np.iinfo(a.dtype).max
        return a

    def groups(gs):
        return tuple(g._replace(**{n: poison(getattr(g, n))
                                   for n in tom._WIRE}) for g in gs)

    return sw._replace(ugroups=groups(sw.ugroups),
                       igroups=groups(sw.igroups),
                       inv_local=poison(sw.inv_local))


@pytest.mark.parametrize("D", [2, 4])
def test_a_rank_reads_only_its_own_rows(coo, start, D):
    """Each rank gets a host wire whose rows of every other rank are
    poisoned; both tiers still give the clean run's bits (the counterpart
    of the JAX package's multi-process locality check)."""
    sw, meta = tom.build_sharded_wire(*coo, NU, NI, D, **BUILD)
    want = port_sharded(coo, start, D, wire=(sw, meta))[0]
    for tier in ("pinned", "streamed"):
        def rank(m):
            bad = _poisoned(sw, D, m.rank)
            st = tsh.scatter_state(port_state(start), meta, m)
            if tier == "pinned":
                ep = tom.make_sharded_ooc_epoch(
                    m, tom.put_sharded_wire(bad, m), LAM)
                for _ in range(2):
                    st = ep(st)
            else:
                ep = tom.make_sharded_ooc_epoch(m, None, LAM,
                                                wire_as_args=True,
                                                chunk_blocks=1)
                for _ in range(2):
                    st = ep(st, tom.feed_sharded_wire(bad, m))
            g = tsh.gather_state(st, meta, m)
            return g.U.numpy(), g.V.numpy()

        for got in run_ranks(rank, D):
            assert np.array_equal(got[0], want[0])
            assert np.array_equal(got[1], want[1])


@pytest.mark.parametrize("D,alpha", [(3, None), (4, ALPHA)])
def test_cold_and_trash_rows_stay_zero(coo, start, D, alpha):
    u, i, _ = coo
    cold_u = np.nonzero(np.bincount(u, minlength=NU) == 0)[0]
    cold_i = np.nonzero(np.bincount(i, minlength=NI) == 0)[0]
    assert len(cold_u) == 9 and len(cold_i) == 4
    for U, V, trash in port_sharded(coo, start, D, alpha, epochs=1):
        assert not U[cold_u].any() and not V[cold_i].any()
        assert not U[NU].any() and not V[NI].any() and not trash.any()
        assert np.abs(U).max() > 0.1


@pytest.mark.parametrize("alpha", [None, ALPHA])
def test_bf16_gathers_have_no_size_cap(coo, start, alpha, monkeypatch):
    """As the mesh reference, the bf16 gather copy has no size cap: with
    the single-GPU phase's cap at one byte (where that phase then gathers
    in float64) a bf16 mesh epoch keeps its bits, and differs from the
    float64-gather epoch."""
    f64 = port_sharded(coo, start, 2, alpha)[0]
    bf16 = port_sharded(coo, start, 2, alpha, gather_bf16=True)[0]
    monkeypatch.setattr(tooc, "_BF16_COPY_MAX_BYTES", 1)
    capped = port_sharded(coo, start, 2, alpha, gather_bf16=True)[0]
    assert np.array_equal(bf16[0], capped[0])
    assert np.array_equal(bf16[1], capped[1])
    assert np.abs(bf16[1] - f64[1]).max() > 1e-6


# ---- train(ooc=True) on a mesh ---------------------------------------------

def _train_cfg(algo="als", D=2, epochs=3, **kw):
    from ycnr_tpu_torch.config import MeshConfig, get_preset

    cfg = get_preset("ml100k-als" if algo == "als" else "ml20m-ials")
    p = dataclasses.replace(getattr(cfg, algo), dtype="float64",
                            epochs=epochs, rank=5)
    return dataclasses.replace(
        cfg, out_dir=None, topn=5, mesh=MeshConfig(n_shards=D), ooc=True,
        data=dataclasses.replace(cfg.data, source="synthetic", n_users=90,
                                 n_items=60, n_ratings=3000, chunk_len=8,
                                 max_groups=4),
        **{algo: p}, **kw)


def _events(path):
    drop = ("t", "epoch_s")
    with open(path) as f:
        return [{k: v for k, v in json.loads(x).items() if k not in drop}
                for x in f]


@pytest.mark.parametrize("algo,D", [("als", 2), ("als", 4), ("ials", 2),
                                    ("ials", 4)])
def test_train_on_thread_ranks_matches_jax(tmp_path, algo, D):
    """train(cfg, mesh=) with ooc=True against the JAX package's train():
    RMSE history and final factors to 1e-9, the same metrics records
    (``ooc_residency`` with this rank's pinned bytes, ``shards`` and
    ``ooc`` on every epoch line, ``serving_metric_skipped``), the same
    checkpoints."""
    from ycnr_tpu.data.dataset import load_dataset as jload
    from ycnr_tpu.train.loop import train as jtrain
    from ycnr_tpu_torch.data.dataset import load_dataset
    from ycnr_tpu_torch.train.loop import train

    cfg = _train_cfg(algo, D, measure_serving=True)
    ds = load_dataset(cfg.data, rank_hint=5)
    jr = jtrain(cfg, jload(cfg.data, rank_hint=5), out_dir=str(tmp_path / "j"))
    got = run_ranks(lambda m: train(cfg, ds, out_dir=str(tmp_path / "t"),
                                    mesh=m), D)
    for res in got:
        np.testing.assert_allclose(res.rmse_history, jr.rmse_history, **TOL)
        for a, b in zip(res.state, jr.state):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
        assert not res.state.U[-1].any() and not res.state.V[-1].any()
    te, je = _events(tmp_path / "t" / "metrics.jsonl"), \
        _events(tmp_path / "j" / "metrics.jsonl")
    assert te == je
    res_ev = [e for e in te if e.get("event") == "ooc_residency"]
    assert len(res_ev) == 1 and res_ev[0]["mesh_shards"] == D
    assert res_ev[0]["hbm_pinned_bytes"] > 0
    assert res_ev[0]["streamed_bytes"] == 0
    lines = [e for e in te if "rmse_test" in e]
    assert len(lines) == 3
    assert all(e["shards"] == D and e["ooc"] is True for e in lines)
    assert any(e.get("event") == "serving_metric_skipped" for e in te)
    assert sorted(p.name for p in (tmp_path / "t" / "ckpt").iterdir()) == \
        sorted(p.name for p in (tmp_path / "j" / "ckpt").iterdir())


def test_train_resumes_from_a_sharded_ooc_checkpoint(tmp_path):
    """A 2-epoch sharded out-of-core run resumed for a third epoch equals
    the uninterrupted run."""
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
    assert res.rmse_history[:2] == [round(x, 6) for x in
                                    full.rmse_history[:2]]
    assert res.rmse_history[2] == full.rmse_history[2]
    assert torch.equal(res.state.U, full.state.U)
    assert torch.equal(res.state.V, full.state.V)
    assert any(e.get("event") == "resume"
               for e in _events(tmp_path / "r" / "metrics.jsonl"))


def test_ranks_of_one_process_group_share_one_out(tmp_path, monkeypatch):
    """Inside a process group (no mesh given) with one shared out dir:
    rank 0 alone writes the metrics and the checkpoints, and the run
    equals the one on a given mesh."""
    import importlib
    import threading

    import torch.distributed as dist

    from ycnr_tpu_torch.data.dataset import load_dataset
    from ycnr_tpu_torch.train.loop import train

    pmesh = importlib.import_module("ycnr_tpu_torch.parallel.mesh")
    tsharded = importlib.import_module("ycnr_tpu_torch.train.sharded")
    cfg = _train_cfg("ials")
    ds = load_dataset(cfg.data, rank_hint=5)
    want = run_ranks(lambda m: train(cfg, ds, out_dir=str(tmp_path / "m"),
                                     mesh=m), 2)[0]
    local, lock, calls = threading.local(), threading.Lock(), []
    save = tsharded.save_checkpoint

    def save_checkpoint(*a, **kw):
        with lock:
            calls.append((a[2], local.mesh.rank))
        return save(*a, **kw)

    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(pmesh, "make_mesh", lambda D, device=None:
                        local.mesh)
    monkeypatch.setattr(tsharded, "save_checkpoint", save_checkpoint)

    def rank(m):
        local.mesh = m
        return train(cfg, ds, out_dir=str(tmp_path / "g"))

    for res in run_ranks(rank, 2):
        assert res.rmse_history == want.rmse_history
        assert torch.equal(res.state.U, want.state.U)
    assert sorted(calls) == [(1, 0), (2, 0), (3, 0)]
    assert _events(tmp_path / "g" / "metrics.jsonl") == \
        _events(tmp_path / "m" / "metrics.jsonl")


def test_train_launches_rank_processes_with_the_wire(tmp_path):
    """train(cfg) outside any process group builds the wire once, hands it
    to two gloo rank processes in the .npy set and returns the gathered
    result, equal to the thread ranks' run (each building its own
    wire)."""
    from ycnr_tpu_torch.data.dataset import load_dataset
    from ycnr_tpu_torch.train.loop import train

    cfg = _train_cfg("als")
    ds = load_dataset(cfg.data, rank_hint=5)
    want = run_ranks(lambda m: train(cfg, ds, out_dir=str(tmp_path / "m"),
                                     mesh=m), 2)[0]
    got = train(cfg, ds, out_dir=str(tmp_path / "p"), device="cpu")
    assert got.rmse_history == want.rmse_history
    for a, b in zip(got.state, want.state):
        assert torch.equal(a, b)
    assert _events(tmp_path / "p" / "metrics.jsonl") == \
        _events(tmp_path / "m" / "metrics.jsonl")


def test_split_and_join_wire_round_trip(coo):
    sw, _ = tom.build_sharded_wire(*coo, NU, NI, 3, **BUILD)
    skel, arrays = tom.split_wire(sw)
    assert all(isinstance(k, str) for k in arrays)
    back = tom.join_wire(skel, arrays)
    for a, b in zip(sw.ugroups + sw.igroups, back.ugroups + back.igroups):
        assert a.R == b.R and a.rating_kind == b.rating_kind
        for n in tom._WIRE:
            assert getattr(a, n) is getattr(b, n)
    assert back.inv_local is sw.inv_local and back.u_off is sw.u_off


def test_mixed_rating_kinds_train_as_raw(coo, start):
    """Rank 0's users rate off the half-star grid: its item view alone
    would ship raw float32 ratings, the other ranks' int8 half-stars. The
    stack forces raw everywhere (int8 codes promoted beside float32 would
    double the ratings), and the epochs still match one device's."""
    from ycnr_tpu_torch.ops.packed import rating_wire_kind

    u, i, r = coo
    _, meta = tom.build_sharded_wire(u, i, r, NU, NI, 3, **BUILD)
    r = np.where(np.isin(u, meta.user_map[0]), r + np.float32(0.1),
                 r).astype(np.float32)
    rank_of = meta.user_local[u] // meta.upd
    assert [rating_wire_kind(r[rank_of == d]) for d in range(3)] == \
        ["raw", "half", "half"]
    sw, meta = tom.build_sharded_wire(u, i, r, NU, NI, 3, **BUILD)
    assert {g.rating_kind for g in sw.igroups} == {"raw"}
    assert all(g.rat.dtype == np.float32 for g in sw.igroups)
    got = port_sharded((u, i, r), start, 3, wire=(sw, meta))[0]
    assert_close(got, single_gpu((u, i, r), start))
