"""The port's hyperparameter sweep (``ycnr_tpu_torch/train/tune.py``) on
the CPU: the cases of ``tests/test_tune.py`` but the sharded ones. Every
entry equals a standalone port ``train()`` at its seed and hyperparameters;
ALS/iALS sweeps (no random draws) equal the JAX package's ``tune`` entry
for entry in float64 at 1e-9; SGD and BPR sweeps, on the same explicit
draws in both packages, equal the JAX package's ``train()`` (which its own
tests hold to its sweep)."""

import dataclasses

import numpy as np
import pytest
import torch

from ycnr_tpu.data.dataset import load_dataset
from ycnr_tpu.train.loop import train as jtrain
from ycnr_tpu.train.tune import tune as jtune
from ycnr_tpu_torch.config import get_preset
from ycnr_tpu_torch.train.loop import train as ttrain
from ycnr_tpu_torch.train.tune import tune

from test_torch_train import explicit_draws  # noqa: F401

torch.set_num_threads(1)


def _cfg(algo="als", **data_kw):
    base = {"als": "ml100k-als", "ials": "ml20m-ials"}[algo]
    cfg = get_preset(base)
    dkw = dict(source="synthetic", n_users=150, n_items=300,
               n_ratings=6000, chunk_len=16)
    dkw.update(data_kw)
    p = dataclasses.replace(getattr(cfg, algo), dtype="float64")
    return dataclasses.replace(
        cfg, out_dir=None, data=dataclasses.replace(cfg.data, **dkw),
        **{algo: p})


def _sgd_cfg():
    cfg = get_preset("ml1m-sgd")
    return dataclasses.replace(
        cfg, out_dir=None,
        data=dataclasses.replace(cfg.data, source="synthetic", n_users=150,
                                 n_items=300, n_ratings=6000),
        sgd=dataclasses.replace(cfg.sgd, batch_size=512, method="stream",
                                dtype="float64"))


def _bpr_cfg():
    cfg = dataclasses.replace(_cfg("als"), algorithm="bpr", topn=5)
    return dataclasses.replace(
        cfg, bpr=dataclasses.replace(cfg.bpr, rank=6, batch_size=512,
                                     dtype="float64"))


def _solo(cfg, ds, entry, epochs, **params):
    algo = cfg.algorithm
    p = dataclasses.replace(getattr(cfg, algo), lam=entry["lam"],
                            epochs=epochs, **params)
    return ttrain(dataclasses.replace(cfg, seed=entry["seed"], **{algo: p}),
                  dataset=ds, out_dir=None, device="cpu")


def test_tune_matches_standalone_train_and_jax():
    cfg = _cfg("als")
    ds = load_dataset(cfg.data, rank_hint=cfg.als.rank)
    res = tune(cfg, lams=[0.02, 0.05, 0.2], seeds=[0, 1], epochs=3,
               dataset=ds, device="cpu")
    assert len(res.leaderboard) == 6
    finals = [e["rmse_final"] for e in res.leaderboard]
    assert finals == sorted(finals)
    assert res.best == res.leaderboard[0]
    # every entry reproduces a standalone train() of its (lam, seed)
    for entry in res.leaderboard:
        solo = _solo(cfg, ds, entry, 3)
        assert entry["rmse"] == [round(x, 6) for x in solo.rmse_history]
        if entry is res.best:
            assert torch.equal(res.best_state.U, solo.state.U)
    ref = jtune(cfg, lams=[0.02, 0.05, 0.2], seeds=[0, 1], epochs=3,
                dataset=ds)
    assert res.leaderboard == ref.leaderboard
    np.testing.assert_allclose(res.best_state.U.numpy(),
                               np.asarray(ref.best_state.U), rtol=1e-9,
                               atol=1e-9)


def test_tune_ials_ranks_by_hit_rate():
    cfg = dataclasses.replace(_cfg("ials"), topn=5)
    ds = load_dataset(cfg.data, rank_hint=cfg.ials.rank)
    res = tune(cfg, lams=[0.05, 0.5], alphas=[10.0, 40.0], seeds=[0],
               epochs=2, dataset=ds, device="cpu")
    assert len(res.leaderboard) == 4
    hits = [e["hit_rate"] for e in res.leaderboard]
    assert hits == sorted(hits, reverse=True)
    assert all("alpha" in e and len(e["rmse"]) == 2
               for e in res.leaderboard)
    assert res.best_state.U.shape[0] == cfg.data.n_users + 1
    ref = jtune(cfg, lams=[0.05, 0.5], alphas=[10.0, 40.0], seeds=[0],
                epochs=2, dataset=ds)
    assert res.leaderboard == ref.leaderboard
    # the winner reproduces as a standalone iALS train() at its alpha
    solo = _solo(cfg, ds, res.best, 2, alpha=res.best["alpha"])
    assert res.best["rmse"] == [round(x, 6) for x in solo.rmse_history]


def test_tune_sgd_matches_standalone_stream_train():
    cfg = _sgd_cfg()
    ds = load_dataset(cfg.data, rank_hint=cfg.sgd.rank)
    res = tune(cfg, lams=[0.02, 0.1], lrs=[0.005, 0.02],
               seeds=[cfg.seed], epochs=3, dataset=ds, device="cpu")
    assert len(res.leaderboard) == 4
    assert all("lr" in e for e in res.leaderboard)
    finals = [e["rmse_final"] for e in res.leaderboard]
    assert finals == sorted(finals)
    for entry in res.leaderboard:
        solo = _solo(cfg, ds, entry, 3, lr=entry["lr"])
        assert entry["rmse"] == [round(x, 6) for x in solo.rmse_history]


def test_tune_sgd_on_explicit_draws_equals_jax_train(
        explicit_draws):  # noqa: F811
    cfg = _sgd_cfg()
    ds = load_dataset(cfg.data, rank_hint=cfg.sgd.rank)
    res = tune(cfg, lams=[0.02, 0.1], lrs=[0.01], seeds=[cfg.seed],
               epochs=2, dataset=ds, device="cpu")
    for entry in res.leaderboard:
        j = jtrain(dataclasses.replace(cfg, sgd=dataclasses.replace(
            cfg.sgd, lam=entry["lam"], lr=entry["lr"], epochs=2)), ds,
            out_dir=None)
        np.testing.assert_allclose(entry["rmse"], j.rmse_history, rtol=0,
                                   atol=1e-6)  # the entry is rounded


def test_tune_bpr_matches_standalone_train():
    """Trajectories per (lam, lr, seed) reproduce a standalone BPR
    train(); entries carry auc + hit_rate, ranked by hit_rate."""
    cfg = _bpr_cfg()
    ds = load_dataset(cfg.data, rank_hint=6)
    res = tune(cfg, lams=[0.005, 0.05], lrs=[0.05, 0.15], seeds=[0, 3],
               epochs=3, dataset=ds, device="cpu")
    assert len(res.leaderboard) == 8
    hits = [e["hit_rate"] for e in res.leaderboard]
    assert hits == sorted(hits, reverse=True)
    assert all(len(e["auc"]) == 3 and 0.0 <= e["auc_final"] <= 1.0
               for e in res.leaderboard)
    best = res.best
    solo = _solo(cfg, ds, best, 3, lr=best["lr"])
    assert torch.equal(res.best_state.U, solo.state.U)
    assert torch.equal(res.best_state.bi, solo.state.bi)
    # every entry, seeds other than cfg.seed included
    for entry in res.leaderboard:
        s = _solo(cfg, ds, entry, 3, lr=entry["lr"])
        assert entry["hit_rate"] == round(1.0 - s.rmse_history[-1], 4)


def test_tune_bpr_on_explicit_draws_equals_jax(explicit_draws):  # noqa: F811
    """The same draws in both packages: each entry's final hit rate equals
    the JAX package's train() at its config, and the AUC triples are the
    reference's draws."""
    import importlib

    jt = importlib.import_module("ycnr_tpu.train.tune")
    tt = importlib.import_module("ycnr_tpu_torch.train.tune")

    cfg = _bpr_cfg()
    ds = load_dataset(cfg.data, rank_hint=6)
    for a, b in zip(tt._bpr_eval_triples(ds, 5), jt._bpr_eval_triples(ds, 5)):
        np.testing.assert_array_equal(a, np.asarray(b))
    res = tune(cfg, lams=[0.005, 0.05], lrs=[0.1], seeds=[0, 3], epochs=2,
               dataset=ds, device="cpu")
    for entry in res.leaderboard:
        j = jtrain(dataclasses.replace(cfg, seed=entry["seed"],
                                       bpr=dataclasses.replace(
                                           cfg.bpr, lam=entry["lam"],
                                           lr=entry["lr"], epochs=2)),
                   ds, out_dir=None)
        assert entry["hit_rate"] == round(1.0 - j.rmse_history[-1], 4)


def test_tune_rejects_bad_grids():
    with pytest.raises(ValueError, match="at least one lambda"):
        tune(_cfg("als"), lams=[], device="cpu")
    with pytest.raises(ValueError, match="alphas only"):
        tune(_cfg("als"), lams=[0.05], alphas=[10.0], device="cpu")
    with pytest.raises(ValueError, match="lrs only"):
        tune(_cfg("als"), lams=[0.05], lrs=[0.01], device="cpu")
    sgd = dataclasses.replace(_cfg("als"), algorithm="sgd")
    with pytest.raises(ValueError, match="seed axis"):
        tune(sgd, lams=[0.05], seeds=[1, 2], device="cpu")
    with pytest.raises(ValueError, match="epochs must be positive"):
        tune(_cfg("als"), lams=[0.05], epochs=0, device="cpu")


def test_tune_without_a_device_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None sweeps there")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tune(_cfg("als"), lams=[0.05])


def _sharded(cfg, D):
    return dataclasses.replace(cfg, mesh=dataclasses.replace(cfg.mesh,
                                                             n_shards=D))


@pytest.mark.parametrize("D", [2, 4])
def test_tune_sharded_equals_single_process_and_jax(D):
    """The sharded sweep on D gloo thread ranks (3 x 2 = 6 entries, padded
    to a multiple of D and dealt in contiguous slices): every rank's
    TuneResult equals the single-process sweep's, and its board the JAX
    package's sharded sweep's on a D-device mesh."""
    from ycnr_tpu_torch.parallel.mesh import run_ranks

    cfg = _cfg("als")
    ds = load_dataset(cfg.data, rank_hint=cfg.als.rank)
    grid = dict(lams=[0.02, 0.05, 0.2], seeds=[0, 1], epochs=2, dataset=ds)
    one = tune(cfg, device="cpu", **grid)
    for res in run_ranks(lambda m: tune(_sharded(cfg, D), mesh=m, **grid),
                         D):
        assert res.leaderboard == one.leaderboard and res.best == one.best
        for a, b in zip(res.best_state, one.best_state):
            assert torch.equal(a, b)
    ref = jtune(_sharded(cfg, D), **grid)
    assert one.leaderboard == ref.leaderboard


def test_tune_sharded_bpr_on_thread_ranks_equals_single_process():
    from ycnr_tpu_torch.parallel.mesh import run_ranks

    cfg = _bpr_cfg()
    ds = load_dataset(cfg.data, rank_hint=6)
    grid = dict(lams=[0.01, 0.05], lrs=[0.05], seeds=[0, 3], epochs=2,
                dataset=ds)
    one = tune(cfg, device="cpu", **grid)
    got = run_ranks(lambda m: tune(_sharded(cfg, 2), mesh=m, **grid), 2)
    assert all(r.leaderboard == one.leaderboard for r in got)
    assert torch.equal(got[1].best_state.V, one.best_state.V)


def test_tune_sharded_mesh_must_match_n_shards():
    from ycnr_tpu_torch.parallel.mesh import run_ranks

    cfg = _sharded(_cfg("als"), 4)
    with pytest.raises(ValueError, match="n_shards = 4, the mesh has 2"):
        run_ranks(lambda m: tune(cfg, lams=[0.05], mesh=m), 2)
