"""Port's single-GPU train() (run here on the CPU) vs the JAX package's
train() on tiny synthetic presets, in float64: every algorithm family,
resume across the packages, warm start, early stopping, hit rate and the
ranking event, the serving event, config files."""

import dataclasses
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ycnr_tpu import config as jconfig
from ycnr_tpu.config import (ALSConfig, DataConfig, IALSConfig, MeshConfig,
                             RunConfig)
from ycnr_tpu.data.dataset import load_dataset
from ycnr_tpu.models import bpr as jbpr
from ycnr_tpu.models import sgd as jsgd
from ycnr_tpu.models import sgd_stream as jss
from ycnr_tpu.train import checkpoint as jckpt
from ycnr_tpu.train.loop import train as jtrain
from ycnr_tpu_torch import config as tconfig
from ycnr_tpu_torch.models import bpr as tbpr
from ycnr_tpu_torch.models import sgd as tsgd
from ycnr_tpu_torch.models import sgd_stream as tss
from ycnr_tpu_torch.train import checkpoint as tckpt
from ycnr_tpu_torch.train.loop import train as ttrain

torch.set_num_threads(1)

CFG = RunConfig(
    name="tiny", algorithm="als",
    data=DataConfig(n_users=200, n_items=120, n_ratings=4000, true_rank=4,
                    seed=0, max_groups=4),
    als=ALSConfig(rank=6, lam=0.05, epochs=3, dtype="float64"),
    ials=IALSConfig(rank=6, lam=0.1, alpha=2.0, epochs=3, dtype="float64"),
    out_dir="",  # a run given no out_dir writes nothing
)


@pytest.mark.parametrize("algo", ["als", "ials"])
def test_train_rmse_history_matches_jax(tmp_path, algo):
    cfg = dataclasses.replace(CFG, algorithm=algo)
    ds = load_dataset(cfg.data, rank_hint=6)
    jr = jtrain(cfg, ds, out_dir=str(tmp_path / "j"))
    tr = ttrain(cfg, ds, out_dir=str(tmp_path / "t"), device="cpu")
    assert len(tr.rmse_history) == 3
    np.testing.assert_allclose(tr.rmse_history, jr.rmse_history, rtol=0,
                               atol=1e-9)
    # the port's final checkpoint loads in the JAX package
    st, man = jckpt.load_checkpoint(str(tmp_path / "t" / "ckpt"))
    assert man["epoch"] == 3
    np.testing.assert_allclose(np.asarray(st.U), np.asarray(jr.state.U),
                               rtol=1e-9, atol=1e-9)


def test_train_refuses_what_is_not_ported():
    """Every algorithm trains now, out of core and sharded too, and out of
    core on a mesh; what is still missing (orbax checkpoints) raises, and
    out-of-core batched SGD and BPR raise the reference's ValueError."""
    for algo in ("als", "sgd", "bpr"):
        with pytest.raises(NotImplementedError):
            ttrain(dataclasses.replace(CFG, algorithm=algo,
                                       checkpoint_backend="orbax"),
                   device="cpu")
    for algo in ("sgd", "bpr"):  # CFG's SGD is batched
        with pytest.raises(ValueError, match="als/ials"):
            ttrain(dataclasses.replace(CFG, algorithm=algo, ooc=True),
                   device="cpu")


@pytest.mark.parametrize("algo,mode,match", [
    ("sgd", "gram_psum", "on a mesh supports als/ials"),
    ("bpr", "gram_psum", "on a mesh supports als/ials"),
    ("als", "item_sharded", "item_sharded is resident-only")])
def test_ooc_on_a_mesh_raises_the_references_errors(tmp_path, algo, mode,
                                                    match):
    """Out of core on a mesh takes ALS-WR / iALS under gram_psum: the
    other cases raise the JAX package's ValueError, with its message,
    before anything is built."""
    cfg = dataclasses.replace(
        CFG, algorithm=algo, ooc=True,
        mesh=MeshConfig(n_shards=2, vstep_mode=mode),
        sgd=dataclasses.replace(CFG.sgd, method="stream"))
    ds = load_dataset(cfg.data, rank_hint=6)
    with pytest.raises(ValueError, match=match) as want:
        jtrain(cfg, ds, out_dir=str(tmp_path / "j"))
    with pytest.raises(ValueError) as got:
        ttrain(cfg, ds, device="cpu")
    assert str(got.value) == str(want.value)


def test_train_without_a_device_needs_cuda():
    """device=None means CUDA; without a card it raises instead of
    training on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None trains there")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ttrain(CFG)


# --- SGD (batched and stream), BPR, resume, warm start, early stopping -----

SMALL = DataConfig(n_users=150, n_items=240, n_ratings=3000, true_rank=3,
                   seed=1, max_groups=4)


def _preset(name, epochs=3, **kw):
    """A preset of the port cut to a tiny synthetic set, float64. The
    configs of the two packages are field for field the same, so one object
    drives both ``train()``s."""
    cfg = tconfig.get_preset(name)
    algo = cfg.algorithm
    params = dataclasses.replace(getattr(cfg, algo), **{
        **dict(rank=5, epochs=epochs, batch_size=256, dtype="float64"),
        **kw.pop("params", {})})
    return cfg.replace(data=SMALL, out_dir="", **{algo: params}, **kw)


def _perm(seed, epoch, n):
    return np.random.default_rng([seed, epoch, n]).permutation(n)


def _negs(seed, epoch, n, n_items):
    return np.random.default_rng([seed, epoch, 7]).integers(
        0, n_items, n).astype(np.int32)


@pytest.fixture
def explicit_draws(monkeypatch):
    """Replace every trainer's per-epoch draws, in both packages, by the
    same NumPy draws (jax.random and torch.Generator cannot agree), so the
    two ``train()``s walk one trajectory."""
    def j_sgd(self, state, data, e, perm=None):
        perm = _perm(self.seed, e, data.u.shape[0])
        return jsgd.sgd_epoch(state, data, jnp.asarray(perm), self.lam,
                              self.lr_at(e), self.batch_size, self.grad_mode)

    def j_stream(self, state, d, e):
        order = _perm(self.seed, e, d.ul.shape[0])
        return jss.sgd_stream_epoch(state, d.ul, d.ib, d.rb, d.wu, d.wi,
                                    d.u_lo, jnp.asarray(order), self.lam,
                                    self.lr_at(e), d.tile)

    j_bpr0 = jbpr.BPRTrainer.epoch

    def bpr_draws(self, state, data):
        n_pad = data.u.shape[0]
        n_perm = (n_pad // self.batch_size if self.shuffle == "batches"
                  else n_pad)
        return n_pad, n_perm

    def j_bpr(self, state, data, e, perm=None, negs=None):
        n_pad, n_perm = bpr_draws(self, state, data)
        return j_bpr0(self, state, data, e,
                      jnp.asarray(_perm(self.seed, e, n_perm)),
                      jnp.asarray(_negs(self.seed, e, n_pad, state.n_items)))

    t_sgd0, t_stream0, t_bpr0 = (tsgd.BiasedSGD.epoch, tss.StreamSGD.epoch,
                                 tbpr.BPRTrainer.epoch)

    def t_sgd(self, state, data, e, perm=None):
        return t_sgd0(self, state, data, e,
                      _perm(self.seed, e, data.u.shape[0]))

    def t_stream(self, state, d, e, order=None):
        return t_stream0(self, state, d, e,
                         _perm(self.seed, e, d.ul.shape[0]))

    def t_bpr(self, state, data, e, perm=None, negs=None):
        n_pad, n_perm = bpr_draws(self, state, data)
        return t_bpr0(self, state, data, e, _perm(self.seed, e, n_perm),
                      _negs(self.seed, e, n_pad, state.n_items))

    monkeypatch.setattr(jsgd.BiasedSGD, "epoch", j_sgd)
    monkeypatch.setattr(jss.StreamSGD, "epoch", j_stream)
    monkeypatch.setattr(jbpr.BPRTrainer, "epoch", j_bpr)
    monkeypatch.setattr(tsgd.BiasedSGD, "epoch", t_sgd)
    monkeypatch.setattr(tss.StreamSGD, "epoch", t_stream)
    monkeypatch.setattr(tbpr.BPRTrainer, "epoch", t_bpr)


def _cases():
    sgd = _preset("ml1m-sgd")
    bpr = _preset("ml20m-bpr", params=dict(lr=0.1))
    return {
        "sgd": sgd,
        "sgd-mean": sgd.replace(sgd=dataclasses.replace(sgd.sgd,
                                                        grad_mode="mean")),
        "sgd-stream": sgd.replace(sgd=dataclasses.replace(sgd.sgd,
                                                          method="stream")),
        "sgd-stream-mean": sgd.replace(sgd=dataclasses.replace(
            sgd.sgd, method="stream", grad_mode="mean")),
        "bpr-batches-emean": bpr,
        "bpr-rows-sum": bpr.replace(bpr=dataclasses.replace(
            bpr.bpr, shuffle="rows", grad_mode="sum")),
    }


def _events(out_dir):
    with open(os.path.join(out_dir, "metrics.jsonl")) as f:
        return [json.loads(x) for x in f]


@pytest.mark.parametrize("case", sorted(_cases()))
def test_train_sgd_bpr_history_matches_jax(tmp_path, explicit_draws, case):
    """RMSE (1 - hit rate for BPR) history within 1e-6 of the JAX
    package's, final factors within 1e-9, from a preset at reduced size."""
    cfg = _cases()[case]
    ds = load_dataset(cfg.data, rank_hint=5)
    jr = jtrain(cfg, ds, out_dir=str(tmp_path / "j"))
    tr = ttrain(cfg, ds, out_dir=str(tmp_path / "t"), device="cpu")
    assert len(tr.rmse_history) == 3
    np.testing.assert_allclose(tr.rmse_history, jr.rmse_history, rtol=0,
                               atol=1e-6)
    for a, b in zip(jr.state, tr.state):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-9,
                                   atol=1e-12)
    for x in tr.state[:4]:
        assert bool((x[-1] == 0).all())  # trash rows stay zero
    je, te = _events(tmp_path / "j"), _events(tmp_path / "t")
    drop = ("t", "epoch_s")
    strip = [[{k: v for k, v in e.items() if k not in drop} for e in ev]
             for ev in (je, te)]
    assert strip[0] == strip[1]  # the same records, event for event
    if cfg.algorithm == "bpr":
        assert te[-1]["event"] == "ranking" and te[0]["algo"] == "bpr"
        assert all(np.isfinite(v) for v in te[-1].values()
                   if not isinstance(v, str))
        assert float(tr.state.mu) == 0.0 and not bool(tr.state.bu.any())
    else:
        assert float(tr.state.mu) == pytest.approx(ds.mu)  # SGD only


@pytest.mark.parametrize("method", ["batched", "stream"])
def test_train_sgd_free_running_tracks_jax_within_a_band(method):
    """With each package's own draws the trajectories differ; the final
    held-out RMSE agrees within the 0.02 band of the JAX package's
    tests/test_sgd_stream.py."""
    cfg = _preset("ml1m-sgd", epochs=8, params=dict(lr=0.03, method=method,
                                                    dtype="float32"),
                  checkpoint_every=0)
    cfg = cfg.replace(data=dataclasses.replace(
        SMALL, n_users=600, n_items=200, n_ratings=30_000))
    ds = load_dataset(cfg.data, rank_hint=5)
    jr = jtrain(cfg, ds, out_dir=None)
    tr = ttrain(cfg, ds, out_dir=None, device="cpu")
    assert tr.rmse_history[-1] < tr.rmse_history[0] - 0.02
    assert abs(tr.rmse_history[-1] - jr.rmse_history[-1]) < 0.02


@pytest.mark.parametrize("first,second", [("jax", "torch"), ("torch", "jax"),
                                          ("torch", "torch")])
@pytest.mark.parametrize("algo", ["sgd", "bpr"])
def test_resume_crosses_the_packages(tmp_path, explicit_draws, algo, first,
                                     second):
    """Two epochs checkpointed by one package, resumed to four by the other:
    the same factors (1e-9) and history as four epochs in one go; the
    manifest carries the history, metrics.jsonl is appended to."""
    run = {"jax": lambda *a, **k: jtrain(*a, **k),
           "torch": lambda *a, **k: ttrain(*a, device="cpu", **k)}
    cfg4 = _preset("ml1m-sgd" if algo == "sgd" else "ml20m-bpr", epochs=4,
                   checkpoint_every=2)
    params = getattr(cfg4, algo)
    cfg2 = cfg4.replace(**{algo: dataclasses.replace(params, epochs=2)})
    ds = load_dataset(cfg4.data, rank_hint=5)
    out = str(tmp_path / "run")
    part = run[first](cfg2, ds, out_dir=out)
    whole = run[second](cfg4, ds, out_dir=str(tmp_path / "whole"))
    rest = run[second](cfg4, ds, out_dir=out,
                       resume=os.path.join(out, "ckpt"))
    assert len(part.rmse_history) == 2 and len(rest.rmse_history) == 4
    np.testing.assert_allclose(rest.rmse_history, whole.rmse_history, rtol=0,
                               atol=2e-6)  # the carried half is rounded
    for a, b in zip(rest.state, whole.state):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-9,
                                   atol=1e-12)
    ev = _events(out)
    assert [e["epoch"] for e in ev if "algo" in e] == [1, 2, 3, 4]
    assert [e for e in ev if e.get("event") == "resume"][0]["epoch"] == 2
    _, man = tckpt.load_checkpoint(os.path.join(out, "ckpt"), device="cpu")
    assert man["epoch"] == 4 and len(man["extra"]["rmse_history"]) == 4
    assert man["config"] == dataclasses.asdict(cfg4)


def test_resume_is_bitwise_within_the_port(tmp_path):
    """The port's own draws depend on the seed and the epoch alone, so a
    run stopped after epoch 2 and resumed ends on the same bits."""
    cfg4 = _preset("ml1m-sgd", epochs=4, checkpoint_every=2,
                   params=dict(dtype="float32"))
    cfg2 = cfg4.replace(sgd=dataclasses.replace(cfg4.sgd, epochs=2))
    ds = load_dataset(cfg4.data, rank_hint=5)
    whole = ttrain(cfg4, ds, out_dir=None, device="cpu")
    ttrain(cfg2, ds, out_dir=str(tmp_path), device="cpu")
    rest = ttrain(cfg4, ds, out_dir=str(tmp_path), device="cpu",
                  resume=str(tmp_path / "ckpt"))
    for a, b in zip(rest.state, whole.state):
        assert torch.equal(a, b)


def _grown_pair():
    from ycnr_tpu.data.dataset import Dataset
    from ycnr_tpu.data.split import train_test_split
    from ycnr_tpu.data.synthetic import synthetic_ratings

    u, i, r = synthetic_ratings(260, 140, 9000, true_rank=3, seed=11)

    def make(sel, nu, ni):
        (tu, ti, tr), (su, si, sr) = train_test_split(u[sel], i[sel], r[sel],
                                                      0.1, seed=5)
        return Dataset(n_users=nu, n_items=ni, train_u=tu, train_i=ti,
                       train_r=tr, test_u=su, test_i=si, test_r=sr,
                       mu=float(tr.mean()), chunk_len=8, rank_hint=6)

    return make((u < 200) & (i < 100), 200, 100), make(slice(None), 260, 140)


@pytest.mark.parametrize("source", ["jax", "torch"])
def test_warm_start_onto_a_larger_catalog_matches_jax(tmp_path, source):
    """A checkpoint of either package, grown to a larger catalog
    (``grow_state``: the same rows bit for bit) and trained one epoch:
    the port's RMSE equals the JAX package's."""
    old_ds, new_ds = _grown_pair()
    cfg = dataclasses.replace(CFG, seed=3, data=dataclasses.replace(
        CFG.data, chunk_len=8))
    ckpt = str(tmp_path / "old" / "ckpt")
    if source == "jax":
        jtrain(cfg, old_ds, out_dir=str(tmp_path / "old"))
    else:
        ttrain(cfg, old_ds, out_dir=str(tmp_path / "old"), device="cpu")
    one = dataclasses.replace(cfg, als=dataclasses.replace(cfg.als, epochs=1))
    jw = jtrain(one, new_ds, warm_start=ckpt, out_dir=None)
    tw = ttrain(one, new_ds, warm_start=ckpt, out_dir=str(tmp_path / "w"),
                device="cpu")
    cold = ttrain(one, new_ds, out_dir=None, device="cpu")
    assert tw.state.n_users == 260 and tw.state.n_items == 140
    assert len(tw.rmse_history) == 1  # a new run: the epoch count restarts
    np.testing.assert_allclose(tw.rmse_history, jw.rmse_history, rtol=0,
                               atol=1e-9)
    assert tw.rmse_history[-1] <= cold.rmse_history[-1] + 1e-3
    ev = _events(tmp_path / "w")[0]
    assert (ev["event"], ev["from_epoch"], ev["new_users"],
            ev["new_items"]) == ("warm_start", 3, 60, 40)


def test_warm_start_guards(tmp_path):
    old_ds, _ = _grown_pair()
    cfg = dataclasses.replace(CFG, als=dataclasses.replace(CFG.als, epochs=1))
    ttrain(cfg, old_ds, out_dir=str(tmp_path), device="cpu")
    ckpt = str(tmp_path / "ckpt")
    with pytest.raises(ValueError, match="rank"):
        ttrain(dataclasses.replace(cfg, als=dataclasses.replace(
            cfg.als, rank=7)), old_ds, warm_start=ckpt, out_dir=None,
            device="cpu")
    with pytest.raises(ValueError, match="exclusive"):
        ttrain(cfg, old_ds, warm_start=ckpt, resume=ckpt, out_dir=None,
               device="cpu")


def test_early_stop_matches_jax(tmp_path):
    cfg = dataclasses.replace(
        CFG, als=dataclasses.replace(CFG.als, epochs=12),
        early_stop_patience=2, early_stop_min_delta=1e-3, checkpoint_every=5)
    ds = load_dataset(cfg.data, rank_hint=6)
    jr = jtrain(cfg, ds, out_dir=str(tmp_path / "j"))
    tr = ttrain(cfg, ds, out_dir=str(tmp_path / "t"), device="cpu")
    assert len(tr.rmse_history) == len(jr.rmse_history) < 12
    stop = [e for e in _events(tmp_path / "t")
            if e.get("event") == "early_stop"]
    jstop = [e for e in _events(tmp_path / "j")
             if e.get("event") == "early_stop"]
    assert len(stop) == 1 and stop[0]["epoch"] == len(tr.rmse_history)
    assert stop[0]["best_rmse"] == jstop[0]["best_rmse"]
    # the stopping epoch is checkpointed although it is no multiple of 5
    _, man = tckpt.load_checkpoint(str(tmp_path / "t" / "ckpt"), device="cpu")
    assert man["epoch"] == len(tr.rmse_history)
    # patience 0 runs every epoch
    all_ = ttrain(dataclasses.replace(cfg, early_stop_patience=0,
                                      als=dataclasses.replace(cfg.als,
                                                              epochs=4)),
                  ds, out_dir=None, device="cpu")
    assert len(all_.rmse_history) == 4


def test_early_stop_window_spans_resume(tmp_path):
    cfg = dataclasses.replace(CFG, als=dataclasses.replace(CFG.als, epochs=6),
                              checkpoint_every=6)
    ds = load_dataset(cfg.data, rank_hint=6)
    first = ttrain(cfg, ds, out_dir=str(tmp_path), device="cpu")
    rest = ttrain(dataclasses.replace(
        cfg, als=dataclasses.replace(cfg.als, epochs=20),
        early_stop_patience=2, early_stop_min_delta=1e-3), ds,
        out_dir=str(tmp_path / "r"), resume=str(tmp_path / "ckpt"),
        device="cpu")
    assert len(rest.rmse_history) < 20
    assert rest.rmse_history[:6] == [round(x, 6) for x in first.rmse_history]


@pytest.mark.parametrize("algo", ["als", "sgd"])
def test_log_hit_rate_and_ranking_event_match_jax(tmp_path, explicit_draws,
                                                  algo):
    cfg = dataclasses.replace(CFG, algorithm=algo, log_hit_rate=True,
                              sgd=dataclasses.replace(
                                  _preset("ml1m-sgd").sgd, epochs=2),
                              als=dataclasses.replace(CFG.als, epochs=2))
    ds = load_dataset(cfg.data, rank_hint=6)
    jtrain(cfg, ds, out_dir=str(tmp_path / "j"))
    ttrain(cfg, ds, out_dir=str(tmp_path / "t"), device="cpu")
    je, te = _events(tmp_path / "j"), _events(tmp_path / "t")
    assert [e["hit_rate"] for e in te[:2]] == [e["hit_rate"] for e in je[:2]]
    assert te[-1]["event"] == "ranking"
    drop = ("t",)
    assert {k: v for k, v in te[-1].items() if k not in drop} == \
        {k: v for k, v in je[-1].items() if k not in drop}


def test_measure_serving_logs_the_serving_event(tmp_path):
    cfg = dataclasses.replace(CFG, measure_serving=True, scorer="fused",
                              als=dataclasses.replace(CFG.als, epochs=1))
    ds = load_dataset(cfg.data, rank_hint=6)
    ttrain(cfg, ds, out_dir=str(tmp_path), device="cpu")
    ev = _events(tmp_path)[-1]
    assert ev["event"] == "serving" and ev["topn"] == 10
    assert ev["scorer"] == "exact"  # catalog too small for the fused select
    assert ev["users"] == len(np.unique(ds.train_u)) and ev["recs_per_s"] > 0


@pytest.mark.parametrize("scorer", ["fused", "fused32"])
def test_measure_serving_times_the_fused_scorer_when_the_catalog_allows(
        tmp_path, scorer):
    """1,400 items are enough segments for a top-10 select: the event names
    the scorer that was asked for (here through K2's plain version)."""
    cfg = dataclasses.replace(
        CFG, measure_serving=True, scorer=scorer,
        data=dataclasses.replace(CFG.data, n_users=60, n_items=1400,
                                 n_ratings=3000),
        als=dataclasses.replace(CFG.als, epochs=1))
    ds = load_dataset(cfg.data, rank_hint=6)
    ttrain(cfg, ds, out_dir=str(tmp_path), device="cpu")
    ev = _events(tmp_path)[-1]
    assert ev["event"] == "serving" and ev["scorer"] == scorer
    assert ev["users"] == len(np.unique(ds.train_u)) and ev["recs_per_s"] > 0


def test_config_dict_and_config_files_match_jax(tmp_path):
    cfg = _preset("ml20m-bpr")
    assert tckpt.config_dict(cfg) == jckpt.config_dict(cfg)
    d = {"preset": "ml1m-sgd", "seed": 4, "sgd": {"rank": 7, "method":
                                                   "stream"},
         "data": {"source": "synthetic", "n_users": 50}}
    p = tmp_path / "c.json"
    p.write_text(json.dumps(d))
    want = dataclasses.asdict(jconfig.load_config(str(p)))
    assert dataclasses.asdict(tconfig.load_config(str(p))) == want
    assert dataclasses.asdict(tconfig.config_from_dict(d)) == want
    assert want["sgd"]["rank"] == 7 and want["sgd"]["lr"] == 0.005
    base = tconfig.RunConfig(name="b")
    assert tconfig.config_from_dict({"topn": 3}, base).name == "b"
    with pytest.raises(KeyError, match="unknown config key"):
        tconfig.config_from_dict({"sdg": {}})


# --- fused_epochs: the JAX package's block boundaries ----------------------

def _ckpt_epochs(monkeypatch):
    """Record the epoch of every checkpoint either package's train()
    writes."""
    from ycnr_tpu.train import loop as jloop
    from ycnr_tpu_torch.train import loop as tloop

    seen = {"jax": [], "torch": []}
    for mod, key in ((jloop, "jax"), (tloop, "torch")):
        real = mod.save_checkpoint

        def rec(path, state, epoch, *a, _real=real, _key=key, **kw):
            seen[_key].append(epoch)
            return _real(path, state, epoch, *a, **kw)

        monkeypatch.setattr(mod, "save_checkpoint", rec)
    return seen


@pytest.mark.parametrize("algo,fused,epochs,every", [
    ("als", 2, 5, 1), ("als", 3, 7, 2), ("ials", 2, 5, 3),
    ("ials", 4, 4, 1)])
def test_fused_epochs_records_and_checkpoints_match_jax(
        tmp_path, monkeypatch, algo, fused, epochs, every):
    """fused_epochs = k: one record per epoch marked fused=k (the tail
    block's own k), the same RMSE as the per-epoch run, the iALS hit rate
    only on a block's last epoch, checkpoints only at block ends — as the
    JAX package's _fused_epoch_blocks, whose records these equal."""
    seen = _ckpt_epochs(monkeypatch)
    p = dataclasses.replace(getattr(CFG, algo), epochs=epochs)
    cfg = dataclasses.replace(CFG, algorithm=algo, fused_epochs=fused,
                              checkpoint_every=every, **{algo: p})
    ds = load_dataset(cfg.data, rank_hint=6)
    jr = jtrain(cfg, ds, out_dir=str(tmp_path / "j"))
    tr = ttrain(cfg, ds, out_dir=str(tmp_path / "t"), device="cpu")
    np.testing.assert_allclose(tr.rmse_history, jr.rmse_history, rtol=0,
                               atol=1e-9)
    per_epoch = ttrain(dataclasses.replace(cfg, fused_epochs=1), ds,
                       out_dir=None, device="cpu")
    np.testing.assert_allclose(tr.rmse_history, per_epoch.rmse_history,
                               rtol=0, atol=1e-12)
    je = [e for e in _events(tmp_path / "j") if "epoch_s" in e]
    te = [e for e in _events(tmp_path / "t") if "epoch_s" in e]
    assert [e["epoch"] for e in te] == list(range(1, epochs + 1))
    assert [e["fused"] for e in te] == [e["fused"] for e in je]
    ends = {e["epoch"] for e in te
            if e["epoch"] % fused == 0 or e["epoch"] == epochs}
    assert {e["epoch"] for e in te if "hit_rate" in e} == (
        ends if algo == "ials" else set())
    assert [e.get("hit_rate") for e in te] == [e.get("hit_rate") for e in je]
    for a, b in zip(te, je):
        assert a["rmse_train"] == pytest.approx(b["rmse_train"], abs=1e-6)
    assert seen["torch"] == seen["jax"] and set(seen["torch"]) <= ends


def test_fused_epochs_early_stop_at_a_block_end_matches_jax(tmp_path):
    """Under patience the port stops where the reference stops: at the end
    of the block in which the window closed, not at the epoch itself."""
    cfg = dataclasses.replace(
        CFG, als=dataclasses.replace(CFG.als, epochs=20), fused_epochs=4,
        early_stop_patience=2, early_stop_min_delta=1e-3, checkpoint_every=3)
    ds = load_dataset(cfg.data, rank_hint=6)
    jr = jtrain(cfg, ds, out_dir=str(tmp_path / "j"))
    tr = ttrain(cfg, ds, out_dir=str(tmp_path / "t"), device="cpu")
    per_epoch = ttrain(dataclasses.replace(cfg, fused_epochs=1), ds,
                       out_dir=None, device="cpu")
    assert len(tr.rmse_history) == len(jr.rmse_history)
    assert len(tr.rmse_history) % 4 == 0
    assert len(per_epoch.rmse_history) < len(tr.rmse_history) < 20
    stop = [e for e in _events(tmp_path / "t")
            if e.get("event") == "early_stop"]
    jstop = [e for e in _events(tmp_path / "j")
             if e.get("event") == "early_stop"]
    assert [(e["epoch"], e["best_rmse"]) for e in stop] == \
        [(e["epoch"], e["best_rmse"]) for e in jstop]
    _, man = tckpt.load_checkpoint(str(tmp_path / "t" / "ckpt"), device="cpu")
    assert man["epoch"] == len(tr.rmse_history)
    np.testing.assert_allclose(tr.state.U.numpy(), np.asarray(jr.state.U),
                               rtol=1e-9, atol=1e-9)


def test_fused_epochs_leave_sgd_and_bpr_per_epoch(tmp_path, explicit_draws):
    """fused_epochs concerns the ALS/iALS blocks only: an SGD run logs no
    'fused' field in either package."""
    cfg = dataclasses.replace(_preset("ml1m-sgd", epochs=2), fused_epochs=2)
    ds = load_dataset(cfg.data, rank_hint=cfg.sgd.rank)
    jtrain(cfg, ds, out_dir=str(tmp_path / "j"))
    ttrain(cfg, ds, out_dir=str(tmp_path / "t"), device="cpu")
    for d in ("j", "t"):
        recs = [e for e in _events(tmp_path / d) if "epoch_s" in e]
        assert len(recs) == 2 and all("fused" not in e for e in recs)
