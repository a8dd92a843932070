"""The port's command line (``python -m ycnr_tpu_torch``) on the CPU: the
cases of ``tests/test_cli.py``, each held to ``ycnr_tpu.cli.main`` on the
same store. The JAX package runs with ``--platform cpu``, the port with
``--device cpu``. Runs train in float64 (a config file), so the two
packages' numbers agree to the printed digit; a checkpoint written by one
package's ``train`` is read by the other's ``validate``, ``recommend``,
``serve`` and ``export``. Shared-memory segments hold float32: ``publish`` /
``recommend --shm`` are held to ``recommend --ckpt`` on a float32
checkpoint. Where the JAX package needs its shm libraries, they are built
from its sources into a temporary directory. ``train --shards 2`` runs two gloo rank
processes and equals the JAX package's sharded ``train``. ``train --ooc``
(out of core) is held to the resident ``train`` and to ``ycnr_tpu.cli``'s
``--ooc``, and ``train --ooc --shards 4`` to both too."""

import ctypes
import io
import json
import os
import socket
import subprocess
import sys
import uuid

import numpy as np
import pytest
import torch

from ycnr_tpu import native as jnative
from ycnr_tpu.cli import main as jmain
from ycnr_tpu_torch.cli import main as tmain
from ycnr_tpu_torch.native import get_cache_lib, get_shm_lib
from test_torch_shm import build_jax_library

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

torch.set_num_threads(1)

F64 = {"als": {"dtype": "float64"}, "ials": {"dtype": "float64"},
       "sgd": {"dtype": "float64"}, "bpr": {"dtype": "float64"}}


@pytest.fixture(autouse=True)
def _no_compile_cache(monkeypatch):
    monkeypatch.setenv("YCNR_COMPILE_CACHE", "")


def _lines(capsys):
    return [json.loads(line) for line in
            capsys.readouterr().out.strip().splitlines()]


def jrun(capsys, *argv, platform=True):
    jmain(list(argv) + (["--platform", "cpu"] if platform else []))
    return _lines(capsys)


def trun(capsys, *argv, device=True):
    tmain(list(argv) + (["--device", "cpu"] if device else []))
    return _lines(capsys)


def _f64(tmp, extra=None):
    path = os.path.join(str(tmp), "f64.json")
    with open(path, "w") as f:
        json.dump({**F64, **(extra or {})}, f)
    return path


def _metrics(run_dir):
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        return [json.loads(x) for x in f]


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """One store, and the same float64 ALS run trained by each package."""
    root = tmp_path_factory.mktemp("cli")
    store = str(root / "store")
    tmain(["prepare", "--source", "synthetic", "--store", store,
           "--users", "120", "--items", "60", "--ratings", "3000"])
    cfg = _f64(root)
    common = ["train", "--preset", "ml100k-als", "--store", store,
              "--epochs", "3", "--rank", "6", "--config", cfg]
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("YCNR_COMPILE_CACHE", "")
        jmain(common + ["--out", str(root / "j"), "--platform", "cpu"])
    tmain(common + ["--out", str(root / "t"), "--device", "cpu"])
    return dict(store=store, root=root,
                j=str(root / "j" / "ml100k-als" / "ckpt"),
                t=str(root / "t" / "ml100k-als" / "ckpt"))


def test_empty_store_is_loud(tmp_path):
    with pytest.raises(SystemExit, match="does not exist"):
        tmain(["train", "--preset", "ml100k-als", "--store",
               str(tmp_path / "nowhere"), "--out", str(tmp_path / "o"),
               "--device", "cpu"])
    assert not (tmp_path / "nowhere").exists()
    empty = tmp_path / "prepared_but_empty"
    empty.mkdir()
    with pytest.raises(SystemExit, match="is empty"):
        tmain(["train", "--preset", "ml100k-als", "--store", str(empty),
               "--out", str(tmp_path / "o"), "--device", "cpu"])


@pytest.mark.parametrize("calibrated", [False, True])
def test_prepare_matches_jax(tmp_path, capsys, calibrated):
    flags = ["--users", "50", "--items", "20", "--ratings", "400"] + (
        ["--calibrated"] if calibrated else [])
    t = trun(capsys, "prepare", "--source", "synthetic", "--store",
             str(tmp_path / "t"), *flags, device=False)[-1]
    j = jrun(capsys, "prepare", "--source", "synthetic", "--store",
             str(tmp_path / "j"), *flags, platform=False)[-1]
    assert t["n_users"] == 50 and t["rows"] > 0
    assert {**t, "store": 0} == {**j, "store": 0}
    from ycnr_tpu_torch.data.store import RatingsStore

    a = RatingsStore(str(tmp_path / "t"))
    b = RatingsStore(str(tmp_path / "j"))
    for x, y in zip(a.read_all() + (a.read_ts(),),
                    b.read_all() + (b.read_ts(),)):
        np.testing.assert_array_equal(x, y)


def test_train_and_metrics_match_jax(trained):
    t = _metrics(os.path.dirname(trained["t"]))
    j = _metrics(os.path.dirname(trained["j"]))
    assert [r["epoch"] for r in t] == [1, 2, 3]
    assert t[-1]["rmse_test"] < t[0]["rmse_test"]  # training works
    for a, b in zip(t, j):
        assert a["rmse_test"] == b["rmse_test"]
        assert a["rmse_train"] == b["rmse_train"]


@pytest.mark.parametrize("ckpt", ["t", "j"])
def test_validate_ranking_matches_jax(trained, capsys, ckpt):
    """Each package's validate on each package's checkpoint: the same
    RMSE and ranking metrics (novelty and coverage aside: they read the
    order of tied masked tail items)."""
    argv = ["validate", "--ckpt", trained[ckpt], "--store", trained["store"],
            "--ranking"]
    t = trun(capsys, *argv)[-1]
    j = jrun(capsys, *argv)[-1]
    assert t["epoch"] == 3 and t["rmse_test"] == j["rmse_test"]
    keys = {"hit_rate", "precision", "recall", "ndcg", "map"}
    assert set(t["ranking"]) >= keys
    assert {k: t["ranking"][k] for k in keys} == \
        {k: j["ranking"][k] for k in keys}


@pytest.mark.parametrize("ckpt", ["t", "j"])
def test_validate_hit_rate_reads_either_checkpoint(trained, capsys, ckpt):
    argv = ["validate", "--ckpt", trained[ckpt], "--store", trained["store"],
            "--hit-rate", "-n", "5"]
    assert trun(capsys, *argv)[-1] == jrun(capsys, *argv)[-1]


@pytest.mark.parametrize("ckpt", ["t", "j"])
def test_recommend_trained_and_cold_match_jax(trained, capsys, ckpt):
    base = ["recommend", "--ckpt", trained[ckpt], "--store",
            trained["store"]]
    t = trun(capsys, *base, "--user", "0", "3", "-n", "5")
    assert [r["user"] for r in t] == [0, 3]
    assert all(len(r["items"]) == 5 for r in t)
    assert t == jrun(capsys, *base, "--user", "0", "3", "-n", "5")
    cold = trun(capsys, *base, "--rated", "2:5.0,7:4.0", "-n", "5")[-1]
    assert cold["user"] == "cold" and len(cold["items"]) == 5
    assert not {2, 7} & set(cold["items"])  # own ratings masked
    assert cold == jrun(capsys, *base, "--rated", "2:5.0,7:4.0", "-n",
                        "5")[-1]


def test_recommend_requires_a_checkpoint(trained):
    with pytest.raises(SystemExit):
        tmain(["recommend", "--store", trained["store"], "--user", "0",
               "--device", "cpu"])


def test_recommend_predict_matches_jax(trained, capsys):
    base = ["recommend", "--ckpt", trained["t"], "--store", trained["store"]]
    outs = trun(capsys, *base, "--user", "3", "7", "--predict", "1,2,5")
    assert [o["user"] for o in outs] == [3, 7]
    for o in outs:
        assert o["items"] == [1, 2, 5] and len(o["scores"]) == 3
        assert all(np.isfinite(s) for s in o["scores"])
    assert outs == jrun(capsys, *base, "--user", "3", "7", "--predict",
                        "1,2,5")
    with pytest.raises(SystemExit):  # --predict needs --user
        tmain(base + ["--predict", "1,2", "--device", "cpu"])


def test_recommend_similar_matches_jax(trained, capsys):
    base = ["recommend", "--ckpt", trained["t"], "--store", trained["store"],
            "--similar", "4", "9", "999", "-n", "4"]
    t = trun(capsys, *base)
    assert len(t) == 3 and len(t[0]["similar"]) == 4 and "error" in t[2]
    assert t == jrun(capsys, *base)


def test_export_matches_jax(trained, tmp_path, capsys):
    t = trun(capsys, "export", "--ckpt", trained["t"], "--store",
             trained["store"], "--out", str(tmp_path / "t.npz"))[-1]
    j = jrun(capsys, "export", "--ckpt", trained["t"], "--store",
             trained["store"], "--out", str(tmp_path / "j.npz"))[-1]
    assert {**t, "out": 0} == {**j, "out": 0}
    assert t["id_space"] == "dense"
    zt, zj = np.load(tmp_path / "t.npz"), np.load(tmp_path / "j.npz")
    assert zt["U"].shape == (t["users"], t["rank"])
    assert sorted(zt.files) == sorted(zj.files)
    for k in zt.files:
        np.testing.assert_array_equal(zt[k], zj[k])


def test_recommend_exclude_matches_jax(trained, capsys):
    base = ["recommend", "--ckpt", trained["t"], "--store", trained["store"],
            "--user", "3", "-n", "5"]
    first = trun(capsys, *base)[-1]["items"]
    excl = f"{first[0]},{first[1]}"
    out = trun(capsys, *base, "--exclude", excl)[-1]["items"]
    assert first[0] not in out and first[1] not in out and len(out) == 5
    assert out == jrun(capsys, *base, "--exclude", excl)[-1]["items"]
    with pytest.raises(SystemExit):  # unknown catalog id is loud
        tmain(base + ["--exclude", "99999", "--device", "cpu"])
    with pytest.raises(SystemExit):  # unsupported combination is loud
        tmain(["recommend", "--ckpt", trained["t"], "--store",
               trained["store"], "--popular", "--exclude", "1",
               "--device", "cpu"])


@pytest.mark.parametrize("scorer,excl", [("exact", None),
                                         ("exact", "0,1,2"),
                                         ("fused", None)])
def test_recommend_all_jsonl_matches_jax(trained, tmp_path, capsys, scorer,
                                         excl):
    """--all: top-n for every rated user, masked and id-complete, the same
    rows as the JAX package's (on the CPU a catalog too small for the
    fused scorer is served exact by both)."""
    flags = ["recommend", "--ckpt", trained["t"], "--store",
             trained["store"], "--all", "-n", "5", "--scorer", scorer] + (
        ["--exclude", excl] if excl else [])
    assert trun(capsys, *flags, "--save", str(tmp_path / "t.jsonl"))[-1][
        "event"] == "recommend_all"
    jrun(capsys, *flags, "--save", str(tmp_path / "j.jsonl"))
    rows = [json.loads(x) for x in open(tmp_path / "t.jsonl")]
    assert rows == [json.loads(x) for x in open(tmp_path / "j.jsonl")]
    from ycnr_tpu_torch.data.store import RatingsStore

    u, i, _ = RatingsStore(trained["store"]).read_all()
    assert len(rows) > 50
    blocked = {0, 1, 2} if excl else set()
    for r in rows:
        rated = set(i[u == r["user"]].tolist())
        assert not (set(r["items"]) & (rated | blocked))
        assert len(r["items"]) <= 5


def test_recommend_popular_needs_no_factors(trained, capsys):
    argv = ["recommend", "--store", trained["store"], "--popular", "-n",
            "5"]
    out = trun(capsys, *argv, device=False)[-1]
    assert len(out["popular"]) == 5
    assert out == jrun(capsys, *argv, platform=False)[-1]


def test_train_bpr_e2e(tmp_path, capsys):
    """BPR end-to-end: train logs hit_rate (not rmse), the final ranking
    suite runs, and the checkpoint serves top-N; the same lines and
    records as the JAX package's (the draws differ, the values are not
    compared)."""
    store = str(tmp_path / "s")
    tmain(["prepare", "--source", "synthetic", "--store", store,
           "--users", "80", "--items", "50", "--ratings", "2000"])
    capsys.readouterr()
    argv = ["train", "--preset", "ml100k-als", "--algorithm", "bpr",
            "--store", store, "--epochs", "4", "--rank", "6"]
    t = trun(capsys, *argv, "--out", str(tmp_path / "t"))[-1]
    j = jrun(capsys, *argv, "--out", str(tmp_path / "j"))[-1]
    assert "final_hit_rate" in t and set(t) == set(j)
    recs = _metrics(tmp_path / "t" / "ml100k-als")
    epochs = [o for o in recs if "hit_rate" in o and "epoch" in o]
    assert len(epochs) == 4 and all("rmse_test" not in o for o in epochs)
    assert any(o.get("event") == "ranking" for o in recs)
    rec = trun(capsys, "recommend", "--ckpt",
               str(tmp_path / "t" / "ml100k-als" / "ckpt"), "--store",
               store, "--user", "1", "-n", "4")[-1]
    assert 1 <= len(rec["items"]) <= 4


def test_presets_list_matches_jax(capsys):
    tmain(["presets"])
    out = capsys.readouterr().out
    for name in ("ml100k-als", "ml1m-sgd", "ml20m-als", "ml20m-ials",
                 "netflix-sharded"):
        assert name in out
    jmain(["presets"])
    assert out == capsys.readouterr().out


def test_config_file_layering(tmp_path, capsys):
    """--config JSON layers over the preset; explicit flags still win."""
    cfgfile = tmp_path / "c.json"
    cfgfile.write_text(json.dumps({
        "algorithm": "als",
        "als": {"rank": 7, "lam": 0.09},
        "data": {"source": "synthetic", "n_users": 60, "n_items": 30,
                 "n_ratings": 700, "chunk_len": 8},
    }))
    rec = trun(capsys, "train", "--preset", "ml100k-als", "--config",
               str(cfgfile), "--epochs", "2", "--out",
               str(tmp_path / "runs"))[-1]
    assert rec["epochs"] == 2  # flag won over preset epochs
    ck = json.load(open(tmp_path / "runs/ml100k-als/ckpt/manifest.json"))
    assert ck["rank"] == 7 and ck["n_users"] == 60  # file keys applied
    assert ck["config"]["als"]["lam"] == 0.09


def test_config_file_preset_and_out_dir_honored(tmp_path, capsys):
    """Without an explicit --preset/--out, the config file's own 'preset'
    and 'out_dir' keys win."""
    cfgfile = tmp_path / "c.json"
    cfgfile.write_text(json.dumps({
        "preset": "ml1m-sgd",
        "out_dir": str(tmp_path / "from_file"),
        "sgd": {"epochs": 2, "rank": 4},
        "data": {"source": "synthetic", "n_users": 40, "n_items": 20,
                 "n_ratings": 300, "chunk_len": 8},
    }))
    rec = trun(capsys, "train", "--config", str(cfgfile))[-1]
    assert rec["algorithm"] == "sgd"  # file's preset selected the base
    assert rec["out_dir"].startswith(str(tmp_path / "from_file"))


def test_unsupported_source_extension_is_loud(tmp_path):
    with pytest.raises(SystemExit, match="unsupported extension"):
        tmain(["train", "--source", str(tmp_path / "x.tsv"),
               "--out", str(tmp_path / "o"), "--device", "cpu"])


def test_movielens_import_roundtrip_matches_jax(tmp_path, capsys):
    """Original (sparse) dataset ids survive prepare -> train ->
    recommend, as in the JAX package."""
    csv = tmp_path / "r.csv"
    rows = ["userId,movieId,rating,timestamp"]
    rng = np.random.default_rng(0)
    for u in range(10, 40):
        for i in rng.choice([100, 205, 333, 410, 555, 608, 777], 4,
                            replace=False):
            rows.append(f"{u},{i},{rng.integers(1, 6)}.0,1")
    csv.write_text("\n".join(rows) + "\n")
    store = str(tmp_path / "s")
    assert trun(capsys, "prepare", "--source", str(csv), "--store", store,
                device=False)[-1]["id_maps"]
    cfg = _f64(tmp_path)
    argv = ["train", "--preset", "ml100k-als", "--store", store,
            "--epochs", "2", "--rank", "4", "--config", cfg]
    trun(capsys, *argv, "--out", str(tmp_path / "t"))
    jrun(capsys, *argv, "--out", str(tmp_path / "j"))
    got = []
    for pkg, run in (("t", trun), ("j", jrun)):
        got.append(run(capsys, "recommend", "--ckpt",
                       str(tmp_path / pkg / "ml100k-als" / "ckpt"),
                       "--store", store, "--user", "12", "-n", "3")[-1])
    assert got[0]["user"] == 12
    assert set(got[0]["items"]) <= {100, 205, 333, 410, 555, 608, 777}
    assert got[0] == got[1]


def test_train_profile_writes_a_trace(trained, tmp_path, capsys):
    prof = tmp_path / "prof"
    rec = trun(capsys, "train", "--preset", "ml100k-als", "--store",
               trained["store"], "--epochs", "1", "--rank", "6", "--out",
               str(tmp_path / "o"), "--profile", str(prof))[-1]
    assert rec["epochs"] == 1
    traces = os.listdir(prof)
    assert traces and json.load(open(prof / traces[0]))["traceEvents"]


def test_train_fused_epochs_flag(trained, tmp_path, capsys):
    """--fused-epochs K: records marked fused=K as the JAX package's."""
    argv = ["train", "--preset", "ml100k-als", "--store", trained["store"],
            "--epochs", "4", "--rank", "6", "--fused-epochs", "2",
            "--config", _f64(tmp_path)]
    trun(capsys, *argv, "--out", str(tmp_path / "t"))
    jrun(capsys, *argv, "--out", str(tmp_path / "j"))
    t = _metrics(tmp_path / "t" / "ml100k-als")
    j = _metrics(tmp_path / "j" / "ml100k-als")
    assert [(r["epoch"], r["fused"], r["rmse_test"]) for r in t] == \
        [(r["epoch"], r["fused"], r["rmse_test"]) for r in j]


@pytest.mark.parametrize("flags", [
    [], ["--ooc-wire", "rect"], ["--ooc-residency", "host"],
    ["--ooc-wire", "rect", "--ooc-residency", "device"]])
def test_train_ooc_matches_resident(trained, tmp_path, capsys, flags):
    """--ooc trains from the rating wire (pinned or streamed, packed or
    RECT) with the same math: its RMSE list equals the port's resident
    train's and the JAX package's --ooc run's, and the residency event is
    the reference's."""
    argv = ["train", "--preset", "ml100k-als", "--store", trained["store"],
            "--ooc", "--epochs", "3", "--rank", "6", "--config",
            _f64(tmp_path), *flags]
    trun(capsys, *argv, "--out", str(tmp_path / "t"))
    jrun(capsys, *argv, "--out", str(tmp_path / "j"))
    t = _metrics(tmp_path / "t" / "ml100k-als")
    j = _metrics(tmp_path / "j" / "ml100k-als")
    res = _metrics(os.path.dirname(trained["t"]))
    rmse = [r["rmse_test"] for r in t if "rmse_test" in r]
    assert rmse == [r["rmse_test"] for r in res if "rmse_test" in r]
    assert rmse == [r["rmse_test"] for r in j if "rmse_test" in r]
    ev = [r for r in t if r.get("event") == "ooc_residency"]
    jev = [r for r in j if r.get("event") == "ooc_residency"]
    assert [(r["hbm_pinned_bytes"], r["streamed_bytes"]) for r in ev] == \
        [(r["hbm_pinned_bytes"], r["streamed_bytes"]) for r in jev]
    assert len(ev) == (0 if "host" in flags else 1)


def test_train_ooc_rejects_batched_sgd(trained, tmp_path):
    with pytest.raises(ValueError, match="als/ials"):
        tmain(["train", "--preset", "ml1m-sgd", "--store", trained["store"],
               "--ooc", "--epochs", "1", "--out", str(tmp_path / "o"),
               "--device", "cpu"])


def _epoch_lines(run_dir):
    drop = ("t", "epoch_s")
    return [{k: v for k, v in r.items() if k not in drop}
            for r in _metrics(run_dir)]


def test_train_ooc_sharded_matches_resident_and_jax(trained, tmp_path,
                                                     capsys):
    """``train --ooc --shards 4`` (four gloo rank processes, the wire
    sliced across them): ``shards=4, ooc=true`` on every epoch line, the
    RMSE trajectory of the resident run within 2e-4 (the item Grams sum
    over the ranks in another order), and the metrics and printed result
    of ``ycnr_tpu.cli``'s ``train --ooc --shards 4`` on the same store."""
    common = ["train", "--preset", "ml100k-als", "--store",
              trained["store"], "--ooc", "--shards", "4", "--epochs", "3",
              "--rank", "6", "--config", _f64(tmp_path)]
    t = trun(capsys, *common, "--out", str(tmp_path / "t"))[-1]
    j = jrun(capsys, *common, "--out", str(tmp_path / "j"))[-1]
    assert {**t, "out_dir": 0, "final_rmse": 0} == \
        {**j, "out_dir": 0, "final_rmse": 0}
    assert abs(t["final_rmse"] - j["final_rmse"]) < 1e-9
    tm = _epoch_lines(tmp_path / "t" / "ml100k-als")
    assert tm == _epoch_lines(tmp_path / "j" / "ml100k-als")
    lines = [r for r in tm if "rmse_test" in r]
    assert [(r["shards"], r["ooc"]) for r in lines] == [(4, True)] * 3
    res = [r["rmse_test"] for r in _metrics(os.path.dirname(trained["t"]))
           if "rmse_test" in r]
    assert [r["rmse_test"] for r in lines] == pytest.approx(res, abs=2e-4)


def test_config_file_ooc_on_a_mesh_trains(trained, tmp_path, capsys):
    """A config file's ``"ooc": true`` with ``"mesh": {"n_shards": 2}``
    trains out of core on two ranks, as ``ycnr_tpu.cli`` does."""
    cfg = _f64(tmp_path, {"ooc": True, "mesh": {"n_shards": 2}})
    common = ["train", "--preset", "ml100k-als", "--store",
              trained["store"], "--epochs", "2", "--rank", "6", "--config",
              cfg]
    trun(capsys, *common, "--out", str(tmp_path / "t"))
    jrun(capsys, *common, "--out", str(tmp_path / "j"))
    tm = _epoch_lines(tmp_path / "t" / "ml100k-als")
    assert tm == _epoch_lines(tmp_path / "j" / "ml100k-als")
    assert [(r["shards"], r["ooc"]) for r in tm if "rmse_test" in r] == \
        [(2, True)] * 2


def test_train_sharded_matches_jax(trained, tmp_path, capsys):
    """``train --shards 2 --dist-backend gloo --device cpu``: two rank
    processes over gloo. The metrics (``shards=2`` on every epoch line)
    and the printed result equal ``ycnr_tpu.cli``'s ``train --shards 2``
    on the same store, and each package's ``validate`` reads the sharded
    checkpoint."""
    common = ["train", "--preset", "ml100k-als", "--store",
              trained["store"], "--epochs", "3", "--rank", "6", "--config",
              _f64(tmp_path), "--shards", "2"]
    j = jrun(capsys, *common, "--out", str(tmp_path / "j"))[-1]
    t = trun(capsys, *common, "--dist-backend", "gloo", "--out",
             str(tmp_path / "t"))[-1]
    assert {**t, "out_dir": 0, "final_rmse": 0} == \
        {**j, "out_dir": 0, "final_rmse": 0}
    assert abs(t["final_rmse"] - j["final_rmse"]) < 1e-9  # sum order
    drop = ("t", "epoch_s")
    tm, jm = (
        [{k: v for k, v in r.items() if k not in drop} for r in
         _metrics(str(tmp_path / p / "ml100k-als"))] for p in ("t", "j"))
    assert tm == jm and [r["shards"] for r in tm] == [2, 2, 2]
    ckpt = str(tmp_path / "t" / "ml100k-als" / "ckpt")
    argv = ["validate", "--ckpt", ckpt, "--store", trained["store"]]
    got = trun(capsys, *argv)[-1]
    assert got == jrun(capsys, *argv)[-1] and got["epoch"] == 3


def test_distributed_flags_join_the_group(monkeypatch, capsys):
    """``train --coordinator h:99 --num-processes 2 --process-id 1``
    reaches init_process_group as tcp://h:99, world 2, rank 1, over the
    named backend, and prints the reference's distributed event."""
    import torch.distributed as dist

    calls = {}
    monkeypatch.setattr(dist, "init_process_group",
                        lambda backend, **kw: calls.update(backend=backend,
                                                           **kw))
    monkeypatch.setattr(dist, "get_rank", lambda *a, **k: 1)
    with pytest.raises(BaseException):
        # stops after the join: an unknown preset
        tmain(["train", "--coordinator", "h:99", "--num-processes", "2",
               "--process-id", "1", "--preset", "nope", "--device", "cpu"])
    assert calls == {"backend": "gloo", "init_method": "tcp://h:99",
                     "world_size": 2, "rank": 1}
    event = json.loads(capsys.readouterr().out.strip().splitlines()[0])
    assert event == {"event": "distributed", "process_id": 1}


@pytest.mark.parametrize("argv", [
    ["train", "--epochs", "1"],
    ["validate", "--ckpt", "c", "--store", "s"],
    ["export", "--ckpt", "c", "--out", "x.npz"],
    ["serve", "--ckpt", "c", "--store", "s"],
    ["serve", "--shm", "/x", "--store", "s", "--listen", "127.0.0.1:0"],
    ["publish", "--ckpt", "c", "--shm", "/x"],
])
def test_default_device_needs_cuda(argv, monkeypatch):
    """Without --device the commands run on the card; with none they stop
    with a message and never serve or train on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="--device cpu"):
        tmain(argv)


# --- tune (tests/test_tune.py's CLI cases) ---------------------------------

def _tune_both(tmp_path, capsys, *argv):
    cfg = _f64(tmp_path)
    t = trun(capsys, "tune", *argv, "--config", cfg, "--out",
             str(tmp_path / "t"))
    j = jrun(capsys, "tune", *argv, "--config", cfg, "--out",
             str(tmp_path / "j"))
    strip = [{k: v for k, v in e.items() if k != "out_dir"} for e in t]
    assert strip == [{k: v for k, v in e.items() if k != "out_dir"}
                     for e in j]
    return t


def test_cli_tune_ials_alphas(tmp_path, capsys):
    lines = _tune_both(tmp_path, capsys, "--algorithm", "ials", "--source",
                       "synthetic", "--users", "80", "--items", "160",
                       "--ratings", "3000", "--epochs", "2", "--rank", "5",
                       "--lams", "0.1", "--alphas", "10,40")
    best = lines[-1]
    assert best["event"] == "best" and best["alpha"] in (10.0, 40.0)
    hits = [e["hit_rate"] for e in lines[:-1]]
    assert hits == sorted(hits, reverse=True)
    man = json.load(open(f"{best['out_dir']}/ckpt/manifest.json"))
    assert man["config"]["ials"]["alpha"] == best["alpha"]


def test_cli_tune_rank_axis(tmp_path, capsys):
    lines = _tune_both(tmp_path, capsys, "--source", "synthetic", "--users",
                       "80", "--items", "160", "--ratings", "3000",
                       "--epochs", "2", "--lams", "0.05", "--ranks", "4,6")
    best = lines[-1]
    assert best["event"] == "best" and best["rank"] in (4, 6)
    assert {e["rank"] for e in lines[:-1]} == {4, 6}
    assert best["rmse_final"] == min(e["rmse_final"] for e in lines[:-1])
    man = json.load(open(f"{best['out_dir']}/ckpt/manifest.json"))
    assert man["rank"] == best["rank"]
    assert man["config"]["als"]["rank"] == best["rank"]


def test_cli_tune_saves_best_checkpoint(tmp_path, capsys):
    lines = _tune_both(tmp_path, capsys, "--source", "synthetic", "--users",
                       "100", "--items", "200", "--ratings", "4000",
                       "--epochs", "2", "--rank", "6", "--lams", "0.05,0.3",
                       "--seeds", "0")
    best = lines[-1]
    assert best["event"] == "best"
    assert best["rmse_final"] == min(x["rmse_final"] for x in lines[:-1])
    man = json.load(open(f"{best['out_dir']}/ckpt/manifest.json"))
    assert man["config"]["als"]["lam"] == best["lam"]
    assert man["config"]["seed"] == best["seed"]
    board = [json.loads(x) for x in open(f"{best['out_dir']}/tune.jsonl")]
    assert len(board) == 2
    # the best checkpoint loads and serves, in both packages
    store = str(tmp_path / "s")
    trun(capsys, "prepare", "--source", "synthetic", "--store", store,
         "--users", "100", "--items", "200", "--ratings", "4000",
         device=False)
    argv = ["recommend", "--ckpt", f"{best['out_dir']}/ckpt", "--store",
            store, "--user", "3", "-n", "4"]
    rec = trun(capsys, *argv)[-1]
    assert len(rec["items"]) == 4 and rec == jrun(capsys, *argv)[-1]


# --- publish, recommend --shm, serve, train --publish-shm -------------------

@pytest.fixture(scope="module")
def jax_lib_paths(tmp_path_factory):
    d = tmp_path_factory.mktemp("jaxlibs")
    return {stem: build_jax_library(d, stem)
            for stem in ("shm_store", "shm_cache")}


@pytest.fixture
def jax_libs(jax_lib_paths, monkeypatch):
    """The JAX package's loaders serving the libraries built above (never
    its shared build)."""
    for stem, path in jax_lib_paths.items():
        monkeypatch.setitem(jnative._libs, stem, ctypes.CDLL(path))


@pytest.fixture
def shm_names():
    names = [f"/ycnr_tcli_{uuid.uuid4().hex[:10]}{k}" for k in "abc"]
    yield names
    for name in names:
        get_shm_lib().ycnr_shm_unlink(name.encode())
        get_cache_lib().ycnr_cache_unlink(name.encode())


@pytest.fixture(scope="module")
def f32_ckpt(trained):
    """A float32 ALS checkpoint on the shared store (what a segment holds,
    so --shm and --ckpt serve the same bits)."""
    out = trained["root"] / "f32"
    tmain(["train", "--preset", "ml100k-als", "--store", trained["store"],
           "--epochs", "2", "--rank", "6", "--out", str(out), "--device",
           "cpu"])
    return str(out / "ml100k-als" / "ckpt")


_SHM_MODES = {
    "user": ["--user", "0", "3", "-n", "5"],
    "predict": ["--user", "3", "7", "--predict", "1,2,5"],
    "exclude": ["--user", "3", "-n", "5", "--exclude", "0,1,2,3,4,5"],
    "all": ["--all", "-n", "5"],
    "rated": ["--rated", "2:5.0,7:4.0", "-n", "5"],
    "similar": ["--similar", "4", "9", "-n", "4"],
}


def _same_up_to_rounding(a, b):
    """Equal JSON lines, scores within the printed rounding (two float32
    sums in different orders)."""
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert {k: v for k, v in x.items() if k != "scores"} == \
            {k: v for k, v in y.items() if k != "scores"}
        np.testing.assert_allclose(x.get("scores", []), y.get("scores", []),
                                   rtol=0, atol=1.01e-4)


@pytest.mark.parametrize("mode", sorted(_SHM_MODES))
def test_publish_then_recommend_shm(trained, f32_ckpt, capsys, shm_names,
                                    jax_libs, mode):
    """publish prints the checkpoint's epoch; recommend --shm in every
    mode equals recommend --ckpt of the same checkpoint, and the JAX
    package's recommend --shm on its own publish of that checkpoint."""
    tname, jname, _ = shm_names
    out = trun(capsys, "publish", "--ckpt", f32_ckpt, "--shm", tname)[-1]
    assert out == {"shm": tname, "ckpt": f32_ckpt, "epoch": 2}
    assert jrun(capsys, "publish", "--ckpt", f32_ckpt, "--shm", jname,
                platform=False)[-1]["epoch"] == 2
    argv = ["recommend", "--store", trained["store"], *_SHM_MODES[mode]]
    via_shm = trun(capsys, *argv, "--shm", tname)
    assert via_shm and all("error" not in x for x in via_shm)
    assert via_shm == trun(capsys, *argv, "--ckpt", f32_ckpt)
    _same_up_to_rounding(via_shm, jrun(capsys, *argv, "--shm", jname))


def _serve_lines(capsys, run, argv, lines):
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr("sys.stdin", io.StringIO("".join(f"{x}\n"
                                                    for x in lines)))
        return run(capsys, "serve", *argv)


_SERVE_REQUESTS = ["stats", "1", "batch:1,2,40", "cold:2:5.0,7:4.0",
                   "predict:1:2,5", "exclude:1:0,1,2,3", "similar:3",
                   "similar:3:dot", "popular", "nonsense", "99999"]


def _strip_stats(lines):
    keep = ("event", "epoch", "users", "items", "n", "source")
    return [{k: v for k, v in x.items() if k in keep}
            if x.get("event") == "stats" else
            ({"error": True} if "error" in x else x) for x in lines]


@pytest.mark.parametrize("ckpt", ["t", "j"])
def test_serve_stdin_matches_jax(trained, capsys, ckpt):
    """serve: the ready line and one answer a request line, equal to the
    JAX package's serve on the same store and checkpoint (stats: its
    epoch, dims and source)."""
    argv = ["--ckpt", trained[ckpt], "--store", trained["store"], "-n", "4"]
    t = _serve_lines(capsys, trun, argv, _SERVE_REQUESTS)
    j = _serve_lines(capsys, jrun, argv, _SERVE_REQUESTS)
    assert t[0] == {"event": "ready", "users": 120, "items": 60}
    assert len(t) == len(_SERVE_REQUESTS) + 1
    assert t[1]["epoch"] == 3 and t[1]["source"] == "ckpt"
    assert "error" in t[-2] and "error" in t[-1]
    assert _strip_stats(t) == _strip_stats(j)


def test_serve_listen_matches_jax(trained, capsys):
    """serve --listen: the same protocol over TCP from a second process,
    the same answers as the JAX package's serve over stdin."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "ycnr_tpu_torch", "serve", "--ckpt",
         trained["t"], "--store", trained["store"], "-n", "4", "--device",
         "cpu", "--listen", "127.0.0.1:0"],
        stdout=subprocess.PIPE, text=True, cwd=REPO,
        env=dict(os.environ, PYTHONPATH=REPO))
    try:
        ready = json.loads(proc.stdout.readline())
        port = int(ready["listen"].rsplit(":", 1)[1])
        with socket.create_connection(("127.0.0.1", port), timeout=60) as s:
            s.sendall("".join(f"{x}\n" for x in _SERVE_REQUESTS).encode())
            s.shutdown(socket.SHUT_WR)
            got = [json.loads(x) for x in s.makefile().read().splitlines()]
    finally:
        proc.kill()
        proc.wait()
    want = _serve_lines(capsys, jrun, ["--ckpt", trained["t"], "--store",
                                       trained["store"], "-n", "4"],
                        _SERVE_REQUESTS)
    assert {k: v for k, v in ready.items() if k != "listen"} == want[0]
    assert _strip_stats(got) == _strip_stats(want[1:])


def test_serve_shm_hot_reload_and_shared_cache(trained, f32_ckpt, capsys,
                                               shm_names, jax_libs):
    """serve --shm --shm-cache: stats report the published epoch and the
    shm source; a computed list lands in the shared cache, where a second
    serve (and the JAX package's ShmRecCache) finds it; --precompute fills
    the cache for every rated user."""
    from ycnr_tpu.serve.cache import ShmRecCache as JCache

    name, cache, _ = shm_names
    trun(capsys, "publish", "--ckpt", f32_ckpt, "--shm", name)
    argv = ["--shm", name, "--store", trained["store"], "-n", "4",
            "--shm-cache", cache]
    first = _serve_lines(capsys, trun, argv, ["stats", "1"])
    assert first[1]["epoch"] == 2 and first[1]["source"] == "shm"
    with JCache(cache, epoch=3) as c:  # entries carry epoch + 1
        hit = c.get((1, 4))
    assert hit is not None and hit.tolist() == first[2]["items"]
    again = _serve_lines(capsys, trun, argv + ["--precompute"], ["1"])
    assert again[0]["precomputed"] == 120
    assert again[1] == first[2]


def test_train_publish_shm_matches_jax(trained, tmp_path, capsys, shm_names,
                                       jax_libs):
    """train --publish-shm leaves the last epoch's factors in the segment,
    as the JAX package's train --publish-shm does from the same float64
    run (float32 in the segment)."""
    from ycnr_tpu_torch.serve.shm import FactorShmReader

    tname, jname, _ = shm_names
    argv = ["train", "--preset", "ml100k-als", "--store", trained["store"],
            "--epochs", "2", "--rank", "5", "--config", _f64(tmp_path)]
    trun(capsys, *argv, "--out", str(tmp_path / "t"), "--publish-shm", tname)
    jrun(capsys, *argv, "--out", str(tmp_path / "j"), "--publish-shm", jname)
    with FactorShmReader(tname) as r:
        got, e = r.read(device="cpu")
    with FactorShmReader(jname) as r:
        want, je = r.read(device="cpu")
    assert e == je == 2
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-6)
