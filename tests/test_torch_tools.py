"""The port's measuring tools on the CPU, held to the JAX package's
``tools/`` on the same inputs: ``bench_bpr_batch`` (the JAX tool's keys,
hit@10 within BPR_HIT_BAND of the JAX tool's), ``soak`` (a tiny shape for
~2 s: no error response, epochs never go back on a connection, the JAX
tool's keys), ``loadgen`` (against
one tiny store and checkpoint that both packages serve: no error, the JAX
tool's keys) and ``quality_calibrated`` (the iALS hit@N trajectory of the
JAX tool within QUALITY_TOL, BPR's rising). Each tool raises without a
card unless given ``--device cpu``, and runs with jax, the JAX package and
its tools blocked."""

import ctypes
import io
import json
import os
import subprocess
import sys
import textwrap
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

from ycnr_tpu import native as jnative
from test_torch_shm import build_jax_library

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
from tools import bench_bpr_batch as jbpr  # noqa: E402
from tools import loadgen as jloadgen  # noqa: E402
from tools import quality_calibrated as jquality  # noqa: E402
from tools import soak as jsoak  # noqa: E402

from ycnr_tpu_torch.cli import main as tcli  # noqa: E402
from ycnr_tpu_torch.tools import bench_bpr_batch as tbpr  # noqa: E402
from ycnr_tpu_torch.tools import loadgen as tloadgen  # noqa: E402
from ycnr_tpu_torch.tools import quality_calibrated as tquality  # noqa
from ycnr_tpu_torch.tools import soak as tsoak  # noqa: E402

torch.set_num_threads(1)

# iALS with bf16 gathers: the JAX package sums bf16 products in XLA's
# order, the port in its own, so a near tie at the 10th place can flip one
# or two held-out hits of the ~2,000 sampled (1 / 2,000 = 5e-4 each)
QUALITY_TOL = 1e-3
# BPR draws its negatives from each package's own generator (jax.random,
# torch), so the two hit@10 trajectories differ by the draws: at the smoke
# scale (700 users evaluated, 1 / 700 = 1.4e-3 a hit) they were within
# 5.3e-3 of each other over 4 epochs at both batch sizes
BPR_HIT_BAND = 0.02


@pytest.fixture(autouse=True)
def _env(tmp_path, monkeypatch):
    monkeypatch.setenv("YCNR_BENCH_CACHE", str(tmp_path / "cache"))
    monkeypatch.setenv("YCNR_NO_WALL_WARM", "1")
    monkeypatch.setenv("PYTHONPATH", REPO)


def _jax_lines(module, argv, monkeypatch):
    """The JSON lines the JAX tool prints for argv."""
    monkeypatch.setattr(sys, "argv", [module.__name__] + argv)
    buf = io.StringIO()
    with redirect_stdout(buf):
        module.main()
    return [json.loads(x) for x in buf.getvalue().strip().splitlines()
            if x.startswith("{")]


def _lines(capsys):
    return [json.loads(x) for x in
            capsys.readouterr().out.strip().splitlines()]


def test_bench_bpr_batch_lines(monkeypatch, capsys):
    """One line a batch size with the JAX tool's keys; hit@10 of each epoch
    within BPR_HIT_BAND of the JAX tool's at the same batch size, and
    rising in both."""
    argv = ["--scale", "smoke", "--batches", "4096", "8192", "--epochs",
            "2"]
    want = _jax_lines(jbpr, argv, monkeypatch)
    capsys.readouterr()
    got = tbpr.main(argv + ["--device", "cpu"])
    assert _lines(capsys) == got and len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert set(g) == set(w)
        assert (g["batch"], g["epochs"]) == (w["batch"], w["epochs"])
        assert len(g["hit10"]) == len(w["hit10"]) == 2
        assert all(np.isfinite(h) and 0 <= h <= 1 for h in g["hit10"])
        assert np.allclose(g["hit10"], w["hit10"], rtol=0,
                           atol=BPR_HIT_BAND), (g["hit10"], w["hit10"])
        assert g["hit10"][1] > g["hit10"][0] and \
            w["hit10"][1] > w["hit10"][0]
        assert g["first_s"] > 0 and g["steady_s"] > 0


@pytest.fixture
def jax_libs(tmp_path_factory, monkeypatch):
    """The JAX package's shm loaders serving libraries built from its
    sources into a temporary directory (never its shared build)."""
    d = tmp_path_factory.mktemp("jaxlibs")
    for stem in ("shm_store", "shm_cache"):
        monkeypatch.setitem(jnative._libs, stem,
                            ctypes.CDLL(build_jax_library(d, stem)))


def _segments():
    return {n for n in os.listdir("/dev/shm") if "soak" in n}


def test_soak_tiny(monkeypatch, capsys, jax_libs):
    """~2 s at a tiny shape with 4 clients and republishes every 0.3 s: no
    error response, no epoch going back on any connection, every segment
    unlinked, and the JAX tool's keys on both lines."""
    argv = ["--users", "300", "--items", "200", "--rank", "8", "--ratings",
            "5000", "--clients", "4"]
    before = _segments()
    # the JAX tool's keys from a run with no republish in it: its CALM
    # percentiles fail on an empty bucket, and a request that spans a
    # republish (its first ones wait for XLA) counts as STORM; its
    # publisher thread is never joined and sleeps a whole period before it
    # looks at its stop flag, so the period outlasts the test process (a
    # shorter one publishes into the closed writer later in the worker)
    want = _jax_lines(jsoak, argv + ["--duration", "1", "--republish",
                                     "86400"], monkeypatch)
    capsys.readouterr()
    got = tsoak.main(argv + ["--duration", "2", "--republish", "0.3",
                             "--device", "cpu"])
    ready, line = _lines(capsys)
    assert line == got and ready["event"] == "ready"
    assert set(ready) == set(want[0])
    assert set(want[1]) <= set(got)
    assert got["errors"] == 0 and got["epoch_regressions"] == 0
    assert got["republishes"] >= 3 and got["requests"] > 100
    assert got["server_epoch"] >= 2
    assert _segments() == before


@pytest.fixture
def store_ckpt(tmp_path):
    """A tiny store and an ALS-WR checkpoint of it (the port's `train`;
    both packages read its npz checkpoint)."""
    store, out = str(tmp_path / "store"), str(tmp_path / "runs")
    buf = io.StringIO()
    with redirect_stdout(buf):
        tcli(["prepare", "--source", "synthetic", "--store", store,
              "--users", "120", "--items", "80", "--ratings", "3000"])
        tcli(["train", "--preset", "ml100k-als", "--store", store,
              "--epochs", "1", "--rank", "4", "--device", "cpu", "--out",
              out])
    return store, os.path.join(out, "ml100k-als", "ckpt")


def test_loadgen_against_a_tiny_store(store_ckpt, monkeypatch, capsys):
    """Both load generators against the same store and checkpoint, each
    booting its package's `serve`: no error, the JAX tool's keys, every
    request answered."""
    store, ckpt = store_ckpt
    argv = ["--store", store, "--ckpt", ckpt, "--clients", "4",
            "--requests", "25"]
    want = _jax_lines(jloadgen, argv + ["--platform", "cpu"], monkeypatch)
    capsys.readouterr()
    got = tloadgen.main(argv + ["--device", "cpu"])
    assert _lines(capsys) == [got]
    assert set(got) == set(want[-1])
    assert got["errors"] == want[-1]["errors"] == 0
    assert got["requests"] == 100
    # the warm-up pass (8) and the 100 requests, all through the server
    assert got["server_latency"]["count"] == 108


def test_quality_calibrated_smoke(tmp_path, monkeypatch, capsys):
    """--scale smoke, 3 epochs: the same summary keys and ranking suite
    keys as the JAX tool; iALS (no random draws, the same NumPy start) hit@N
    within QUALITY_TOL of the JAX tool's at every epoch; BPR's rising; the
    summary file written."""
    argv = ["--scale", "smoke", "--epochs", "3"]
    want = _jax_lines(jquality, argv + ["--out", str(tmp_path / "j")],
                      monkeypatch)[-1]
    capsys.readouterr()
    got = tquality.main(argv + ["--out", str(tmp_path / "t"), "--device",
                                "cpu"])
    assert _lines(capsys) == [got]
    assert set(got) == set(want)
    res = {r["algo"]: r for r in got["results"]}
    ref = {r["algo"]: r for r in want["results"]}
    assert sorted(res) == sorted(ref) == ["bpr", "ials"]
    for a in res:
        assert set(res[a]) == set(ref[a])
        assert set(res[a]["ranking"]) == set(ref[a]["ranking"])
    assert np.allclose(res["ials"]["hit_at_n"], ref["ials"]["hit_at_n"],
                       rtol=0, atol=QUALITY_TOL)
    bpr = res["bpr"]["hit_at_n"]
    assert len(bpr) == 3 and bpr[-1] > bpr[0]
    with open(tmp_path / "t" / "quality_calibrated-smoke-r32.json") as f:
        assert json.load(f) == got


_NEEDS = {
    "bench_ooc": ["--scale", "smoke", "--probe"],
    "bench_bpr_batch": ["--scale", "smoke"],
    "soak": [],
    "loadgen": ["--store", "x"],
    "quality_calibrated": ["--scale", "smoke"],
}


@pytest.mark.parametrize("tool", sorted(_NEEDS))
def test_tool_without_a_card_raises_and_names_the_flag(tool, monkeypatch):
    import importlib

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mod = importlib.import_module(f"ycnr_tpu_torch.tools.{tool}")
    with pytest.raises(RuntimeError, match="--device cpu"):
        mod.main(_NEEDS[tool])


_BLOCKED = textwrap.dedent("""
    import runpy, sys

    class Block:
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in ("jax", "jaxlib", "orbax", "triton",
                                      "ycnr_tpu", "bench", "tools"):
                raise ImportError("blocked: " + name)

    sys.meta_path.insert(0, Block())
    sys.argv = [sys.argv[1]] + sys.argv[2:]
    runpy.run_module(sys.argv[0], run_name="__main__")
""")


@pytest.mark.parametrize("tool,argv,n_lines", [
    ("bench_ooc", ["--scale", "smoke", "--compare", "--epochs", "2",
                   "--rank", "8"], 1),
    ("bench_bpr_batch", ["--scale", "smoke", "--batches", "4096",
                         "--epochs", "1"], 1),
    ("quality_calibrated", ["--scale", "smoke", "--epochs", "1"], 1),
    ("soak", ["--users", "200", "--items", "100", "--rank", "4",
              "--ratings", "2000", "--clients", "2", "--duration", "1",
              "--republish", "0.4"], 2),
])
def test_tool_process_with_jax_blocked(tool, argv, n_lines, tmp_path):
    """python -m ycnr_tpu_torch.tools.<tool> ... --device cpu where jax, the
    JAX package, the root bench and tools/ cannot be imported: its JSON
    lines alone on stdout."""
    extra = ["--out", str(tmp_path / "q")] if tool == "quality_calibrated" \
        else []
    res = subprocess.run([sys.executable, "-c", _BLOCKED,
                          f"ycnr_tpu_torch.tools.{tool}", *argv, *extra,
                          "--device", "cpu"], cwd=str(tmp_path),
                         env=dict(os.environ), capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    lines = res.stdout.strip().splitlines()
    assert len(lines) == n_lines
    for x in lines:
        json.loads(x)


def test_cached_dataset_loads_once_and_equals_load_dataset(tmp_path,
                                                           monkeypatch):
    """quality_calibrated's dataset through the bench cache: the first call
    loads and writes it, the second reads it back without generating, and
    both equal ``load_dataset`` of the same config array for array."""
    from ycnr_tpu_torch.data import dataset as dsmod
    from ycnr_tpu_torch.tools import bench as tbench

    monkeypatch.setenv("YCNR_BENCH_CACHE", str(tmp_path / "cache"))
    data = tquality.data_config("calibrated", "smoke", 0)
    want = dsmod.load_dataset(data, rank_hint=32)
    calls = []
    real = dsmod.load_dataset
    monkeypatch.setattr(dsmod, "load_dataset",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    got = [tbench.cached_dataset(data, 32) for _ in range(2)]
    assert calls == [1]
    for ds in got:
        for k in ("train_u", "train_i", "train_r", "test_u", "test_i",
                  "test_r"):
            assert np.array_equal(getattr(ds, k), getattr(want, k))
        assert (ds.n_users, ds.n_items, ds.mu) == (want.n_users,
                                                   want.n_items, want.mu)
