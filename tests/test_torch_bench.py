"""The port's headline bench (``ycnr_tpu_torch/tools/bench.py``) on the
CPU, held to the JAX package's root ``bench.py`` on the same inputs: the
round trip of its host cache's layout blobs (the blobs themselves equal
the root bench's in ``test_torch_host_copies.py``), the cache's contract
(the ``YCNR_BENCH_CACHE`` variable, a corrupt file rebuilt, per-pid
temporary writes, tags of the port's own modules),
the held-out RMSE trajectories of ALS-WR and iALS on both layouts at
bench.py's smoke shapes (each package logs them; within 1e-4, the JAX
bench's printed precision), the SGD and BPR runs (``jax.random`` has no
torch twin: the SGD RMSE within a band of the root bench's, BPR completes)
and the one-line stdout of ``main``."""

import io
import json
import os
import re
import subprocess
import sys
import tempfile
import textwrap
from contextlib import redirect_stderr

import numpy as np
import pytest
import torch

# bench.py lives at the repo root, not in the package
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import bench as jbench  # noqa: E402

from ycnr_tpu.data import split as jsplit  # noqa: E402
from ycnr_tpu.data import synthetic as jsynthetic  # noqa: E402
from ycnr_tpu.ops import bucketed as jbucketed  # noqa: E402
from ycnr_tpu_torch.data.synthetic import synthetic_ratings  # noqa: E402
from ycnr_tpu_torch.ops.bucketed import build_bucketed  # noqa: E402
from ycnr_tpu_torch.ops.layout import build_blocked_csr  # noqa: E402
from ycnr_tpu_torch.tools import bench as tbench  # noqa: E402

torch.set_num_threads(1)

SMOKE = (500, 300, 20_000, 16, 2, 8)  # bench.py --smoke: shapes, rank,
#                                       timed epochs, chunk length
TRAJ_TOL = 1e-4  # the JAX bench logs RMSE to 4 decimals
# SGD's draws differ between the packages (jax.random vs torch.Generator):
# held-out RMSE of the same set from the same start moves ~1e-3 with them
SGD_BAND = 5e-3


@pytest.fixture(autouse=True)
def _cache(tmp_path, monkeypatch):
    monkeypatch.setenv("YCNR_BENCH_CACHE", str(tmp_path / "cache"))


def _layout(kind):
    u, i, r = synthetic_ratings(60, 40, 900, seed=5)
    if kind == "bucketed":
        return build_bucketed(u, i, r, 60, 40, chunk_len=8, rank_hint=8)
    return build_blocked_csr(u, i, r, 60, 40, 8, rank_hint=8)


@pytest.mark.parametrize("kind", ["bucketed", "blocked"])
def test_unflatten_layout_round_trip(kind):
    """Through an npz and back: the same layout type, every array equal
    (tests/test_bench_cache.py for the port)."""
    lay = _layout(kind)
    blob = {}
    tbench._flatten_layout("il", lay, blob)
    buf = io.BytesIO()
    np.savez(buf, **blob)
    buf.seek(0)
    back = tbench._unflatten_layout("il", np.load(buf))
    if kind == "blocked":
        assert type(back).__name__ == "BlockedCSR"
        pairs = [(lay, back)]
    else:
        assert len(back) == len(lay)
        pairs = list(zip(lay, back))
    for a, b in pairs:
        for f in a._fields:
            assert np.array_equal(getattr(a, f), getattr(b, f)), f


def test_cache_directory_from_the_variable_and_the_default(tmp_path,
                                                           monkeypatch):
    path = tbench._cache_path("x")
    assert path == os.path.join(str(tmp_path / "cache"), "v1_x.npz")
    assert path == jbench._cache_path("x")  # the root bench's name for it
    monkeypatch.delenv("YCNR_BENCH_CACHE")
    want = os.path.join(tempfile.gettempdir(),
                        f"ycnr_bench_cache.{os.getuid()}")
    assert tbench._cache_dir() == want
    (tmp_path / "own_tmp").mkdir()
    monkeypatch.setenv("TMPDIR", str(tmp_path / "own_tmp"))
    monkeypatch.setattr(tempfile, "tempdir", None)  # read TMPDIR anew
    assert tbench._cache_dir() == os.path.join(
        str(tmp_path / "own_tmp"), f"ycnr_bench_cache.{os.getuid()}")


def test_corrupt_cache_is_rebuilt():
    """A cache file that does not load is logged and rebuilt, and the
    arrays are those of a fresh build."""
    first = tbench.cached_coo(50, 30, 600, seed=2)
    path = tbench._cache_path(tbench.coo_tag(50, 30, 600, 2))
    with open(path, "wb") as f:
        f.write(b"not an npz")
    err = io.StringIO()
    with redirect_stderr(err):
        again = tbench.cached_coo(50, 30, 600, seed=2)
    assert "cache load failed" in err.getvalue()
    for a, b in zip(first[0] + first[1], again[0] + again[1]):
        assert np.array_equal(a, b)
    assert tbench._load_npz(path) is not None  # rewritten whole


def test_cache_writes_go_through_a_per_process_file(monkeypatch):
    seen = []
    real = os.replace

    def spy(src, dst):
        seen.append((src, dst))
        return real(src, dst)

    monkeypatch.setattr(os, "replace", spy)
    path = tbench._cache_path("pid")
    tbench._save_npz(path, {"a": np.arange(3)})
    assert seen == [(f"{path}.{os.getpid()}.tmp", path)]


def test_port_tags_differ_from_the_jax_tags():
    """The port's tags hash its own generating modules, so the root bench's
    cache files are never read as the port's, at any shape."""
    jax_tag = (f"coo_500x300x20000_s0_"
               f"{jbench._code_hash(jsynthetic, jsplit)}")
    port_tag = tbench.coo_tag(500, 300, 20_000, 0)
    assert port_tag != jax_tag
    assert port_tag.rsplit("_", 1)[0] == jax_tag.rsplit("_", 1)[0]
    jax_lay = (f"lay_{jax_tag[4:]}_c8_r16_bucketed_g8_"
               f"{jbench._code_hash(jbucketed)}")
    assert os.path.basename(tbench.layout_path(port_tag, 8, 16, "bucketed",
                                               8)) != f"v1_{jax_lay}.npz"


def test_cached_coo_is_synthetic_ratings_and_the_split():
    """The port's cached set is the root bench's: the same generator call
    and split, so the same arrays."""
    (tu, ti, tr), (su, si, sr) = tbench.cached_coo(300, 200, 5000, seed=1)
    u, i, r = jsynthetic.synthetic_ratings(300, 200, 5000, true_rank=16,
                                           noise=0.3, seed=1)
    want = jsplit.train_test_split(u, i, r, 0.05, 1)
    for a, b in zip((tu, ti, tr, su, si, sr), want[0] + want[1]):
        assert np.array_equal(a, b)


def _logged_rmse(fn, **kw):
    err = io.StringIO()
    with redirect_stderr(err):
        fn(*SMOKE, **kw)
    return [float(x) for x in re.findall(r"rmse=([0-9.]+)", err.getvalue())]


@pytest.mark.parametrize("algo", ["als", "ials"])
@pytest.mark.parametrize("layout", ["bucketed", "blocked"])
def test_rmse_trajectory_equals_the_root_bench(algo, layout):
    """f32 gathers, bench.py's smoke shapes and 2 timed epochs: the held-
    out RMSE after each of the 3 epochs the port logs equals what the root
    bench logs, within its printed precision."""
    want = _logged_rmse(jbench.run_bench, layout=layout, algo=algo,
                        bf16=False)
    got = _logged_rmse(tbench.run_bench, layout=layout, algo=algo,
                       bf16=False, device="cpu")
    assert len(want) == len(got) == 3
    assert np.allclose(got, want, rtol=0, atol=TRAJ_TOL), (got, want)


@pytest.mark.parametrize("algo,method", [("sgd", "batched"),
                                         ("sgd", "stream"),
                                         ("bpr", "batched")])
def test_sgd_and_bpr_runs_complete(algo, method):
    """No torch twin of jax.random, so a band: each epoch's held-out RMSE
    of the SGD runs within SGD_BAND of the root bench's on the same set
    (at these shapes both rise slowly from the first epoch's: 19,000
    ratings for rank 16 at the bench's learning rate); BPR (no RMSE)
    completes every epoch."""
    rep = {}
    s = tbench.run_bench(*SMOKE, algo=algo, sgd_method=method,
                         device="cpu", report=rep)
    assert s > 0 and len(rep["epoch_s"]) == 3
    if algo == "bpr":
        assert rep["rmse"] == [None] * 3
        return
    want = _logged_rmse(jbench.run_bench, algo=algo, sgd_method=method)
    assert len(want) == 3
    assert np.allclose(rep["rmse"], want, rtol=0, atol=SGD_BAND), (
        rep["rmse"], want)


def test_topn_leg_serves_no_rated_item():
    rep = {}
    tbench.run_bench(*SMOKE, topn_users=1, device="cpu", report=rep)
    assert rep["n_served"] == 500 and rep["rated_served_exact"] == 0
    assert "fused_s" not in rep  # 300 items: too few for the fused select


@pytest.mark.parametrize("groups", ["8", "both"])
def test_main_prints_one_json_line_with_the_root_bench_keys(capsys,
                                                            groups):
    out = tbench.main(["--smoke", "--device", "cpu", "--groups", groups])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1 and json.loads(lines[0]) == out
    keys = {"metric", "value", "unit", "vs_baseline"}
    if groups == "both":
        keys.add("steady_16g_s")
    assert set(out) == keys
    assert out["metric"] == "smoke_als_epoch_s" and out["unit"] == "s/epoch"
    assert out["vs_baseline"] is None and out["value"] > 0


def test_metric_names_of_the_card_runs(monkeypatch, capsys):
    """<scale>_<algo>_epoch_s_rank<k>_1gpu, sgd-stream as in bench.py (the
    shapes of the ml20m presets; run_bench is not called)."""
    seen = []
    monkeypatch.setattr(tbench, "run_bench",
                        lambda *a, **kw: seen.append(a) or 1.0)
    sgd = tbench.main(["--device", "cpu", "--algo", "sgd", "--sgd-method",
                       "stream", "--groups", "8"])
    bpr = tbench.main(["--device", "cpu", "--algo", "bpr", "--groups", "8"])
    assert sgd["metric"] == "ml20m_sgd-stream_epoch_s_rank64_1gpu"
    assert bpr["metric"] == "ml20m_bpr_epoch_s_rank32_1gpu"
    assert seen[0][:4] == (138_493, 26_744, 20_000_263, 64)
    assert len(capsys.readouterr().out.strip().splitlines()) == 2


def test_main_without_a_card_raises_and_names_the_flag(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        tbench.main(["--smoke"])


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


def test_bench_process_with_jax_blocked_prints_one_line(tmp_path):
    """python -m ycnr_tpu_torch.tools.bench --smoke --device cpu in a
    process where jax, the JAX package and the root bench cannot be
    imported: exactly one stdout line, the diagnostics on stderr."""
    env = dict(os.environ, PYTHONPATH=REPO,
               YCNR_BENCH_CACHE=str(tmp_path / "c"))
    res = subprocess.run([sys.executable, "-c", _BLOCKED,
                          "ycnr_tpu_torch.tools.bench", "--smoke",
                          "--device", "cpu", "--topn"],
                         cwd=str(tmp_path), env=env, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    lines = res.stdout.strip().splitlines()
    assert len(lines) == 1
    assert json.loads(lines[0])["metric"] == "smoke_als_epoch_s"
    assert "rmse=" in res.stderr and "top-10" in res.stderr
