"""The port's out-of-core bench (``ycnr_tpu_torch/tools/bench_ooc.py``) on
the CPU, held to the JAX package's ``tools/bench_ooc.py``: its scales, the
portioned generator (with and without the spool directory), the wire and
plan files and their loads, the wires it builds from the bench's cache,
the training and held-out COOs, and ``main --scale smoke --compare
--rmse`` for ALS-WR, iALS and stream SGD: a line with the JAX tool's keys,
the RMSE trajectory equal to the JAX tool's to its printed precision, and
the out-of-core factors and held-out RMSE equal to the resident run's bit
for bit (the same blocks through the same steps)."""

import io
import json
import os
import sys
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
from tools import bench_ooc as jooc  # noqa: E402

from ycnr_tpu_torch.tools import bench_ooc as tooc  # noqa: E402

torch.set_num_threads(1)

# --rmse: the JAX tool prints the held-out RMSE of each epoch (and the
# stream SGD's sampled train RMSE) to 4 decimals, so one unit of the last
# printed decimal; the wire evaluation's train RMSE is printed to 6
PRINTED_4 = 1e-4 + 1e-9
PRINTED_6 = 1e-5


@pytest.fixture(autouse=True)
def _cache(tmp_path, monkeypatch):
    monkeypatch.setenv("YCNR_BENCH_CACHE", str(tmp_path / "cache"))
    monkeypatch.setenv("YCNR_NO_WALL_WARM", "1")
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "xla"))


def _same(a, b, where="x"):
    if isinstance(a, (tuple, list)):
        assert isinstance(b, (tuple, list)) and len(a) == len(b), where
        for k, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{where}[{k}]")
    elif isinstance(a, (np.ndarray, np.generic)) or \
            isinstance(b, (np.ndarray, np.generic)):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, where
        assert np.array_equal(a, b), where
    else:
        assert type(a) is type(b) and a == b, (where, a, b)


def test_scales_are_the_jax_tools():
    assert tooc.SCALES == jooc.SCALES


@pytest.mark.parametrize("spool", [False, True])
def test_b1_portions_equal_the_jax_tools(tmp_path, spool):
    """Small shapes through the portioned generator: every portion the
    same arrays; with a spool directory the first pass writes it and the
    second reads it back (memmaps), in both packages."""
    kw = dict(portion=7_000, seed=3)
    passes = 2 if spool else 1
    for p in range(passes):
        want = list(jooc.b1_portions(
            900, 120, 25_000, spool_dir=str(tmp_path / "j") if spool
            else None, **kw))
        got = list(tooc.b1_portions(
            900, 120, 25_000, spool_dir=str(tmp_path / "t") if spool
            else None, **kw))
        assert len(got) == 4
        _same([tuple(np.array(a) for a in x) for x in got],
              [tuple(np.array(a) for a in x) for x in want], f"pass {p}")
    if spool:
        assert sorted(os.listdir(tmp_path / "t")) == \
            sorted(os.listdir(tmp_path / "j"))


def _wire_inputs():
    from ycnr_tpu.data.synthetic import synthetic_ratings

    return synthetic_ratings(200, 90, 4000, seed=4)


@pytest.mark.parametrize("fmt", ["packed", "rect"])
def test_wire_and_plan_files_equal_the_jax_tools(tmp_path, fmt):
    """save_packed / save_plan write the JAX tool's files byte for byte
    (the same arrays: the port's builders are copies), and the port's
    loads give back the built groups and plan."""
    from ycnr_tpu.ops import packed as jpacked
    from ycnr_tpu_torch.ops import packed as tpacked

    u, i, r = _wire_inputs()
    kw = dict(rank_hint=8, target_bytes=1 << 14, max_groups=3)
    build = {"packed": "build_packed", "rect": "build_rect"}[fmt]
    tg = getattr(tpacked, build)(u, i, r, 200, 90, **kw)
    jg = getattr(jpacked, build)(u, i, r, 200, 90, **kw)
    tplan = tpacked.wire_storage_plan(np.bincount(u, minlength=200), 8,
                                      1 << 14, 3)
    jplan = jpacked.wire_storage_plan(np.bincount(u, minlength=200), 8,
                                      1 << 14, 3)
    tooc.save_packed(tg, str(tmp_path / "t"), len(r))
    tooc.save_plan(tplan, str(tmp_path / "t"))
    jooc.save_packed(jg, str(tmp_path / "j"), len(r))
    jooc.save_plan(jplan, str(tmp_path / "j"))
    names = sorted(os.listdir(tmp_path / "t"))
    assert names == sorted(os.listdir(tmp_path / "j"))
    for n in names:
        if n == "plan.npz":  # a zip: its members, not its timestamps
            zt, zj = np.load(tmp_path / "t" / n), np.load(tmp_path / "j" / n)
            assert sorted(zt.files) == sorted(zj.files)
            for k in zt.files:
                _same(zt[k], zj[k], k)
            continue
        assert (tmp_path / "t" / n).read_bytes() == \
            (tmp_path / "j" / n).read_bytes(), n
    back, nnz = tooc.load_packed(str(tmp_path / "t"))
    assert nnz == len(r) and [type(g) for g in back] == [type(g) for g in tg]
    _same([tuple(np.array(x) if isinstance(x, np.ndarray) else x for x in g)
           for g in back],
          [tuple(x for x in g) for g in tg], "groups")
    _same(tuple(tooc.load_plan(str(tmp_path / "t"))), tuple(tplan), "plan")
    assert tooc.load_packed(str(tmp_path / "none")) == (None, 0)


def _np(groups):
    return [tuple(np.array(x) if isinstance(x, np.ndarray) else x
                  for x in g) for g in groups]


@pytest.mark.parametrize("wire,storage", [("packed", "entity"),
                                          ("rect", "entity"),
                                          ("packed", "wire")])
def test_build_or_load_wire_equals_the_jax_tools(wire, storage):
    """The smoke scale's two wire views (and storage plans), built from
    each package's bench cache and then read back from the wire cache,
    equal leaf by leaf."""
    want = jooc.build_or_load_wire("smoke", wire, 4, 1, rank=8,
                                   storage=storage)
    for _ in range(2):  # built, then loaded from the cache
        got = tooc.build_or_load_wire("smoke", wire, 4, 1, rank=8,
                                      storage=storage)
        assert got[2] == want[2]
        _same(_np(got[0]), _np(want[0]), "users")
        _same(_np(got[1]), _np(want[1]), "items")
        assert sorted(got[3]) == sorted(want[3])
        for k in want[3]:
            _same(tuple(got[3][k]), tuple(want[3][k]), k)


def test_training_and_heldout_coos_equal_the_jax_tools():
    _same(tooc.get_coo("smoke"), jooc.get_coo("smoke"), "train")
    _same(tooc.heldout_coo("smoke", n_sample=500),
          jooc.heldout_coo("smoke", n_sample=500), "held out")
    # the planted draw of the portioned scales
    _same(tooc.heldout_coo("b07", n_sample=4_000),
          jooc.heldout_coo("b07", n_sample=4_000), "b07")


def _jax_line(argv, monkeypatch):
    """The JAX tool's JSON line for argv (its compile cache kept out of
    the process's jax config)."""
    import jax

    real = jax.config.update
    monkeypatch.setattr(jax.config, "update", lambda k, v: None if
                        "compilation_cache" in k or k == "jax_platforms"
                        else real(k, v))
    monkeypatch.setattr(sys, "argv", ["bench_ooc.py"] + argv)
    buf = io.StringIO()
    with redirect_stdout(buf):
        jooc.main()
    return json.loads(buf.getvalue().strip().splitlines()[-1])


@pytest.mark.parametrize("algo", ["als", "ials", "sgd"])
def test_main_compare_prints_the_jax_tools_keys(algo, monkeypatch, capsys):
    """main --scale smoke --compare --rmse: one line with every key the JAX
    tool prints (the port adds "compare"); the held-out RMSE of every
    epoch equal to the JAX tool's to its printed precision (the same NumPy
    start, blocks and steps, so a wrong lam, alpha, init or epoch count
    shows), and the out-of-core run equal to the resident one: factors bit
    for bit, so the same held-out RMSE."""
    argv = ["--scale", "smoke", "--compare", "--algo", algo, "--epochs",
            "2", "--rank", "8", "--rmse"]
    want = _jax_line(argv, monkeypatch)
    capsys.readouterr()
    got = tooc.main(argv + ["--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1 and json.loads(lines[0]) == got
    assert set(want) <= set(got), set(want) - set(got)
    for k in ("ooc", "resident"):
        assert set(want[k]) <= set(got[k]), k
    for k in ("scale", "algo", "rank", "nnz", "n_users", "n_items"):
        assert got.get(k) == want.get(k), k
    assert len(got["heldout_rmse"]) == len(want["heldout_rmse"]) == 3
    assert np.allclose(got["heldout_rmse"], want["heldout_rmse"], rtol=0,
                       atol=PRINTED_4), (got["heldout_rmse"],
                                         want["heldout_rmse"])
    if algo == "sgd":
        assert np.allclose(got["train_rmse_sample"],
                           want["train_rmse_sample"], rtol=0,
                           atol=PRINTED_4)
    else:
        assert abs(got["train_rmse_final"] - want["train_rmse_final"]) \
            <= PRINTED_6
    cmp = got["compare"]
    assert cmp["factors_equal"] is True
    assert cmp["heldout_rmse_ooc"] == cmp["heldout_rmse_resident"]
    assert abs(cmp["heldout_rmse_ooc"] - got["heldout_rmse"][-1]) <= 5e-5


def test_probe_and_prep_only(capsys):
    """--probe: the three copy rates; --prep-only builds on the host and
    touches no device (no --device needed, none is resolved)."""
    got = tooc.main(["--scale", "smoke", "--probe", "--device", "cpu"])
    assert set(got["wire_MBps"]) == {"u16_deltas", "i8_noise", "f32_noise"}
    assert all(v > 0 for v in got["wire_MBps"].values())
    prep = tooc.main(["--scale", "smoke", "--prep-only", "--rank", "8"])
    assert prep["nnz"] == 28_500 and prep["wire_bytes_per_rating"] > 0
    sgd = tooc.main(["--scale", "smoke", "--prep-only", "--algo", "sgd"])
    assert sgd["nnz"] == 28_500 and "ooc" not in sgd
    assert len(capsys.readouterr().out.strip().splitlines()) == 3


def test_main_without_a_card_raises_and_names_the_flag(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        tooc.main(["--scale", "smoke", "--probe"])
