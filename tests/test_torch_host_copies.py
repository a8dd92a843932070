"""The port's own copies of the JAX package's host code give the same
arrays as the originals, bit for bit: synthetic ratings, the splits, the
MovieLens parser, the dataset loader, the bucketed and blocked layouts,
``pad_coo`` and the run configs (``asdict``, which a checkpoint manifest
carries across the packages)."""

import dataclasses
import os
import tempfile

import numpy as np
import pytest

from ycnr_tpu import config as jconfig
from ycnr_tpu.data import dataset as jdataset
from ycnr_tpu.data import movielens as jmovielens
from ycnr_tpu.data import split as jsplit
from ycnr_tpu.data import synthetic as jsynthetic
from ycnr_tpu.ops import bucketed as jbucketed
from ycnr_tpu.ops import layout as jlayout
from ycnr_tpu_torch import config as tconfig
from ycnr_tpu_torch.data import dataset as tdataset
from ycnr_tpu_torch.data import movielens as tmovielens
from ycnr_tpu_torch.data import split as tsplit
from ycnr_tpu_torch.data import synthetic as tsynthetic
from ycnr_tpu_torch.ops import bucketed as tbucketed
from ycnr_tpu_torch.ops import layout as tlayout


def _coo(seed=3, n_users=90, n_items=70, n=1500):
    return jsynthetic.synthetic_ratings(n_users, n_items, n, seed=seed)


def _synthetic(m):
    return m.synthetic_ratings(120, 80, 3000, true_rank=4, noise=0.3, seed=7)


def _calibrated(m):
    return m.synthetic_ratings_calibrated(60, 50, 1500, seed=2)


def _random_split(m):
    return m.train_test_split(*_coo(), 0.2, seed=4)


def _timed_splits(m):
    u, i, r = _coo()
    ts = np.random.default_rng(1).integers(0, 100, len(r))
    return (m.split_coo(u, i, r, ts, "time", 0.15),
            m.split_coo(u, i, r, ts, "last-out", last_k=2))


def _bucketed(m):
    u, i, r = _coo(n_users=200, n_items=40, n=4000)
    # a tiny target_bytes gives several blocks per group
    return (m.build_bucketed(u, i, r, 200, 40, rank_hint=8, max_groups=5,
                             target_bytes=8 * 40 * 4 * 24),
            m.build_bucketed(i, u, r, 40, 200, rank_hint=8, max_groups=3))


def _blocked(m):
    u, i, r = _coo()
    return (m.build_blocked_csr(u, i, r, 90, 70, 8, rank_hint=4),
            m.build_blocked_csr(i, u, r, 70, 90, 4, block_chunks=16,
                                block_entities=8))


def _pad_coo(m):
    u, i, r = _coo()
    return m.pad_coo(u, i, r, 90, 70, 256)


def _movielens(m):
    rows = ["userId,movieId,rating,timestamp"] + [
        f"{u},{i},{r / 2},{t}" for u, i, r, t in zip(
            [5, 9, 5, 12, 9, 40], [3, 3, 17, 8, 100, 3], [7, 8, 10, 2, 5, 9],
            [50, 10, 40, 30, 20, 60])] + ["bad,row"]
    with tempfile.TemporaryDirectory() as d:
        p = os.path.join(d, "ratings.csv")
        with open(p, "w") as f:
            f.write("\n".join(rows) + "\n")
        return (m.load_movielens(p), m.load_movielens(p, return_maps=True,
                                                      return_ts=True))


def _dataset(m):
    cfg = m.DataConfig(n_users=70, n_items=40, n_ratings=1200, true_rank=3,
                       test_fraction=0.2, seed=5)
    ds = m.load_dataset(cfg, rank_hint=8)
    return (dataclasses.astuple(ds)[:10], ds.padded_test(128),
            ds.user_layout, ds.item_layout)


def _configs(m):
    return ([dataclasses.asdict(m.RunConfig())]
            + [dataclasses.asdict(m.get_preset(p)) for p in m.list_presets()])


_CASES = {
    "synthetic_ratings": (jsynthetic, tsynthetic, _synthetic),
    "synthetic_ratings_calibrated": (jsynthetic, tsynthetic, _calibrated),
    "train_test_split": (jsplit, tsplit, _random_split),
    "split_coo_time_last_out": (jsplit, tsplit, _timed_splits),
    "build_bucketed": (jbucketed, tbucketed, _bucketed),
    "build_blocked_csr": (jlayout, tlayout, _blocked),
    "pad_coo": (jlayout, tlayout, _pad_coo),
    "load_movielens": (jmovielens, tmovielens, _movielens),
    "load_dataset": (jdataset, tdataset, _dataset),
    "run_configs": (jconfig, tconfig, _configs),
}


def _assert_same(a, b, where="result"):
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        assert isinstance(a, np.ndarray) and isinstance(b, np.ndarray), where
        assert a.dtype == b.dtype and a.shape == b.shape, where
        assert np.array_equal(a, b), where
    elif isinstance(a, (tuple, list)):
        assert isinstance(b, (tuple, list)) and len(a) == len(b), where
        for k, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{where}[{k}]")
    elif isinstance(a, dict):
        assert isinstance(b, dict) and a.keys() == b.keys(), where
        for k in a:
            _assert_same(a[k], b[k], f"{where}.{k}")
    else:
        assert type(a) is type(b) and a == b, (where, a, b)


@pytest.mark.parametrize("case", sorted(_CASES))
def test_host_copy_matches_the_jax_package(case):
    jmod, tmod, run = _CASES[case]
    _assert_same(run(jmod), run(tmod), case)
