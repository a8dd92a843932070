"""The port's own copies of the JAX package's host code give the same
arrays as the originals, bit for bit: synthetic ratings, the splits, the
MovieLens parser, the dataset loader, the bucketed and blocked layouts,
``pad_coo``, the run configs (``asdict``, which a checkpoint manifest
carries across the packages), the NumPy oracle, the metrics logger and the
in-process recommendation cache (the same calls, the same answers)."""

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
from ycnr_tpu.oracle import numpy_mf as joracle
from ycnr_tpu.serve import cache as jcache
from ycnr_tpu.train import metrics as jmetrics
from ycnr_tpu_torch import config as tconfig
from ycnr_tpu_torch.data import dataset as tdataset
from ycnr_tpu_torch.data import movielens as tmovielens
from ycnr_tpu_torch.data import split as tsplit
from ycnr_tpu_torch.data import synthetic as tsynthetic
from ycnr_tpu_torch.ops import bucketed as tbucketed
from ycnr_tpu_torch.ops import layout as tlayout
from ycnr_tpu_torch.oracle import numpy_mf as toracle
from ycnr_tpu_torch.serve import cache as tcache
from ycnr_tpu_torch.train import metrics as tmetrics


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


def _factors(seed=0, nu=90, ni=70, k=4):
    rng = np.random.default_rng(seed)
    return (rng.normal(0, 0.1, (nu, k)), rng.normal(0, 0.1, (ni, k)),
            rng.normal(0, 0.05, nu), rng.normal(0, 0.05, ni))


def _oracle_als(m):
    u, i, r = _coo()
    U, V, _, _ = _factors()
    return (m.als_wr_epoch(U, V, u, i, r.astype(np.float64), 0.05),
            m.ials_epoch(U, V, u, i, r.astype(np.float64), 0.1, 2.0))


def _oracle_sgd(m):
    u, i, r = _coo()
    U, V, bu, bi = _factors(1)
    perm = np.random.default_rng(2).permutation(len(r))
    out = m.sgd_epoch_batched(U, V, bu, bi, 3.2, u, i, r.astype(np.float64),
                              0.02, 0.01, 128, perm)
    U, V, bu, bi = out
    rated = np.array([1, 2, 3])
    return (out, m.rmse(U, V, u, i, r, bu, bi, 3.2),
            m.predict(U, V, bu, bi, 3.2, u, i),
            m.topn(U, V, rated, 5, 6, bu, bi, 3.2))


def _oracle_bpr(m):
    u, i, _ = _coo()
    U, V, _, bi = _factors(3)
    negs = np.random.default_rng(4).integers(0, 70, len(u))
    return [m.bpr_epoch_batched(U, V, bi, u, i, negs, 0.02, 0.05, 256, gm)
            for gm in ("sum", "mean", "emean")]


def _metrics_logger(m):
    with tempfile.TemporaryDirectory() as d:
        p = os.path.join(d, "sub", "metrics.jsonl")
        log = m.MetricsLogger(p, echo=False)
        log.log(epoch=1, rmse_test=0.5, t=0.0)
        log.log(event="ranking", hit_rate=0.25, t=1.0)
        first = log.read()
        more = m.MetricsLogger(p, echo=False, append=True)  # a resumed run
        more.log(epoch=2, t=2.0)
        both = more.read()
        fresh = m.MetricsLogger(p, echo=False).read()  # truncates
        return first, both, fresh, m.MetricsLogger(None, echo=False).read()


def _rec_cache(m):
    """One script of calls against RecCache: user keys, ("pop", ...) and
    ("sim", ...) namespaces, LRU eviction, put_if and the TTL."""
    c = m.RecCache(capacity=6)
    out = []
    for uid in (1, 2, 3):
        out.append(c.put((uid, 10), [uid, 10]))
    c.put((1, 5), [1, 5])
    c.put(("pop", 0, 10, "count"), "pop10")
    c.put(("sim", 1, 10, "cosine"), "sim1")
    out.append(len(c))
    c.invalidate(1)  # user 1's lists; the ("sim", 1, ...) entry stays
    out += [c.get((1, 10)), c.get((1, 5)), c.get((2, 10)),
            c.get(("sim", 1, 10, "cosine")), c.get(("pop", 0, 10, "count"))]
    c.invalidate_popular()
    out += [c.get(("pop", 0, 10, "count")), c.get(("sim", 1, 10, "cosine")),
            len(c)]
    c.invalidate(("sim", 1, 10, "cosine"))  # one exact key
    out.append(c.get(("sim", 1, 10, "cosine")))
    out += [c.put_if((7, 10), "x", lambda: False), c.get((7, 10)),
            c.put_if((7, 10), "y", lambda: True), c.get((7, 10))]
    for uid in range(20, 30):  # past the capacity: the oldest go
        c.put((uid, 10), uid)
    out += [len(c), c.get((2, 10)), c.get((29, 10)), c.get((24, 10)),
            c.get((23, 10))]
    c.invalidate()
    out.append(len(c))
    t = m.RecCache(ttl_s=0.0)  # everything has expired on arrival
    t.put((1, 1), "gone")
    out += [t.get((1, 1)), len(t)]
    return out


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
    "oracle_als_ials": (joracle, toracle, _oracle_als),
    "oracle_sgd_rmse_predict_topn": (joracle, toracle, _oracle_sgd),
    "oracle_bpr": (joracle, toracle, _oracle_bpr),
    "metrics_logger": (jmetrics, tmetrics, _metrics_logger),
    "rec_cache": (jcache, tcache, _rec_cache),
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
