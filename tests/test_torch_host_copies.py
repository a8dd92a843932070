"""The port's own copies of the JAX package's host code give the same
arrays as the originals, bit for bit: synthetic ratings, the splits, the
MovieLens parser, the dataset loader, the bucketed and blocked layouts and
their stats, ``pad_coo``, the helpers its measuring tools copied from the
root ``bench.py`` and ``tools/`` (layout blobs, scales, the planted
generator, percentiles), the run configs (``asdict``, which a checkpoint manifest
carries across the packages), the NumPy oracle, the metrics logger, the
in-process and the shared-memory recommendation caches (the same calls,
the same answers), and the native shared-memory sources (byte for byte)."""

import ctypes
import dataclasses
import os
import tempfile
import types
import uuid

import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import bench as jbench  # noqa: E402  (the root bench.py)
from tools import bench_ooc as jbench_ooc  # noqa: E402
from tools import quality_calibrated as jquality  # noqa: E402
from tools import soak as jsoak  # noqa: E402
from ycnr_tpu import config as jconfig
from ycnr_tpu import native as jnative
from ycnr_tpu.data import dataset as jdataset
from ycnr_tpu.data import movielens as jmovielens
from ycnr_tpu.data import split as jsplit
from ycnr_tpu.data import store as jstore
from ycnr_tpu.data import synthetic as jsynthetic
from ycnr_tpu.ops import bucketed as jbucketed
from ycnr_tpu.models import sgd_stream as jsgd_stream
from ycnr_tpu.ops import layout as jlayout
from ycnr_tpu.ops import packed as jpacked
from ycnr_tpu.ops import sgd_wire as jsgd_wire
from ycnr_tpu.oracle import numpy_mf as joracle
from ycnr_tpu.parallel import dual as jdual
from ycnr_tpu.parallel import ooc_mesh as jooc_mesh
from ycnr_tpu.parallel import sgd_stream as jpsgd
from ycnr_tpu.parallel import shard as jshard
from ycnr_tpu.serve import cache as jcache
from ycnr_tpu.train import metrics as jmetrics
from ycnr_tpu_torch import config as tconfig
from ycnr_tpu_torch.data import dataset as tdataset
from ycnr_tpu_torch.data import movielens as tmovielens
from ycnr_tpu_torch.data import split as tsplit
from ycnr_tpu_torch.data import store as tstore
from ycnr_tpu_torch.data import synthetic as tsynthetic
from ycnr_tpu_torch.ops import bucketed as tbucketed
from ycnr_tpu_torch.models import sgd_stream as tsgd_stream
from ycnr_tpu_torch.ops import layout as tlayout
from ycnr_tpu_torch.ops import packed as tpacked
from ycnr_tpu_torch.ops import sgd_wire as tsgd_wire
from ycnr_tpu_torch.oracle import numpy_mf as toracle
from ycnr_tpu_torch.parallel import dual as tdual
from ycnr_tpu_torch.parallel import ooc_mesh as tooc_mesh
from ycnr_tpu_torch.parallel import sgd_stream as tpsgd
from ycnr_tpu_torch.parallel import shard as tshard
from ycnr_tpu_torch.serve import cache as tcache
from ycnr_tpu_torch.train import metrics as tmetrics
from ycnr_tpu_torch.tools import bench as tbench
from ycnr_tpu_torch.tools import bench_ooc as tbench_ooc
from ycnr_tpu_torch.tools import quality_calibrated as tquality
from ycnr_tpu_torch.tools import soak as tsoak
from test_torch_shm import build_jax_library


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


def _bucketed_stats(m):
    return [m.bucketed_stats(g, 4000) for g in _bucketed(m)]


def _layout_stats(m):
    return [m.layout_stats(g, 1500) for g in _blocked(m)]


def _tools(which):
    """The root bench / tools helpers of one package, with its builders."""
    if which == "jax":
        return types.SimpleNamespace(bench=jbench, ooc=jbench_ooc,
                                     quality=jquality, soak=jsoak,
                                     bucketed=jbucketed, layout=jlayout)
    return types.SimpleNamespace(bench=tbench, ooc=tbench_ooc,
                                 quality=tquality, soak=tsoak,
                                 bucketed=tbucketed, layout=tlayout)


def _layout_blob(m, kind):
    """bench._flatten_layout of both views of one layout kind."""
    lays = _bucketed(m.bucketed) if kind == "bucketed" else _blocked(m.layout)
    blob = {}
    for prefix, lay in zip(("ul", "il"), lays):
        m.bench._flatten_layout(prefix, lay, blob)
    return {k: np.asarray(v) for k, v in blob.items()}


def _planted(m):
    """bench_ooc's scales and planted bias model (the portioned scales'
    generator and held-out draw), quality_calibrated's scales, soak's
    percentiles."""
    bu, bi = m.ooc._planted_biases(500, 60, seed=4)
    draw = m.ooc._planted_draw(np.random.default_rng(9), bu, bi, 500, 60,
                               3000)
    lat = list(np.random.default_rng(2).random(101))
    return (m.ooc.SCALES, m.quality.SCALES, bu, bi, draw,
            [m.soak.pctl(lat, p) for p in (50, 99)], m.soak.pctl([], 50))


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


def _store_script(m, path):
    """Write a store and read it back: two appends with timestamps, the id
    maps, portions across segment edges, the refusals."""
    st = m.RatingsStore(path)
    u, i, r = _coo(n=700)
    ts = np.arange(len(r), dtype=np.int64) * 3
    st.append(u[:400], i[:400], r[:400], ts=ts[:400])
    st.append(u[400:], i[400:], r[400:], ts=ts[400:])
    st.set_id_maps(np.arange(90) * 7, np.arange(70) * 11)
    errs = []
    for bad in (dict(ts=None), dict(ts=ts[:3])):
        try:
            st.append(u[:5], i[:5], r[:5], **bad)
        except ValueError as e:
            errs.append(str(e))
    back = m.RatingsStore(path)  # reopened from meta.json
    return (dict(back.meta), back.n_rows, list(back.stream(portion=256)),
            back.read_all(), back.read_ts(), back.id_maps(), errs,
            m.RatingsStore(os.path.join(path, "empty")).read_all())


def _ratings_store(m):
    with tempfile.TemporaryDirectory() as d:
        return _store_script(m, d)


def _wire_coo(raw: bool):
    """Ratings for the wire builders: half-stars (the int8 wire) or
    continuous (the raw f32 wire); a catalog past 2^16 so deltas
    overflow."""
    rng = np.random.default_rng(9)
    u = rng.integers(0, 150, 3000)
    i = rng.integers(0, 70_000, 3000)
    r = (rng.standard_normal(3000).astype(np.float32) if raw
         else rng.integers(1, 11, 3000) / 2.0)
    return u, i, r


_WIRE_KW = dict(rank_hint=8, target_bytes=1 << 16, max_groups=4)


def _build_packed(m, raw):
    u, i, r = _wire_coo(raw)
    plan_i = m.wire_storage_plan(np.bincount(i, minlength=70_000),
                                 rank_hint=8, max_groups=4)
    return (m.build_packed(u, i, r, 150, 70_000, **_WIRE_KW),
            m.build_packed(i, u, r, 70_000, 150, **_WIRE_KW),
            m.build_packed(u, i, r, 150, 70_000, other_plan=plan_i,
                           **_WIRE_KW),
            plan_i)


def _build_packed_stream(m, raw):
    u, i, r = _wire_coo(raw)

    def portions():
        for s in range(0, len(u), 777):
            yield u[s:s + 777], i[s:s + 777], r[s:s + 777]

    plan_u = m.wire_storage_plan(np.bincount(u, minlength=150),
                                 rank_hint=8, max_groups=4)
    with tempfile.TemporaryDirectory() as d:
        disk = m.build_packed_stream(portions(), 150, 70_000,
                                     portions2=portions(), out_dir=d,
                                     **_WIRE_KW)
        disk = [tuple(np.array(x) if isinstance(x, np.ndarray) else x
                      for x in g) for g in disk]
    return (m.build_packed_stream(portions(), 150, 70_000,
                                  portions2=portions(), **_WIRE_KW),
            disk,
            m.build_packed_stream(portions(), 70_000, 150,
                                  portions2=portions(), view="other",
                                  other_plan=plan_u, **_WIRE_KW))


def _rect(m, raw):
    u, i, r = _wire_coo(raw)
    pk = m.build_packed(u, i, r, 150, 70_000, **_WIRE_KW)
    with tempfile.TemporaryDirectory() as d:
        disk = [tuple(np.array(x) if isinstance(x, np.ndarray) else x
                      for x in m.rect_from_packed(g, out_dir=d, gi=gi))
                for gi, g in enumerate(pk)]
    return ([m.rect_from_packed(g) for g in pk], disk,
            m.build_rect(i, u, r, 70_000, 150, 8, max_groups=3),
            m.packed_stats(pk, len(r)),
            [m.rating_wire_kind(x) for x in (r, r[:5] * 0 + 0.5, [300.0])])


def _dup_coo():
    """A COO with repeated (entity, other) pairs of different ratings:
    the builders keep such pairs in input order."""
    rng = np.random.default_rng(4)
    u = rng.integers(0, 40, 3000)
    i = rng.integers(0, 25, 3000)
    return u, i, rng.integers(1, 11, 3000) / 2.0


def _dup_layouts(m):
    u, i, r = _dup_coo()
    if hasattr(m, "build_packed"):
        return (m.build_packed(u, i, r, 40, 25, rank_hint=8, max_groups=3),
                m.build_packed(i, u, r, 25, 40, rank_hint=8, max_groups=3))
    if hasattr(m, "build_bucketed"):
        return (m.build_bucketed(u, i, r, 40, 25, rank_hint=8, max_groups=3),
                m.build_bucketed(i, u, r, 25, 40, rank_hint=8))
    return (m.build_blocked_csr(u, i, r, 40, 25, 8, rank_hint=4),
            m.build_blocked_csr(i, u, r, 25, 40, 4))


def _packages(which):
    """The sgd_stream / sgd_wire pair of one package."""
    if which == "jax":
        return types.SimpleNamespace(ss=jsgd_stream, sw=jsgd_wire)
    return types.SimpleNamespace(ss=tsgd_stream, sw=tsgd_wire)


def _compact(m, grad_mode, raw=False):
    u, i, r = jsynthetic.synthetic_ratings(80, 40, 1500, true_rank=3,
                                           seed=5, rating_levels=not raw)
    data, _ = m.ss.prepare_stream_sgd(u, i, r, 64, 80, 40, seed=2,
                                      grad_mode=grad_mode, device=False)
    comp = m.sw.compact_from_stream(data, 40)
    wide = m.sw.compact_from_stream(data._replace(tile=70_000), 40)
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "w.npz")
        m.sw.save_compact(comp, path)
        back = m.sw.load_compact(path)
    return (comp, wide, back, m.sw.decode_compact(comp, np.float32),
            m.sw.decode_compact(comp, np.float64), comp.nbytes,
            tuple(m.sw.flat_from_compact(comp)))


def _parallel(which):
    """The parallel/ host builders of one package."""
    if which == "jax":
        return types.SimpleNamespace(sh=jshard, ss=jpsgd, du=jdual,
                                     om=jooc_mesh)
    return types.SimpleNamespace(sh=tshard, ss=tpsgd, du=tdual,
                                 om=tooc_mesh)


def _np_tree(x):
    """A builder's output as plain NumPy: arrays (JAX's or NumPy's) as
    ndarrays, NamedTuples as tuples, dataclasses as dicts."""
    if dataclasses.is_dataclass(x):
        return {f.name: _np_tree(getattr(x, f.name))
                for f in dataclasses.fields(x)}
    if isinstance(x, (tuple, list)):
        return tuple(_np_tree(v) for v in x)
    if hasattr(x, "__array__") and not isinstance(x, np.ndarray):
        return np.asarray(x)
    return x


def _sharded_coo():
    u, i, r = jsynthetic.synthetic_ratings(90, 50, 2500, true_rank=3,
                                           seed=8)
    (tu, ti, tr), (su, si, sr) = jsplit.train_test_split(u, i, r, 0.1, 8)
    # users 80-89 and item 49 hold no training rating (zero degree)
    keep = (tu < 80) & (ti < 49)
    return (tu[keep], ti[keep], tr[keep]), (su, si, sr)


def _sharded_data(m, algo, D=3, host=True, f64=False):
    (tu, ti, tr), (su, si, sr) = _sharded_coo()
    dt = np.float64 if f64 else np.float32
    return _np_tree(m.sh.build_sharded_data(
        tu, ti, tr, 90, 50, D, chunk_len=8, block_chunks=None,
        rank_hint=8, test_u=su, test_i=si, test_r=sr, sgd_batch=100,
        dtype=dt, host_user_layout=host, algo=algo))


def _bpr_bits(m):
    (tu, ti, tr), _ = _sharded_coo()
    _, meta = m.sh.build_sharded_data(tu, ti, tr, 90, 50, 4, chunk_len=8,
                                      sgd_batch=64, algo="bpr")
    return _np_tree(m.sh.build_bpr_bits(tu, ti, meta, 64))


def _sharded_stream(m, grad_mode):
    (tu, ti, tr), _ = _sharded_coo()
    _, meta = m.sh.build_sharded_data(tu, ti, tr, 90, 50, 3, chunk_len=8,
                                      algo="stream-sgd")
    return _np_tree(m.ss.build_sharded_stream_sgd(
        tu, ti, tr, meta, 96, seed=3, grad_mode=grad_mode))


def _dual(m, D):
    (tu, ti, tr), (su, si, sr) = _sharded_coo()
    data, meta = m.du.build_dual_sharded_data(
        tu, ti, tr, 90, 50, D, chunk_len=8, rank_hint=8, test_u=su,
        test_i=si, test_r=sr, host_user_layout=True)
    return _np_tree((data, meta, m.du.dual_rated_bits(meta)))


def _sharded_wire(m, D, mixed=False):
    """build_sharded_wire with cold users and items and blocks small enough
    that slices end in padding blocks. ``mixed``: rank 0's users rate off
    the half-star grid, so its item view alone would ship raw ratings and
    the others int8 half-stars (the builder forces raw for all)."""
    u, i, r = jsynthetic.synthetic_ratings(300, 120, 6000, true_rank=3,
                                           seed=8)
    keep = (u < 290) & (i < 117)
    u, i, r = u[keep], i[keep], r[keep]
    kw = dict(rank_hint=8, max_groups=4, target_bytes=1 << 13)
    if mixed:
        _, meta = m.om.build_sharded_wire(u, i, r, 300, 120, D, **kw)
        r = np.where(np.isin(u, meta.user_map[0]), r + np.float32(0.1),
                     r).astype(np.float32)
    return _np_tree(m.om.build_sharded_wire(u, i, r, 300, 120, D, **kw))


def _lpt(m):
    rng = np.random.default_rng(5)
    skewed = np.concatenate([rng.pareto(1.2, 300).astype(np.int64) * 7,
                             np.zeros(40, np.int64), [5000, 4000, 1]])
    out = []
    for D in (1, 2, 3, 8):
        members, shard_of = m.sh._lpt_partition(skewed, D)
        out.append((tuple(np.asarray(x, np.int64) for x in members),
                    shard_of))
    # all zero degree: dealt evenly
    out.append(m.sh._lpt_partition(np.zeros(10, np.int64), 4))
    return _np_tree(out)


_CASES = {
    "synthetic_ratings": (jsynthetic, tsynthetic, _synthetic),
    "synthetic_ratings_calibrated": (jsynthetic, tsynthetic, _calibrated),
    "train_test_split": (jsplit, tsplit, _random_split),
    "split_coo_time_last_out": (jsplit, tsplit, _timed_splits),
    "build_bucketed": (jbucketed, tbucketed, _bucketed),
    "bucketed_stats": (jbucketed, tbucketed, _bucketed_stats),
    "layout_stats": (jlayout, tlayout, _layout_stats),
    "bench_layout_blob_bucketed": (_tools("jax"), _tools("torch"),
                                   lambda m: _layout_blob(m, "bucketed")),
    "bench_layout_blob_blocked": (_tools("jax"), _tools("torch"),
                                  lambda m: _layout_blob(m, "blocked")),
    "tools_scales_planted_draw_pctl": (_tools("jax"), _tools("torch"),
                                       _planted),
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
    "ratings_store": (jstore, tstore, _ratings_store),
    "duplicate_pairs_bucketed": (jbucketed, tbucketed, _dup_layouts),
    "duplicate_pairs_blocked": (jlayout, tlayout, _dup_layouts),
    "duplicate_pairs_packed": (jpacked, tpacked, _dup_layouts),
    "build_packed_half": (jpacked, tpacked, lambda m: _build_packed(m, 0)),
    "build_packed_raw": (jpacked, tpacked, lambda m: _build_packed(m, 1)),
    "build_packed_stream_half": (jpacked, tpacked,
                                 lambda m: _build_packed_stream(m, 0)),
    "build_packed_stream_raw": (jpacked, tpacked,
                                lambda m: _build_packed_stream(m, 1)),
    "rect_stats_kinds_half": (jpacked, tpacked, lambda m: _rect(m, 0)),
    "rect_stats_kinds_raw": (jpacked, tpacked, lambda m: _rect(m, 1)),
    "compact_sgd_wire_capped": (_packages("jax"), _packages("torch"),
                                lambda m: _compact(m, "capped")),
    "compact_sgd_wire_mean": (_packages("jax"), _packages("torch"),
                              lambda m: _compact(m, "mean")),
    "compact_sgd_wire_sum_raw": (_packages("jax"), _packages("torch"),
                                 lambda m: _compact(m, "sum", raw=True)),
    "build_sharded_data_all": (_parallel("jax"), _parallel("torch"),
                               lambda m: _sharded_data(m, "all")),
    "build_sharded_data_als_f64": (
        _parallel("jax"), _parallel("torch"),
        lambda m: _sharded_data(m, "als", D=2, host=False, f64=True)),
    "build_sharded_data_bpr": (_parallel("jax"), _parallel("torch"),
                               lambda m: _sharded_data(m, "bpr", D=4)),
    "build_sharded_data_stream_sgd": (
        _parallel("jax"), _parallel("torch"),
        lambda m: _sharded_data(m, "stream-sgd", D=2, host=False)),
    "build_sharded_data_one_shard": (_parallel("jax"), _parallel("torch"),
                                     lambda m: _sharded_data(m, "all", D=1)),
    "build_bpr_bits": (_parallel("jax"), _parallel("torch"), _bpr_bits),
    "build_sharded_stream_sgd_mean": (
        _parallel("jax"), _parallel("torch"),
        lambda m: _sharded_stream(m, "mean")),
    "build_sharded_stream_sgd_capped": (
        _parallel("jax"), _parallel("torch"),
        lambda m: _sharded_stream(m, "capped")),
    "build_dual_sharded_data_2": (_parallel("jax"), _parallel("torch"),
                                  lambda m: _dual(m, 2)),
    "build_dual_sharded_data_4": (_parallel("jax"), _parallel("torch"),
                                  lambda m: _dual(m, 4)),
    "lpt_partition_skewed_and_cold": (_parallel("jax"), _parallel("torch"),
                                      _lpt),
    **{f"build_sharded_wire_{D}": (
        _parallel("jax"), _parallel("torch"),
        lambda m, D=D: _sharded_wire(m, D)) for D in (1, 2, 3, 4)},
    **{f"build_sharded_wire_mixed_kinds_{D}": (
        _parallel("jax"), _parallel("torch"),
        lambda m, D=D: _sharded_wire(m, D, mixed=True)) for D in (2, 3)},
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


@pytest.mark.parametrize("writer,reader", [(jstore, tstore),
                                           (tstore, jstore)])
def test_ratings_store_reads_across_the_packages(tmp_path, writer, reader):
    """A store written by one package reads back in the other: the same
    rows, timestamps, id maps and meta, and appends continue it."""
    want = _store_script(writer, str(tmp_path / "s"))
    got = reader.RatingsStore(str(tmp_path / "s"))
    _assert_same(got.read_all(), want[3])
    _assert_same(got.read_ts(), want[4])
    _assert_same(got.id_maps(), want[5])
    _assert_same(dict(got.meta), want[0])
    got.append([1], [2], [3.5], ts=[99])
    again = writer.RatingsStore(str(tmp_path / "s"))
    assert again.n_rows == want[1] + 1
    assert again.read_all()[2][-1] == np.float32(3.5)
    assert again.read_ts()[-1] == 99


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("stem", ["shm_store", "shm_cache"])
def test_native_source_is_the_jax_packages_byte_for_byte(stem):
    """A segment written by either package is read by the other, so the
    port's shm sources are the JAX package's, unchanged."""
    with open(os.path.join(REPO, "ycnr_tpu", "native", f"{stem}.cc"),
              "rb") as f:
        want = f.read()
    with open(os.path.join(REPO, "ycnr_tpu_torch", "csrc", f"{stem}.cc"),
              "rb") as f:
        assert f.read() == want


def _shm_cache_script(m, name):
    """One sequence of calls against ShmRecCache: every key namespace,
    epochs, tombstones, put_if, the width limit, the key range."""
    out = []
    with m.ShmRecCache(name, 1 << 12, epoch=2) as c:
        for k in [(1, 10), (2, 5), ("sim", 3, 10, "cosine"),
                  ("sim", 3, 10, "dot"), ("pop", 0, 10, "count")]:
            out.append(c.put(k, np.arange(len(str(k)), dtype=np.int64)))
        out += [c.get((1, 10)), c.get((1, 9)), c.get(("sim", 3, 10, "dot")),
                c.epoch, c.stats()]
        c.invalidate(1)
        c.invalidate_popular()
        out += [c.get((1, 10)), c.get(("pop", 0, 10, "count")),
                c.get((2, 5))]
        out += [c.put_if((4, 10), [9, 8], lambda: False), c.get((4, 10)),
                c.put_if((4, 10), [9, 8], lambda: True), c.get((4, 10)),
                c.put((5, c.N_MAX + 1), np.arange(c.N_MAX + 1)),
                c.get((5, c.N_MAX + 1))]
        c.invalidate()
        out += [c.epoch, c.get((2, 5))]
        c.put((2, 5), [7])
        c.set_epoch(9)
        out += [c.epoch, c.get((2, 5))]
        for bad in ((1 << 40, 10), ("sim", 1 << 40, 5, "cosine")):
            try:
                c.put(bad, [1])
            except ValueError as e:
                out.append(str(e))
        for bad in ((1, 10, 3), ("sim", 1, 5, "jaccard")):
            try:
                c.get(bad)
            except (KeyError, ValueError) as e:
                out.append(type(e).__name__)
        out += [c.hits, c.misses, c.stats()]
        c.unlink()
    return out


def test_shm_cache_matches_the_jax_package(tmp_path, monkeypatch):
    """The port's ShmRecCache and the JAX package's (its library built from
    its own source here) answer one sequence of calls alike."""
    lib = build_jax_library(tmp_path, "shm_cache")
    monkeypatch.setitem(jnative._libs, "shm_cache", ctypes.CDLL(lib))
    name = f"/ycnr_thc_{uuid.uuid4().hex[:10]}"
    _assert_same(_shm_cache_script(tcache, name + "t"),
                 _shm_cache_script(jcache, name + "j"), "shm_cache")
