"""Headline benchmark of the port: ALS-WR epoch time at MovieLens-20M
width, rank 64, on one GPU (counterpart of the JAX package's root
``bench.py``, with its flags and output contract; ``--device`` in place of
``--platform``).

Prints exactly one JSON line on stdout:
  {"metric": ..., "value": ..., "unit": "s/epoch", "vs_baseline": null}
plus ``steady_16g_s`` (the 16-group layout's s/epoch) under ``--groups
both``. ``value`` is the median host-clock s/epoch (after a device
synchronize) of the epochs after the first. ``vs_baseline`` is null: the
JAX bench's 10 s target was set for a TPU, and no TPU figure is a target
here. Diagnostics go to stderr: layout stats, held-out RMSE and device ms
(CUDA events) an epoch, the kernels' launch counts, and with ``--topn``
the top-10 recs/s of the exact scorer and of K2.

    python -m ycnr_tpu_torch.tools.bench [--algo als|ials|sgd|bpr]
        [--rank K] [--topn] [--layout bucketed|blocked] [--groups 8|16|both]
    python -m ycnr_tpu_torch.tools.bench --smoke --device cpu

Runs on the card unless ``--device cpu`` is given. The synthetic set and
the layouts are cached on the host (``YCNR_BENCH_CACHE``, by default
``ycnr_bench_cache.<uid>`` in ``tempfile.gettempdir()``, so under
``TMPDIR`` when it is set) under tags that hash the port's own
generating modules.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import hashlib
import json
import os
import sys
import tempfile
import time

import numpy as np


def log(*a):
    print(*a, file=sys.stderr, flush=True)


@contextlib.contextmanager
def json_stdout():
    """While open, ``sys.stdout`` is stderr, so prints of the modules and
    build output stay off the tool's stdout; yields ``emit(obj)``, which
    writes one JSON line to the stdout it replaced."""
    out = sys.stdout

    def emit(obj):
        print(json.dumps(obj), file=out, flush=True)

    with contextlib.redirect_stdout(sys.stderr):
        yield emit


# Host-side artifact cache: generating 20M synthetic ratings takes about a
# minute and packing two layouts ~10 s before the card does any work.
# Cached artifacts are determined by the shape parameters + seed + the
# SOURCE of the generating code (hashed into the key, so editing the
# generator or a layout builder invalidates its entries without a manual
# version bump, and the JAX package's files never share a tag).
CACHE_VERSION = 1


def _code_hash(*modules) -> str:
    h = hashlib.sha256()
    for m in modules:
        with open(m.__file__, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:10]


def _cache_dir() -> str:
    # uid-suffixed default: a world-shared fixed name would be both
    # unusable (PermissionError on another user's dir) and poisonable; in
    # the temporary directory, so two checkouts with their own TMPDIR
    # never read each other's files
    return os.environ.get("YCNR_BENCH_CACHE", os.path.join(
        tempfile.gettempdir(), f"ycnr_bench_cache.{os.getuid()}"))


def _cache_path(tag: str) -> str:
    d = _cache_dir()
    os.makedirs(d, exist_ok=True)
    return os.path.join(d, f"v{CACHE_VERSION}_{tag}.npz")


def _save_npz(path: str, blob: dict):
    tmp = f"{path}.{os.getpid()}.tmp"  # per-pid: concurrent runs must not
    with open(tmp, "wb") as f:         # interleave writes to one scratch file
        np.savez(f, **blob)
    os.replace(tmp, path)


def _load_npz(path: str):
    """Eagerly load every member into a dict, or None on any failure.

    npz member reads are lazy, so corruption can surface at member access
    long after np.load succeeds; reading everything here keeps the
    'corrupt cache -> rebuild' contract honest."""
    if not os.path.exists(path):
        return None
    try:
        with np.load(path) as z:
            return {k: z[k] for k in z.files}
    except Exception as e:  # stale/corrupt cache -> rebuild
        log(f"cache load failed for {path} ({e}); rebuilding")
        return None


def _flatten_layout(prefix: str, lay, out: dict):
    """BucketedCSR (tuple of BucketGroup) or BlockedCSR -> npz-able dict."""
    from ycnr_tpu_torch.ops.layout import BlockedCSR

    if not isinstance(lay, BlockedCSR):
        out[f"{prefix}_ngroups"] = len(lay)
        for g, grp in enumerate(lay):
            for name, arr in grp._asdict().items():
                out[f"{prefix}_g{g}_{name}"] = arr
    else:
        out[f"{prefix}_ngroups"] = -1
        for name, arr in lay._asdict().items():
            out[f"{prefix}_{name}"] = arr


def _unflatten_layout(prefix: str, z):
    from ycnr_tpu_torch.ops.bucketed import BucketGroup
    from ycnr_tpu_torch.ops.layout import BlockedCSR

    n = int(z[f"{prefix}_ngroups"])
    if n >= 0:
        return tuple(
            BucketGroup(**{f: z[f"{prefix}_g{g}_{f}"]
                           for f in BucketGroup._fields})
            for g in range(n))
    return BlockedCSR(**{f: z[f"{prefix}_{f}"] for f in BlockedCSR._fields})


def coo_tag(n_users: int, n_items: int, n_ratings: int, seed: int) -> str:
    """The cache tag of the synthetic set's train / test split."""
    import ycnr_tpu_torch.data.split as _split_mod
    import ycnr_tpu_torch.data.synthetic as _synth_mod

    return (f"coo_{n_users}x{n_items}x{n_ratings}_s{seed}"
            f"_{_code_hash(_synth_mod, _split_mod)}")


def cached_coo(n_users: int, n_items: int, n_ratings: int, seed: int = 0):
    """((tu, ti, tr), (su, si, sr)): the planted synthetic set (rank 16,
    noise 0.3) split 95 / 5, from the cache or generated and cached."""
    from ycnr_tpu_torch.data.split import train_test_split
    from ycnr_tpu_torch.data.synthetic import synthetic_ratings

    path = _cache_path(coo_tag(n_users, n_items, n_ratings, seed))
    z = _load_npz(path)
    if z is not None:
        log(f"data cache hit {path}: {len(z['tr']) + len(z['sr']):,} "
            f"ratings")
        return (z["tu"], z["ti"], z["tr"]), (z["su"], z["si"], z["sr"])
    t0 = time.time()
    u, i, r = synthetic_ratings(n_users, n_items, n_ratings, true_rank=16,
                                noise=0.3, seed=seed)
    (tu, ti, tr), (su, si, sr) = train_test_split(u, i, r, 0.05, seed)
    log(f"data gen: {len(r):,} ratings in {time.time() - t0:.1f}s")
    _save_npz(path, {"tu": tu, "ti": ti, "tr": tr,
                     "su": su, "si": si, "sr": sr})
    return (tu, ti, tr), (su, si, sr)


def cached_dataset(data, rank_hint: int = 64):
    """``load_dataset(data, rank_hint)`` for a synthetic ``DataConfig``
    from the cache, or loaded and cached (a pickle tagged by the config
    and the code of the generator, the split and ``Dataset``; the
    calibrated generator takes tens of seconds at the ML-20M shape). Other
    sources load as they are."""
    import pickle

    import ycnr_tpu_torch.data.dataset as _ds_mod
    import ycnr_tpu_torch.data.split as _split_mod
    import ycnr_tpu_torch.data.synthetic as _synth_mod
    from ycnr_tpu_torch.data.dataset import load_dataset

    if data.source != "synthetic":
        return load_dataset(data, rank_hint=rank_hint)
    key = hashlib.sha256(repr((data, rank_hint)).encode()).hexdigest()[:10]
    code = _code_hash(_ds_mod, _split_mod, _synth_mod)
    path = _cache_path(f"ds_{key}_{code}")[:-len(".npz")] + ".pkl"
    if os.path.exists(path):
        try:
            with open(path, "rb") as f:
                ds = pickle.load(f)
            log(f"dataset cache hit {path}")
            return ds
        except Exception as e:  # stale/corrupt cache -> rebuild
            log(f"cache load failed for {path} ({e}); rebuilding")
    t0 = time.time()
    ds = load_dataset(data, rank_hint=rank_hint)
    log(f"dataset: {len(ds.train_r):,} train ratings in "
        f"{time.time() - t0:.1f}s")
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "wb") as f:
        pickle.dump(ds, f, protocol=pickle.HIGHEST_PROTOCOL)
    os.replace(tmp, path)
    return ds


def layout_path(data_tag: str, chunk_len: int, rank: int, layout: str,
                groups: int = 8) -> str:
    """The cache file of a pair of layouts (users ``ul``, items ``il``).
    The blocked blob doubles as the serving layout's cache (``--topn``
    builds the identical BlockedCSR), so its name is independent of the
    algorithm."""
    import ycnr_tpu_torch.ops.bucketed as _bucketed_mod
    import ycnr_tpu_torch.ops.layout as _layout_mod

    if layout == "bucketed":
        return _cache_path(f"lay_{data_tag[4:]}_c{chunk_len}_r{rank}"
                           f"_bucketed_g{groups}"
                           f"_{_code_hash(_bucketed_mod)}")
    return _cache_path(f"lay_{data_tag[4:]}_c{chunk_len}_r{rank}_blocked"
                       f"_{_code_hash(_layout_mod)}")


def cached_layouts(tu, ti, tr, n_users: int, n_items: int, chunk_len: int,
                   rank: int, layout: str, groups: int, data_tag: str,
                   need_items: bool = True):
    """(user layout, item layout or None) of ``layout`` kind from the
    cache, or built and cached. A cached blob may hold only the user side
    (the serving layout); ``need_items`` then builds the item side."""
    from ycnr_tpu_torch.ops.bucketed import build_bucketed
    from ycnr_tpu_torch.ops.layout import build_blocked_csr

    if layout == "bucketed":
        def build(a, b, na, nb):
            return build_bucketed(a, b, tr, na, nb, chunk_len, rank,
                                  max_groups=groups)
    else:
        def build(a, b, na, nb):
            return build_blocked_csr(a, b, tr, na, nb, chunk_len,
                                     rank_hint=rank)
    path = layout_path(data_tag, chunk_len, rank, layout, groups)
    z = _load_npz(path)
    ul = il = None
    if z is not None:
        ul = _unflatten_layout("ul", z)
        if "il_ngroups" in z:  # serving-only blobs hold just the user side
            il = _unflatten_layout("il", z)
        log(f"layout cache hit {path}")
    if ul is None or (il is None and need_items):
        t0 = time.time()
        if ul is None:
            ul = build(tu, ti, n_users, n_items)
        if il is None and need_items:
            il = build(ti, tu, n_items, n_users)
        log(f"layouts: {time.time() - t0:.1f}s")
        blob = {}
        _flatten_layout("ul", ul, blob)
        if il is not None:
            _flatten_layout("il", il, blob)
        _save_npz(path, blob)
    return ul, il


def cached_stream_host(tu, ti, tr, batch: int, n_users: int,
                       n_items: int, seed: int, data_tag: str):
    """The stream-SGD data (``prepare_stream_sgd``, capped weights) as
    host arrays: from the cache, or prepared and cached (the sorts and
    striping take seconds at ML-20M width). The out-of-core bench reads
    the same entry."""
    import ycnr_tpu_torch.models.sgd_stream as _stream_mod
    from ycnr_tpu_torch.models.sgd_stream import StreamSGDData, \
        prepare_stream_sgd

    path = _cache_path(f"stream_{data_tag[4:]}_b{batch}_capped"
                       f"_{_code_hash(_stream_mod)}")
    z = _load_npz(path)
    if z is not None:
        log(f"stream cache hit {path}")
        return StreamSGDData(
            ul=z["ul"], ib=z["ib"], rb=z["rb"], wu=z["wu"], wi=z["wi"],
            u_lo=z["u_lo"], n_real=int(z["n_real"]), tile=int(z["tile"]),
            grad_mode="capped")
    t0 = time.time()
    data, _ = prepare_stream_sgd(tu, ti, tr, batch, n_users, n_items,
                                 seed=seed, grad_mode="capped",
                                 device=False)
    log(f"stream prep: {time.time() - t0:.1f}s ({data.ul.shape[0]} "
        f"batches of {batch}, tile={data.tile})")
    blob = {n: getattr(data, n) for n in ("ul", "ib", "rb", "wu", "wi",
                                          "u_lo")}
    _save_npz(path, dict(blob, n_real=data.n_real, tile=data.tile))
    return data


def stream_to_device(data, device):
    """A host StreamSGDData as tensors on ``device``, as
    ``prepare_stream_sgd`` puts them there (``u_lo``, the tile starts,
    stays on the host)."""
    import torch

    def t(a, dt=None):
        x = torch.as_tensor(np.ascontiguousarray(a), device=device)
        return x.long() if dt is None else x.to(dt)

    return data._replace(ul=t(data.ul), ib=t(data.ib),
                         rb=t(data.rb, torch.float32),
                         wu=t(data.wu, torch.float32),
                         wi=t(data.wi, torch.float32))


def sync(device):
    """Wait for the device's queued work (nothing to wait for on the
    CPU)."""
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _launches() -> dict:
    """The port's kernel launch counters, by kernel."""
    from ycnr_tpu_torch.ops import fused_gram, fused_topn, row_gather, \
        spd_solve

    return {"spd_solve": spd_solve.launches,
            "spd_solve tiled": spd_solve.body_launches["tiled"],
            "fused_scores": fused_topn.launches,
            "row_gather": row_gather.launches,
            "fused_gram": fused_gram.launches}


def _rated_served(ids, bits, eids, n_users: int) -> int:
    """How many of the served ids [NB, U_B, n] of real users have their
    rated bit set in ``bits`` [NB, U_B, W]."""
    import torch

    ids = ids.long()
    word = torch.gather(bits, -1, ids >> 5)
    hit = ((word >> (ids & 31)) & 1).bool()
    real = (eids < n_users)[..., None]
    return int((hit & real).sum())


def run_bench(n_users: int, n_items: int, n_ratings: int, rank: int,
              epochs: int, chunk_len: int, seed: int = 0,
              topn_users: int = 0, layout: str = "bucketed",
              algo: str = "als", bf16: bool = False, groups: int = 8,
              sgd_method: str = "batched", batch: int | None = None,
              device=None, report: dict | None = None):
    """One measured run: epoch 1 (first-use costs) then ``epochs`` timed
    epochs; returns the median s/epoch of the timed ones. ``report``
    (optional) receives the RMSE trajectory, the epoch walls and device
    ms, the kernel launches and, with ``topn_users``, the serving
    figures."""
    import torch

    from ycnr_tpu_torch import full_precision_matmul, resolve_device
    from ycnr_tpu_torch.models.base import init_state, rmse_padded
    from ycnr_tpu_torch.ops.layout import build_blocked_csr, layout_stats, \
        pad_coo

    device = torch.device(resolve_device(device, "run_bench()"))
    full_precision_matmul()
    report = {} if report is None else report
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
        report["start_bytes"] = torch.cuda.memory_allocated(device)
    log(f"device: {device}"
        + (f" ({torch.cuda.get_device_name(device)})"
           if device.type == "cuda" else ""))
    data_tag = coo_tag(n_users, n_items, n_ratings, seed)
    (tu, ti, tr), (su, si, sr) = cached_coo(n_users, n_items, n_ratings,
                                            seed)

    lam = 0.05
    ul_serving = None
    if layout == "bucketed" and algo not in ("sgd", "bpr"):
        from ycnr_tpu_torch.models.bucketed_phase import (als_epoch_fn,
                                                          device_bucketed,
                                                          ials_epoch_fn,
                                                          uses_fused)
        from ycnr_tpu_torch.ops.bucketed import bucketed_stats

        ul, il = cached_layouts(tu, ti, tr, n_users, n_items, chunk_len,
                                rank, "bucketed", groups, data_tag)
        log(f"user={bucketed_stats(ul, len(tr))} "
            f"item={bucketed_stats(il, len(tr))}")
        alpha = 40.0 if algo == "ials" else None
        # the fused gather -> Gram branch reads bf16 ratings, as train()
        # moves them (train/loop.py)
        rdt = (torch.bfloat16 if uses_fused(device, torch.float32, alpha,
                                            bf16, rank) else None)
        dul = device_bucketed(ul, device=device, rating_dtype=rdt)
        dil = device_bucketed(il, device=device, rating_dtype=rdt)
        del ul, il
        if algo == "ials":
            epoch_fn = ials_epoch_fn(dul, dil, lam, alpha, gather_bf16=bf16)
        else:
            epoch_fn = als_epoch_fn(dul, dil, lam, gather_bf16=bf16)

        def step(state, ep):
            return epoch_fn(state)
    elif algo not in ("sgd", "bpr"):
        from ycnr_tpu_torch.models.als import als_epoch
        from ycnr_tpu_torch.models.base import device_layout
        from ycnr_tpu_torch.models.ials import ials_epoch

        ul, il = cached_layouts(tu, ti, tr, n_users, n_items, chunk_len,
                                rank, "blocked", groups, data_tag)
        log(f"user={layout_stats(ul, len(tr))} "
            f"item={layout_stats(il, len(tr))}")
        dul = device_layout(ul, device=device)
        dil = device_layout(il, device=device)

        if algo == "ials":
            def step(state, ep):
                return ials_epoch(state, dul, dil, lam, 40.0)
        else:
            def step(state, ep):
                return als_epoch(state, dul, dil, lam)
        ul_serving = ul
        del il
    elif algo == "sgd" and sgd_method == "stream":
        # scatter-free user-sorted stream epoch (models/sgd_stream.py); the
        # host prep (sorts + striping + weights) is cached like the layouts
        from ycnr_tpu_torch.models.sgd_stream import StreamSGD

        sgd_batch = batch or (4096 if len(tr) < 10**6 else 65536)
        sgd_data = stream_to_device(
            cached_stream_host(tu, ti, tr, sgd_batch, n_users, n_items,
                               seed, data_tag), device)
        trainer = StreamSGD(lam=0.02, lr=0.008, lr_decay=0.95, seed=seed,
                            grad_mode="capped")

        def step(state, ep):
            return trainer.epoch(state, sgd_data, ep)
    elif algo == "bpr":
        # pairwise ranking (models/bpr.py): padded positives + rated-bits
        # table; negatives re-drawn on the device every epoch, no layouts
        from ycnr_tpu_torch.models.bpr import BPRTrainer, prepare_bpr_data

        bpr_batch = batch or (4096 if len(tr) < 10**6 else 65536)
        t0 = time.time()
        sgd_data = prepare_bpr_data(tu, ti, bpr_batch, n_users, n_items,
                                    shuffle_rows_seed=0, device=device)
        log(f"bpr prep: {time.time() - t0:.1f}s "
            f"({sgd_data.u.shape[0] // bpr_batch} batches of {bpr_batch})")
        trainer = BPRTrainer(lam=0.01, lr=0.05, lr_decay=0.98,
                             batch_size=bpr_batch, seed=seed,
                             grad_mode="emean", shuffle="batches")

        def step(state, ep):
            return trainer.epoch(state, sgd_data, ep)
    else:
        # biased mini-batch SGD over the shuffled rating stream; only the
        # padded COO batches are needed, no layouts
        from ycnr_tpu_torch.models.sgd import BiasedSGD, prepare_sgd_data

        sgd_batch = batch or (4096 if len(tr) < 10**6 else 65536)
        trainer = BiasedSGD(lam=0.02, lr=0.008, lr_decay=0.95,
                            batch_size=sgd_batch, seed=seed,
                            grad_mode="mean")
        sgd_data = prepare_sgd_data(tu, ti, tr, sgd_batch, n_users, n_items,
                                    device=device)
        log(f"sgd: {sgd_data.u.shape[0] // sgd_batch} batches of "
            f"{sgd_batch}")

        def step(state, ep):
            return trainer.epoch(state, sgd_data, ep)
    state = init_state(n_users, n_items, rank, seed=seed,
                       mu=float(tr.mean()) if algo == "sgd" else 0.0,
                       device=device)
    pu, pi, pr, n = pad_coo(su, si, sr, n_users, n_items, 8192)
    test_coo = tuple(torch.as_tensor(x, device=device)
                     for x in (pu, pi, pr)) + (n,)
    cuda = device.type == "cuda"
    start_l = _launches()

    def timed(state, ep):
        if cuda:
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
        t0 = time.time()
        state = step(state, ep)
        if cuda:
            ev[1].record()
        sync(device)
        wall = time.time() - t0
        dev_ms = ev[0].elapsed_time(ev[1]) if cuda else None
        # bpr emits ranking logits: RMSE against ratings means nothing
        rmse = None if algo == "bpr" else float(rmse_padded(state,
                                                            *test_coo))
        return state, wall, dev_ms, rmse

    def note(wall, dev_ms, rmse):
        return (f"{wall:.4f}s"
                + ("" if dev_ms is None else f" device {dev_ms:.3f} ms")
                + ("" if rmse is None else f" rmse={rmse:.6f}"))

    walls, dev_ms, rmses = [], [], []
    for ep in range(epochs + 1):
        state, w, d, r = timed(state, ep)
        walls.append(w)
        dev_ms.append(d)
        rmses.append(r)
        log(f"epoch {ep + 1}" + (" (first-use costs included)" if ep == 0
                                 else "") + f": {note(w, d, r)}")
    epoch_s = float(np.median(walls[1:])) if epochs else walls[0]
    launches = {k: v - start_l[k] for k, v in _launches().items()}
    log(f"kernel launches over the epochs: {launches}")
    report.update(rmse=rmses, epoch_s=walls, device_ms=dev_ms,
                  launches=launches, epoch_s_median=epoch_s)
    if cuda:
        report["peak_bytes"] = torch.cuda.max_memory_allocated(device)

    if topn_users:
        from ycnr_tpu_torch.eval.recommend import (_topn_blocks, bits_tensor,
                                                   build_rated_bits)
        from ycnr_tpu_torch.models.base import device_layout
        from ycnr_tpu_torch.ops.fused_topn import (fused_supported,
                                                  fused_topn_blocks)

        if ul_serving is None:
            ul_serving, _ = cached_layouts(tu, ti, tr, n_users, n_items,
                                           chunk_len, rank, "blocked",
                                           groups, data_tag,
                                           need_items=False)
        dlay = device_layout(ul_serving, device=device)
        bits = bits_tensor(build_rated_bits(ul_serving, n_items), device)
        n_served = int((np.asarray(ul_serving.entity_ids) < n_users).sum())
        eids = dlay.entity_ids.long()
        l0 = _launches()
        ids, sc = _topn_blocks(state, dlay, 10, bits)  # first use
        sync(device)
        t0 = time.time()
        ids, sc = _topn_blocks(state, dlay, 10, bits)
        sync(device)
        dt = time.time() - t0
        bad = _rated_served(ids, bits, eids, n_users)
        log(f"top-10 on device for {n_served:,} users in {dt:.4f}s "
            f"= {n_served / dt:,.0f} recs/s (device compute, exact); "
            f"rated items served: {bad}")
        report.update(n_served=n_served, exact_s=dt,
                      exact_recs_s=n_served / dt, rated_served_exact=bad)
        if bad:
            raise RuntimeError(f"the exact scorer served {bad} rated items")
        if fused_supported(n_items, 10):
            idf, vf = fused_topn_blocks(state, eids, bits, 10)
            sync(device)
            t0 = time.time()
            idf, vf = fused_topn_blocks(state, eids, bits, 10)
            sync(device)
            dtf = time.time() - t0
            bad = _rated_served(idf, bits, eids, n_users)
            log(f"top-10 fused scorer (K2) in {dtf:.4f}s "
                f"= {n_served / dtf:,.0f} recs/s ({dt / dtf:.2f}x exact); "
                f"rated items served: {bad}")
            report.update(fused_s=dtf, fused_recs_s=n_served / dtf,
                          rated_served_fused=bad)
            if bad:
                raise RuntimeError(f"K2 served {bad} rated items")
        else:
            log(f"top-10 fused scorer skipped: a catalog of {n_items} "
                f"items is too small for its two-level select "
                f"(fused_supported)")
        report["topn_launches"] = {k: v - l0[k]
                                   for k, v in _launches().items()}
        log(f"kernel launches of the top-10 passes: "
            f"{report['topn_launches']}")
    return epoch_s


def tool_device(args, name: str):
    """The device a tool runs on: ``--device`` as given, else the card;
    without one it raises (``resolve_device``) and names the flag."""
    from ycnr_tpu_torch import resolve_device

    return resolve_device(args.device,
                          f"{name} (pass --device cpu for a CPU run)")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--smoke", action="store_true",
                    help="tiny shapes (500 x 300 x 20,000, 2 epochs; "
                         "with --device cpu for verification)")
    ap.add_argument("--epochs", type=int, default=3)
    ap.add_argument("--chunk-len", type=int, default=32)
    ap.add_argument("--rank", type=int, default=None,
                    help="factor rank (default: ml20m scale uses the "
                         "preset's — 64 for als/ials/sgd, 32 for bpr; "
                         "netflix scale and --smoke default to 64/16)")
    ap.add_argument("--topn", action="store_true",
                    help="also measure top-10 serving throughput (stderr)")
    ap.add_argument("--layout", choices=["bucketed", "blocked"],
                    default="bucketed")
    ap.add_argument("--scale", choices=["ml20m", "netflix"], default="ml20m",
                    help="netflix = 480k users x 17.8k items, 100M ratings "
                         "(BASELINE config 5 shape, one card)")
    ap.add_argument("--algo", choices=["als", "ials", "sgd", "bpr"],
                    default="als")
    ap.add_argument("--batch", type=int, default=None,
                    help="SGD/BPR batch size override (default 65536 at "
                         "scale, 4096 below 1M ratings)")
    ap.add_argument("--sgd-method", choices=["batched", "stream"],
                    default="batched",
                    help="SGD epoch structure (stream = scatter-free "
                         "user-sorted, models/sgd_stream.py)")
    ap.add_argument("--bf16", dest="bf16", action="store_true", default=True,
                    help="bfloat16 gathers with f32 accumulation (default)")
    ap.add_argument("--f32", dest="bf16", action="store_false",
                    help="force float32 gathers")
    ap.add_argument("--groups", default="both",
                    help="bucketed-layout group cap (8 = the main "
                         "path's, 16 = the library default), or "
                         "'both' (default) to measure 8 AND 16 in one "
                         "invocation: the JSON then carries the 16-group "
                         "time as 'steady_16g_s'")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card, 'cuda'; 'cpu' "
                         "for a CPU run)")
    args = ap.parse_args(argv)
    import torch

    both = args.groups == "both"
    groups = 8 if both else int(args.groups)
    device = tool_device(args, "bench")

    if args.smoke:
        shapes = (500, 300, 20_000)
        rank, epochs, chunk = (args.rank or 16), 2, 8
        metric = f"smoke_{args.algo}_epoch_s"
    elif args.scale == "netflix":
        # Netflix-scale synthetic (BASELINE.json:11 shape) on one card
        shapes = (480_189, 17_770, 100_480_507)
        rank = args.rank if args.rank is not None else 64
        epochs, chunk = args.epochs, args.chunk_len
        metric = f"netflix_{args.algo}_epoch_s_rank{rank}_1gpu"
    else:
        # MovieLens-20M width: shapes come FROM the ml20m preset, so the
        # bench and `train --preset ml20m-als` cannot drift apart
        from ycnr_tpu_torch.config import get_preset

        p = get_preset({"ials": "ml20m-ials", "bpr": "ml20m-bpr"}.get(
            args.algo, "ml20m-als"))
        shapes = (p.data.n_users, p.data.n_items, p.data.n_ratings)
        rank = args.rank if args.rank is not None else {
            "ials": p.ials.rank, "bpr": p.bpr.rank}.get(args.algo,
                                                        p.als.rank)
        epochs, chunk = args.epochs, p.data.chunk_len
        metric = f"ml20m_{args.algo}_epoch_s_rank{rank}_1gpu"

    def measure(g):
        return run_bench(*shapes, rank, epochs, chunk,
                         topn_users=1 if (args.smoke or args.topn) else 0,
                         layout=args.layout, algo=args.algo,
                         bf16=args.bf16, groups=g,
                         sgd_method=args.sgd_method, batch=args.batch,
                         device=device)

    if args.algo == "sgd" and args.sgd_method == "stream":
        metric = metric.replace("sgd", "sgd-stream", 1)
    # one line on stdout: everything else (build output, warnings, prints
    # of the modules) goes to stderr
    with json_stdout() as emit:
        epoch_s = measure(groups)
        out = {"metric": metric, "value": round(epoch_s, 4),
               "unit": "s/epoch", "vs_baseline": None}
        if both:
            # the 8-group run's device layouts went with its frame: collect
            # what a cycle still holds and hand the cached blocks back
            # before the 16-group run builds its own
            gc.collect()
            if torch.device(device).type == "cuda":
                torch.cuda.empty_cache()
            out["steady_16g_s"] = round(measure(16), 4)
        emit(out)
    return out


if __name__ == "__main__":
    main()
