"""Out-of-core training benchmark of the port (counterpart of the JAX
package's ``tools/bench_ooc.py``, with its flags and one JSON object a
measurement on stdout; ``--device`` in place of ``--platform``).

Measures on the card:
  * resident against out-of-core epoch time where both fit (``--compare``;
    the out-of-core factors and held-out RMSE are also held to the
    resident run's, which they equal bit for bit: the same blocks through
    the same kernels),
  * a beyond-device-memory run (``--scale b1``: ~1e9 ratings, 10M users x
    200k items) with the device memory watermark (factors + in-flight wire
    blocks only: the full rating layout never resides on the card),
  * the host-to-device copy rate (``--probe``: pinned host memory to the
    card, timed with CUDA events).

ALS-WR / iALS stream the packed (or RECT) rating wire of ``ops/packed.py``
through ``models/ooc.py``; ``--algo sgd`` streams the compact stream-SGD
wire of ``ops/sgd_wire.py``. ``--residency host`` streams every epoch,
``auto`` / ``device`` pin wire groups on the card.

    python -m ycnr_tpu_torch.tools.bench_ooc --scale ml20m --compare
    python -m ycnr_tpu_torch.tools.bench_ooc --scale b1 --epochs 2
    python -m ycnr_tpu_torch.tools.bench_ooc --scale smoke --compare \\
        --device cpu

Diagnostics go to stderr. The wires are cached beside the bench's data
(``YCNR_BENCH_CACHE``); ``--prep-only`` builds them on the host and
touches no device.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np

from ycnr_tpu_torch.tools import bench
from ycnr_tpu_torch.tools.bench import (_cache_path, _code_hash,
                                        json_stdout, log, sync, tool_device)

SCALES = {
    # name: (n_users, n_items, n_ratings)  — netflix/ml20m match bench.py
    "ml20m": (138_493, 26_744, 20_000_263),
    "netflix": (480_189, 17_770, 100_480_507),
    "b1": (10_000_000, 200_000, 1_000_000_000),
    # beyond the card for the SGD stream at the JAX package's 15 GB
    # chip: the flat layout needs ~13 GB (20 B/rating) + 4.2 GB of factor
    # tables; the compact wire (~7-8 GB) pins
    "b07": (8_000_000, 100_000, 700_000_000),
    "smoke": (700, 300, 30_000),  # CPU correctness pass for this tool
}


def _packed_dir(tag: str) -> str:
    return os.path.join(bench._cache_dir(), f"packed_{tag}")


def save_packed(groups, d: str, nnz: int):
    """Persist a PackedCSR as one .npy per array + meta.json. Arrays that
    are already memmaps under d (the b1 build path) are left in place."""
    os.makedirs(d, exist_ok=True)
    meta = {"n_groups": len(groups), "nnz": nnz, "groups": []}
    for gi, g in enumerate(groups):
        meta["groups"].append({"R": g.R, "n_other": g.n_other,
                               "rating_kind": g.rating_kind,
                               "fmt": "rect" if g.lo.ndim == 3
                               else "packed"})
        for name in ("lo", "hi_pos", "hi_val", "rat", "cnt", "eid"):
            arr = getattr(g, name)
            fp = os.path.join(d, f"g{gi}.{name}.npy")
            if isinstance(arr, np.memmap) and \
                    os.path.abspath(getattr(arr, "filename", "")) == \
                    os.path.abspath(fp):
                arr.flush()
                continue
            np.save(fp + ".tmp.npy", np.asarray(arr))
            os.replace(fp + ".tmp.npy", fp)
    with open(os.path.join(d, "meta.json.tmp"), "w") as f:
        json.dump(meta, f)
    os.replace(os.path.join(d, "meta.json.tmp"),
               os.path.join(d, "meta.json"))


def save_plan(plan, d: str):
    """Persist a WireStoragePlan beside its wire cache."""
    os.makedirs(d, exist_ok=True)
    tmp = os.path.join(d, "plan.npz.tmp")
    with open(tmp, "wb") as f:
        np.savez(f, perm=plan.perm, rows=plan.rows, n_cold=plan.n_cold,
                 scratch=plan.scratch, zero_row=plan.zero_row,
                 n_offs=len(plan.offs),
                 **{f"offs_{j}": o for j, o in enumerate(plan.offs)})
    os.replace(tmp, os.path.join(d, "plan.npz"))


def load_plan(d: str):
    from ycnr_tpu_torch.ops.packed import WireStoragePlan

    p = os.path.join(d, "plan.npz")
    if not os.path.exists(p):
        return None
    try:
        z = np.load(p)
        return WireStoragePlan(
            perm=z["perm"],
            offs=tuple(z[f"offs_{j}"]
                       for j in range(int(z["n_offs"]))),
            rows=int(z["rows"]), n_cold=int(z["n_cold"]),
            scratch=int(z["scratch"]), zero_row=int(z["zero_row"]))
    except Exception as e:
        log(f"plan cache load failed ({e}); rebuilding")
        return None


def load_packed(d: str):
    from ycnr_tpu_torch.ops.packed import PackedGroup, RectGroup

    mp = os.path.join(d, "meta.json")
    if not os.path.exists(mp):
        return None, 0
    try:
        with open(mp) as f:
            meta = json.load(f)
        groups = []
        for gi, gm in enumerate(meta["groups"]):
            arrs = {name: np.load(os.path.join(d, f"g{gi}.{name}.npy"),
                                  mmap_mode="r")
                    for name in ("lo", "hi_pos", "hi_val", "rat", "cnt",
                                 "eid")}
            cls = (RectGroup if gm.get("fmt", "packed") == "rect"
                   else PackedGroup)
            groups.append(cls(R=gm["R"], n_other=gm["n_other"],
                              rating_kind=gm["rating_kind"], **arrs))
        return tuple(groups), int(meta["nnz"])
    except Exception as e:
        log(f"packed cache load failed ({e}); rebuilding")
        return None, 0


def wire_probe(device) -> dict:
    """MB/s of host-to-device copies from pinned host memory for the two
    entropy extremes the packed format ships (u16 deltas, int8 noise) and
    f32 noise, each timed with CUDA events around the copy alone (a
    64 KiB copy first, so no first-use cost lands in the timing). On the
    CPU the same copies into a CPU tensor, on the host clock."""
    import torch

    device = torch.device(device)
    cuda = device.type == "cuda"
    rng = np.random.default_rng(0)
    out = {}
    for name, arr in (
        ("u16_deltas", rng.integers(0, 40, 1 << 24).astype(np.uint16)),
        ("i8_noise", rng.integers(-128, 128, 1 << 25).astype(np.int8)),
        ("f32_noise", rng.random(1 << 23, dtype=np.float32)),
    ):
        # the native dtypes, as the wire ships them
        src = torch.from_numpy(arr.view(np.int16) if arr.dtype == np.uint16
                               else arr)
        if cuda:
            src = src.pin_memory()
        dst = torch.empty_like(src, device=device)
        dst[: 1 << 16].copy_(src[: 1 << 16], non_blocking=cuda)
        sync(device)
        if cuda:
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            dst.copy_(src, non_blocking=True)
            ev[1].record()
            sync(device)
            dt = ev[0].elapsed_time(ev[1]) / 1e3
        else:
            t0 = time.perf_counter()
            dst.copy_(src)
            dt = time.perf_counter() - t0
        out[name] = round(arr.nbytes / max(dt, 1e-9) / 2**20, 1)
    return out


def _planted_draw(rng, bu, bi, n_users, n_items, m):
    """One draw of m ratings from the planted bias model (squared-uniform
    popularity, half-star quantized) — shared by the training portions
    and the held-out sample so both come from the SAME generator."""
    u = (rng.random(m) ** 2 * n_users).astype(np.int32)
    i = (rng.random(m) ** 2 * n_items).astype(np.int32)
    r = 3.5 + bu[u] + bi[i] + rng.normal(0.0, 0.4, m).astype(np.float32)
    r = np.clip(np.round(r * 2.0), 1, 10).astype(np.float32) * 0.5
    return u, i, r


def _planted_biases(n_users, n_items, seed):
    rb = np.random.default_rng(seed + 10_007)
    bu = rb.normal(0.0, 0.5, n_users).astype(np.float32)
    bi = rb.normal(0.0, 0.5, n_items).astype(np.float32)
    return bu, bi


def b1_portions(n_users, n_items, n_ratings, portion=50_000_000, seed=0,
                spool_dir=None):
    """Deterministic portion stream for the beyond-device run: power-law-
    ish popularity via squared uniforms (cheaper at 1e9 than the inverse-
    CDF zipf of data/synthetic.py), ratings from a planted bias model so
    ALS has real structure to fit. Duplicate (u,i) pairs are allowed
    (extra rating rows — same ALS math), matching what a portioned DB
    SELECT without global dedup would ship.

    ``spool_dir``: persist each generated portion as int32/f32 .npy files
    and serve memmap views on later passes — the two wire builds iterate
    the stream 4x, and regeneration (not IO) is the cost."""
    n_port = -(-n_ratings // portion)
    bu = bi = None
    for p in range(n_port):
        if spool_dir is not None:
            fps = [os.path.join(spool_dir, f"p{p}.{c}.npy")
                   for c in ("u", "i", "r")]
            if all(os.path.exists(fp) for fp in fps):
                u, i, r = (np.load(fp, mmap_mode="r") for fp in fps)
                yield u, i, r
                continue
        if bu is None:
            # planted biases (regenerated per call — deterministic in seed)
            bu, bi = _planted_biases(n_users, n_items, seed)
        rng = np.random.default_rng(seed + p)
        m = min(portion, n_ratings - p * portion)
        u, i, r = _planted_draw(rng, bu, bi, n_users, n_items, m)
        if spool_dir is not None:
            os.makedirs(spool_dir, exist_ok=True)
            for fp, a in zip(fps, (u, i, r)):
                np.save(fp + ".tmp.npy", a)
                os.replace(fp + ".tmp.npy", fp)
        yield u, i, r
        del u, i, r


def build_or_load_wire(scale, wire, groups, target_mb, rank=64, seed=0,
                       portion=50_000_000, storage="entity"):
    """Build (or load from the shared cache) both out-of-core wire views.

    ``storage="wire"`` builds the WIRE-ORDER STORAGE variant
    (ops/packed.WireStoragePlan): each view's other-ids are relabeled to
    the twin view's storage rows so the factor tables live in wire order
    (models/ooc.phase_packed_wire). Returns (ug, ig, nnz, extras) where
    extras carries {"u_plan", "i_plan"} in wire-storage mode ({}
    otherwise); the plans are cached beside the wires.

    Pure host work. Disk footprint at --scale b1: the spool holds the raw
    generated portions (~12 GB per 1e9 ratings) so the 4 stream passes of
    the two wire builds regenerate nothing; the two wire caches add ~2x
    the wire size. The spool dir is keyed by (shape, seed, portion) so
    changing the generator params can never serve stale portions."""
    import ycnr_tpu_torch.ops.packed as _packed_mod
    from ycnr_tpu_torch.ops.packed import (build_packed, build_packed_stream,
                                           build_rect, packed_stats,
                                           rating_wire_kind,
                                           rect_from_packed,
                                           wire_storage_plan)

    nu, ni, nr = SCALES[scale]
    kw = dict(rank_hint=rank, target_bytes=target_mb * 2**20,
              max_groups=groups)
    ws = storage == "wire"
    wtag = ("" if wire == "packed" else "_rect") + ("_ws" if ws else "")
    extras = {}
    if scale == "b1":
        tag = (f"b1_{nu}x{ni}x{nr}_g{groups}_t{target_mb}"
               f"{wtag}_{_code_hash(_packed_mod)}")
        d_u, d_i = _packed_dir(tag + "_u"), _packed_dir(tag + "_i")
        ug, nnz = load_packed(d_u)
        ig, _ = load_packed(d_i)
        if ws:
            extras = {"u_plan": load_plan(d_u), "i_plan": load_plan(d_i)}
        if ug is None or ig is None or (ws and None in extras.values()):
            nnz = nr  # b1_portions ships exactly n_ratings (no dedup)
            spool = _packed_dir(
                f"b1_spool_{nu}x{ni}x{nr}_s{seed}_p{portion}")
            counts_kind = {}
            if ws:
                # one spool pass gives both views' counts + the rating
                # kind, so BOTH storage plans exist before either build
                # (each view's wire needs the twin's plan for relabeling)
                t0 = time.time()
                cu = np.zeros(nu, np.int64)
                ci = np.zeros(ni, np.int64)
                kind = "half"
                for u, i, r in b1_portions(nu, ni, nr, portion=portion,
                                           seed=seed, spool_dir=spool):
                    cu += np.bincount(u, minlength=nu)
                    ci += np.bincount(i, minlength=ni)
                    if kind == "half" and rating_wire_kind(r) != "half":
                        kind = "raw"
                up = wire_storage_plan(cu, rank, target_mb * 2**20,
                                       groups)
                ip = wire_storage_plan(ci, rank, target_mb * 2**20,
                                       groups)
                counts_kind = {"entity": (cu, ip), "other": (ci, up)}
                save_plan(up, d_u)
                save_plan(ip, d_i)
                extras = {"u_plan": up, "i_plan": ip}
                log(f"storage plans from counts pass: "
                    f"{time.time() - t0:.0f}s")
            for view, d in (("entity", d_u), ("other", d_i)):
                t0 = time.time()
                n_e, n_o = (nu, ni) if view == "entity" else (ni, nu)

                def ports():
                    return b1_portions(nu, ni, nr, portion=portion,
                                       seed=seed, spool_dir=spool)

                skw = dict(kw)
                if ws:
                    cnts, twin = counts_kind[view]
                    skw.update(counts=cnts, rating_kind=kind,
                               other_plan=twin)
                g = build_packed_stream(
                    ports(), n_e, n_o, portions2=ports(),
                    out_dir=os.path.join(d, "wire"), view=view, **skw)
                if wire == "rect":
                    # expand group by group straight into the cache dir:
                    # rect_from_packed memmaps g{gi}.{lo,rat}.npy at the
                    # exact paths save_packed keeps in place
                    g = tuple(rect_from_packed(gg, out_dir=d, gi=gi)
                              for gi, gg in enumerate(g))
                save_packed(g, d, nnz)
                log(f"{view} wire built in {time.time() - t0:.0f}s: "
                    f"{packed_stats(g, nnz)}")
                del g
                # the builder's intermediates under wire/ are superseded
                # by save_packed's canonical copies — reclaim the disk
                import shutil
                shutil.rmtree(os.path.join(d, "wire"), ignore_errors=True)
            ug, _ = load_packed(d_u)
            ig, _ = load_packed(d_i)
        return ug, ig, nnz, extras
    tu, ti, tr, nu, ni = get_coo(scale, seed)
    nnz = len(tr)
    tag = (f"{scale}_{nnz}_g{groups}_t{target_mb}"
           f"{wtag}_{_code_hash(_packed_mod)}")
    d_u, d_i = _packed_dir(tag + "_u"), _packed_dir(tag + "_i")
    ug, _ = load_packed(d_u)
    ig, _ = load_packed(d_i)
    if ws:
        extras = {"u_plan": load_plan(d_u), "i_plan": load_plan(d_i)}
    if ug is None or ig is None or (ws and None in extras.values()):
        t0 = time.time()
        build = build_rect if wire == "rect" else build_packed
        if ws:
            up = wire_storage_plan(np.bincount(tu, minlength=nu),
                                   rank, target_mb * 2**20, groups)
            ip = wire_storage_plan(np.bincount(ti, minlength=ni),
                                   rank, target_mb * 2**20, groups)
            ug = build(tu, ti, tr, nu, ni, other_plan=ip, **kw)
            ig = build(ti, tu, tr, ni, nu, other_plan=up, **kw)
            save_plan(up, d_u)
            save_plan(ip, d_i)
            extras = {"u_plan": up, "i_plan": ip}
        else:
            ug = build(tu, ti, tr, nu, ni, **kw)
            ig = build(ti, tu, tr, ni, nu, **kw)
        log(f"wire built in {time.time() - t0:.0f}s")
        save_packed(ug, d_u, nnz)
        save_packed(ig, d_i, nnz)
    return ug, ig, nnz, extras


def get_coo(scale, seed=0):
    """ml20m/netflix/smoke train COO through the bench's shared cache (the
    same tag: the blob the bench built is reused, and vice versa)."""
    nu, ni, nr = SCALES[scale]
    (tu, ti, tr), _ = bench.cached_coo(nu, ni, nr, seed)
    return tu, ti, tr, nu, ni


def heldout_coo(scale, seed=0, n_sample=2_000_000):
    """Held-out COO for per-epoch eval, small enough to keep on the card.

    ml20m/netflix/smoke: the 5% test split the bench's data generation
    produced (cached beside the train COO), subsampled on a deterministic
    stride. b1/b07 (portion streams, never split): a FRESH draw of
    n_sample ratings from the same planted bias model at a seed offset the
    portion range (seed+p, p < n_port) never reaches — generalization to
    new samples of the generator, the honest held-out notion for a
    duplicate-pair stream."""
    nu, ni, nr = SCALES[scale]
    if nr >= 5 * 10**8:  # b1_portions-generated scales
        bu, bi = _planted_biases(nu, ni, seed)
        rng = np.random.default_rng(seed + 1_000_003)
        return _planted_draw(rng, bu, bi, nu, ni, n_sample)
    _, (su, si, sr) = bench.cached_coo(nu, ni, nr, seed)
    if len(sr) > n_sample:
        sel = np.unique(np.linspace(0, len(sr) - 1,
                                    n_sample).astype(np.int64))
        su, si, sr = su[sel], si[sel], sr[sel]
    return (su.astype(np.int32), si.astype(np.int32),
            sr.astype(np.float32))


def _default_sample(scale) -> int:
    # 512k rows at the beyond-device scales bound the eval's transient
    # gathered tensors; the RMSE standard error is then ~1.4e-3
    return 512 * 1024 if SCALES[scale][2] >= 5 * 10**8 else 2_000_000


def heldout_rmse_fn(scale, device, seed=0, n_sample=None):
    """fn(state) -> held-out RMSE over a sample kept on the card (~24 MB at
    2M rows): per-epoch eval with no re-streaming."""
    if n_sample is None:
        n_sample = _default_sample(scale)
    return _heldout_fn_from(*heldout_coo(scale, seed, n_sample), device)


def heldout_rmse_fn_mapped(scale, u_map, i_map, device, seed=0,
                           n_sample=None):
    """heldout_rmse_fn for WIRE-ORDER STORAGE tables: ids map through the
    views' storage perms before they go to the card (the tables are
    storage-ordered, so rmse_padded's gathers need storage rows)."""
    if n_sample is None:
        n_sample = _default_sample(scale)
    u, i, r = heldout_coo(scale, seed, n_sample)
    return _heldout_fn_from(np.asarray(u_map)[u].astype(np.int32),
                            np.asarray(i_map)[i].astype(np.int32), r,
                            device)


def _heldout_fn_from(u, i, r, device, n_real=None):
    """fn(state) -> RMSE over the COO (u, i, r) put on ``device`` once;
    ``n_real`` (default: every row) is the count of real rows, padding
    rows pointing at the trash rows are masked by index."""
    import torch

    from ycnr_tpu_torch.models.base import rmse_padded

    pu = torch.as_tensor(np.asarray(u), device=device)
    pi = torch.as_tensor(np.asarray(i), device=device)
    pr = torch.as_tensor(np.asarray(r, np.float32), device=device)
    n = len(r) if n_real is None else n_real

    def f(state):
        return float(rmse_padded(state, pu, pi, pr, n))

    return f


def time_epochs(step, state, epochs, label, device):
    times = []
    for ep in range(epochs):
        t0 = time.time()
        state = step(state)
        sync(device)
        dt = time.time() - t0
        times.append(dt)
        log(f"{label} epoch {ep}: {dt:.3f}s")
    steady = min(times[1:]) if len(times) > 1 else times[0]
    return state, {"first_s": round(times[0], 3),
                   "steady_s": round(steady, 3)}


def _sgd_sample_rmse_fn(comp, n_items, device, n_batches=64):
    """Train-RMSE over a fixed strided sample of wire batches, decoded on
    the host once and held on the card — the cheap descending-convergence
    signal for beyond-device runs where the full COO never exists on the
    card. Global user ids reconstruct as u_lo + local row; pad rows
    decode to (n_users, n_items, 0) and are masked by rmse_padded."""
    from ycnr_tpu_torch.ops.sgd_wire import decode_compact

    NB = comp.ul.shape[0]
    sel = np.unique(np.linspace(0, NB - 1,
                                min(NB, n_batches)).astype(np.int64))
    sub = comp._replace(**{n: np.asarray(getattr(comp, n))[sel]
                           for n in ("ul", "ilo", "ihi_pos", "ihi_val",
                                     "rq", "mu", "mi", "u_lo")})
    ul, ib, rb, _, _ = decode_compact(sub, np.float32)
    gu = (np.asarray(sub.u_lo, np.int64)[:, None] + ul).astype(np.int32)
    n_real = int((ib < n_items).sum())
    return _heldout_fn_from(gu.reshape(-1), ib.reshape(-1),
                            rb.reshape(-1).astype(np.float32), device,
                            n_real)


def _factors_equal(a, b) -> bool:
    import torch

    return bool(torch.equal(a.U, b.U) and torch.equal(a.V, b.V))


def run_sgd_ooc(args, result, emit, device=None):
    """OOC stream-SGD measurement. --sgd-wire flat = the [NB, B] batch
    slabs as built (20 B/rating); compact = the ops/sgd_wire encoding
    (5-9 B/rating). --residency host streams the chosen wire from the host
    every epoch; auto/device pins it whole on the card (compact only —
    the flat slabs ARE the decoded layout). --compare adds the resident
    flat epoch as the reference rung (the same batch orders, so the same
    factors bit for bit). Streamed bytes/epoch are reported so a wire-
    bound model is checkable."""
    import ycnr_tpu_torch.models.sgd_stream as _stream_mod
    import ycnr_tpu_torch.ops.sgd_wire as _wire_mod
    from ycnr_tpu_torch.ops.sgd_wire import (compact_from_stream,
                                             flat_from_compact,
                                             load_compact, put_compact,
                                             save_compact)

    nu, ni, _ = SCALES[args.scale]
    batch = 65_536
    # the compact wire is the cached artifact (decode_compact recovers the
    # flat stream bitwise), so prep — data gen + the sort-heavy stream
    # build — runs ONCE, and can run on the host alone via --prep-only
    wtag = (f"sgdwire_{args.scale}_b{batch}_s0"
            f"_{_code_hash(_wire_mod, _stream_mod)}")
    wpath = _cache_path(wtag)
    if os.path.exists(wpath):
        t0 = time.time()
        comp = load_compact(wpath)
        log(f"wire cache hit {wpath} ({time.time() - t0:.0f}s)")
    else:
        from ycnr_tpu_torch.models.sgd_stream import prepare_stream_sgd

        if SCALES[args.scale][2] >= 5 * 10**8:
            # beyond-device scales: the portioned generator (duplicate
            # (u,i) rows allowed — the portioned-SELECT analog)
            nr = SCALES[args.scale][2]
            t0 = time.time()
            parts = list(b1_portions(nu, ni, nr, seed=0))
            tu = np.concatenate([p[0] for p in parts])
            ti = np.concatenate([p[1] for p in parts])
            tr = np.concatenate([p[2] for p in parts])
            del parts
            log(f"portioned gen: {len(tr):,} ratings in "
                f"{time.time() - t0:.0f}s")
            t0 = time.time()
            data, _ = prepare_stream_sgd(tu, ti, tr, batch, nu, ni, seed=0,
                                         device=False)
            log(f"stream prep (host): {time.time() - t0:.0f}s, "
                f"NB={data.ul.shape[0]} tile={data.tile}")
        else:
            # the bench's cached stream (the same call: capped weights,
            # seed 0), prepared here if it is not there yet
            tu, ti, tr, nu, ni = get_coo(args.scale)
            data = bench.cached_stream_host(
                tu, ti, tr, batch, nu, ni, 0,
                bench.coo_tag(nu, ni, SCALES[args.scale][2], 0))
        del tu, ti, tr
        t0 = time.time()
        comp = compact_from_stream(data, ni)  # validate=True round-trip
        log(f"compact wire build+validate (host): {time.time() - t0:.0f}s")
        del data
        save_compact(comp, wpath)
        log(f"wire cached -> {wpath}")
    nnz = comp.n_real
    # flat-stream footprint, computed (not built): ul/ib i32 + rb/wu/wi
    # f32 + u_lo — what the resident layout would hold on the card
    stream_b = comp.ul.size * 20 + comp.u_lo.size * 4
    result.update(nnz=nnz, n_users=nu, n_items=ni, batch=batch,
                  sgd_wire=args.sgd_wire, tile=comp.tile,
                  stream_mb_per_epoch=round(stream_b / 2**20, 1),
                  stream_bytes_per_rating=round(stream_b / nnz, 2),
                  wire_mb_per_epoch=round(comp.nbytes / 2**20, 1),
                  wire_bytes_per_rating=round(comp.nbytes / nnz, 2))
    if args.prep_only:
        emit(result)
        return

    from ycnr_tpu_torch.models.base import init_state
    from ycnr_tpu_torch.models.ooc import device_hbm_stats
    from ycnr_tpu_torch.models.sgd_stream import StreamSGD

    # accumulate in f64 without materializing an 8x f64 copy of the
    # rating column
    if comp.rating_kind == "half":
        mu_r = float(np.asarray(comp.rq).sum(dtype=np.float64) * 0.5 / nnz)
    else:
        mu_r = float(np.asarray(comp.rq).sum(dtype=np.float64) / nnz)
    data = None
    if args.sgd_wire == "flat" or args.compare:
        t0 = time.time()
        data = flat_from_compact(comp)
        log(f"flat stream decode (host): {time.time() - t0:.0f}s")
    wire = comp
    if args.sgd_wire == "compact":
        pin = args.residency == "device"
        if args.residency == "auto":
            # same semantics as train/loop.py: pin only when the wire
            # fits sgd_wire_budget; beyond-budget scales stream from the
            # host instead of running out of memory
            from ycnr_tpu_torch.ops.sgd_wire import sgd_wire_budget

            budget = (int(args.budget_gb * 2**30) if args.budget_gb
                      else sgd_wire_budget(nu, ni, args.rank,
                                           device=device))
            pin = comp.nbytes <= budget
            log(f"auto residency: wire {comp.nbytes / 2**30:.2f} GB vs "
                f"budget {budget / 2**30:.2f} GB -> "
                f"{'pin' if pin else 'host stream'}")
        if pin:
            t0 = time.time()
            wire = put_compact(wire, device)
            sync(device)
            log(f"wire pin (device): {time.time() - t0:.0f}s")
            result["pinned"] = True
    else:
        wire = data
        if args.residency != "host":
            raise SystemExit("--sgd-wire flat only streams (--residency "
                             "host); the flat slabs ARE the decoded "
                             "layout — keeping them on the card is the "
                             "--compare resident rung")
    trainer = StreamSGD(lam=0.02, lr=0.01, seed=0)
    state = init_state(nu, ni, args.rank, seed=0, mu=mu_r, device=device)
    sync(device)
    ep = [0]

    def step(s):
        s = trainer.epoch(s, wire, ep[0])
        ep[0] += 1
        return s

    label = f"{args.sgd_wire}-sgd" + ("-pinned" if result.get("pinned")
                                      else "-streamed")
    ho_fn = (heldout_rmse_fn(args.scale, device)
             if args.rmse or args.compare else None)
    if args.rmse:
        rmse_fn = _sgd_sample_rmse_fn(comp, ni, device)
        rmses = [round(rmse_fn(state), 4)]
        hos = [round(ho_fn(state), 4)]
        log(f"init: sample train RMSE {rmses[0]} held-out {hos[0]}")
        times = []
        for e in range(args.epochs):
            t0 = time.time()
            state = step(state)
            sync(device)
            times.append(time.time() - t0)
            rmses.append(round(rmse_fn(state), 4))  # untimed
            hos.append(round(ho_fn(state), 4))
            log(f"{label} epoch {e}: {times[-1]:.3f}s rmse {rmses[-1]} "
                f"held-out {hos[-1]}")
        t_ooc = {"first_s": round(times[0], 3),
                 "steady_s": round(min(times[1:]) if len(times) > 1
                                   else times[0], 3)}
        result["train_rmse_sample"] = rmses
        result["heldout_rmse"] = hos
    else:
        state, t_ooc = time_epochs(step, state, args.epochs, label, device)
    result["ooc"] = t_ooc
    if t_ooc.get("steady_s") and not result.get("pinned"):
        moved = wire.nbytes if args.sgd_wire == "compact" else stream_b
        result["ooc"]["wire_MBps_effective"] = round(
            moved / 2**20 / t_ooc["steady_s"], 1)
    result["hbm"] = device_hbm_stats(device)
    if args.compare:
        ooc_state = state
        dev = bench.stream_to_device(data, device)
        state = init_state(nu, ni, args.rank, seed=0, mu=mu_r,
                           device=device)
        sync(device)
        ep[0] = 0

        def rstep(s):
            s = trainer.epoch(s, dev, ep[0])
            ep[0] += 1
            return s

        state, t_res = time_epochs(rstep, state, args.epochs,
                                   "resident-sgd", device)
        result["resident"] = t_res
        result["ooc_vs_resident"] = (
            round(t_ooc["steady_s"] / t_res["steady_s"], 2)
            if t_res["steady_s"] > 0 else None)
        result["compare"] = _compare(ooc_state, state, ho_fn)
    emit(result)


def _compare(ooc_state, res_state, ho_ooc, ho_res=None) -> dict:
    """The out-of-core run's final state against the resident run's: the
    held-out RMSE of each (``ho_res`` for the resident tables where they
    are in another order than the out-of-core ones) and whether the
    factors are equal bit for bit (``None`` for tables in another
    order)."""
    return {"heldout_rmse_ooc": ho_ooc(ooc_state),
            "heldout_rmse_resident": (ho_res or ho_ooc)(res_state),
            "factors_equal": (None if ho_res is not None
                              else _factors_equal(ooc_state, res_state))}


def _model_peak(args, ug, ig, nu: int, ni: int, result: dict,
                plans) -> int:
    """The device bytes an out-of-core epoch should peak at, from what it
    holds: the f32 factor tables (storage-ordered ones with ``plans``),
    the phase's bf16 gather copy (under models/ooc._BF16_COPY_MAX_BYTES),
    the pinned wire, ``prefetch + 1`` streamed chunks and the widest
    decoded block's rows (index, rating, the bf16 gather, the f32 solve
    row). The JAX package's model also counts its wire-ordered solve
    table, which the port does not hold."""
    from ycnr_tpu_torch.models.ooc import _BF16_COPY_MAX_BYTES, \
        group_resident

    k = args.rank
    groups = [g for gr in (ug, ig) for g in gr]
    group_b = [sum(getattr(g, n).nbytes for n in ("lo", "hi_pos", "hi_val",
                                                    "rat", "cnt", "eid"))
               for g in groups]
    per_blk = [b // g.n_blocks for b, g in zip(group_b, groups)]
    chunk_b = (args.chunk_blocks * max(per_blk) if args.chunk_blocks
               else min(48 * 2**20, max(group_b)))
    slots = max(int(g.cnt.sum(1).max()) for g in groups)
    pinned_b = result.get("residency", {}).get("hbm_pinned_mb", 0) * 2**20
    streamed_any = any(not group_resident(g) for g in groups)
    rows = ((plans[0].table_rows, plans[1].table_rows) if plans
            else (nu + 1, ni + 1))
    factors_b = sum(rows) * k * 4
    bf16_b = max(rows) * k * 2
    if bf16_b > _BF16_COPY_MAX_BYTES:
        bf16_b = 0  # the phase gathers in f32 above the cap
    return int(factors_b + bf16_b + pinned_b
               + (args.prefetch + 1) * chunk_b * streamed_any
               + slots * (4 + 4 + k * 2 + k * 4))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scale", choices=list(SCALES), default="netflix")
    ap.add_argument("--algo", choices=["als", "ials", "sgd"], default="als")
    ap.add_argument("--epochs", type=int, default=3)
    ap.add_argument("--rank", type=int, default=64)
    ap.add_argument("--groups", type=int, default=8)
    ap.add_argument("--prefetch", type=int, default=2,
                    help="wire chunks kept in flight")
    ap.add_argument("--chunk-blocks", type=int, default=None,
                    help="blocks per wire chunk (default: auto ~48 MB)")
    ap.add_argument("--wire", choices=["rect", "packed"], default="packed",
                    help="wire format: packed (minimal bytes, the default) "
                    "or rect (padded rectangles, gather-free decode)")
    ap.add_argument("--residency", choices=["host", "auto", "device"],
                    default="host",
                    help="wire residency: host = stream every epoch "
                    "(measures the wire-bound tier), auto/device = pin "
                    "groups on the card via models.ooc.wire_to_device "
                    "(measures the compressed resident tier)")
    ap.add_argument("--prep-only", action="store_true",
                    help="build + cache the wire on the host (no device "
                    "touched), then exit")
    ap.add_argument("--sgd-wire", choices=["flat", "compact"],
                    default="compact",
                    help="--algo sgd stream format: compact = the 5-9 "
                    "B/rating ops/sgd_wire encoding (supports pinning "
                    "via --residency auto/device), flat = the 20 "
                    "B/rating [NB, B] slabs (stream-only)")
    ap.add_argument("--rmse", action="store_true",
                    help="also compute the RMSE after each epoch (timed "
                    "separately)")
    ap.add_argument("--budget-gb", type=float, default=None,
                    help="override the auto residency budget (GB of "
                    "device memory for pinned wire groups)")
    ap.add_argument("--storage", choices=["entity", "wire"],
                    default="entity",
                    help="factor-table storage order (--algo als/ials): "
                    "entity = classic (solved rows written by entity id), "
                    "wire = WIRE-ORDER STORAGE (tables live in wire order, "
                    "blocks write in place; needs a _ws wire cache built "
                    "with relabeled ids)")
    ap.add_argument("--pin-format", choices=["auto", "keep"],
                    default="auto",
                    help="auto = upgrade pinned groups to RECT (gather-"
                    "free decode) when the budget allows, packed "
                    "fallback; keep = pin in the loaded format")
    ap.add_argument("--compare", action="store_true",
                    help="also time the resident bucketed epoch")
    ap.add_argument("--probe", action="store_true",
                    help="only run the wire-speed probe")
    ap.add_argument("--target-mb", type=int, default=192,
                    help="wire block target size (decoded MB)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card, 'cuda'; 'cpu' "
                    "for a CPU run)")
    args = ap.parse_args(argv)
    # one JSON object a measurement on stdout; prints of the modules and
    # build output go to stderr
    with json_stdout() as emit:
        return _run(args, emit)


def _run(args, emit):
    import torch

    from ycnr_tpu_torch import full_precision_matmul
    from ycnr_tpu_torch.models.base import MFState, init_state
    from ycnr_tpu_torch.models.ooc import (als_epoch_ooc, device_hbm_stats,
                                           group_resident, ials_epoch_ooc)
    from ycnr_tpu_torch.ops.packed import packed_stats

    if args.prep_only:
        # pure host work: the device is never touched
        result = {"scale": args.scale, "algo": args.algo, "rank": args.rank}
        if args.algo == "sgd":
            run_sgd_ooc(args, result, emit)
            return result
        ug, ig, nnz, _ = build_or_load_wire(
            args.scale, args.wire, args.groups, args.target_mb,
            rank=args.rank, storage=args.storage)
        wb = packed_stats(ug, nnz)["wire_bytes"] + \
            packed_stats(ig, nnz)["wire_bytes"]
        result.update(wire=args.wire, nnz=nnz, storage=args.storage,
                      wire_mb_per_epoch=round(wb / 2**20, 1),
                      wire_bytes_per_rating=round(wb / nnz, 2))
        emit(result)
        return result

    device = torch.device(tool_device(args, "bench_ooc"))
    full_precision_matmul()
    log(f"device: {device}")
    result = {"scale": args.scale, "algo": args.algo, "rank": args.rank,
              "wire": args.wire, "wire_MBps": wire_probe(device)}
    log(f"wire probe: {result['wire_MBps']}")
    if args.probe:
        emit(result)
        return result

    if args.algo == "sgd":
        del result["wire"]  # sgd streams [NB, B] batch slabs, not the wire
        run_sgd_ooc(args, result, emit, device)
        return result

    nu, ni, nr = SCALES[args.scale]
    lam, alpha = 0.05, 40.0

    ug, ig, nnz, extras = build_or_load_wire(
        args.scale, args.wire, args.groups, args.target_mb,
        rank=args.rank, storage=args.storage)
    st_u = packed_stats(ug, nnz)
    st_i = packed_stats(ig, nnz)
    log(f"user wire: {st_u}")
    log(f"item wire: {st_i}")
    wire_mb = (st_u["wire_bytes"] + st_i["wire_bytes"]) / 2**20
    result.update(nnz=nnz, n_users=nu, n_items=ni, storage=args.storage,
                  wire_mb_per_epoch=round(wire_mb, 1),
                  wire_bytes_per_rating=round(
                      (st_u["wire_bytes"] + st_i["wire_bytes"]) / nnz, 2))

    wire_storage = args.storage == "wire"
    if wire_storage:
        # factor tables live in wire order: the plans carry the block
        # offsets; the eids map to storage rows here on the host (small
        # arrays), padding -> the table's zero row
        from ycnr_tpu_torch.models.ooc import DeviceWirePlan

        up_h, ip_h = extras["u_plan"], extras["i_plan"]

        def _map_eids(groups, plan, n_e):
            out = []
            for g in groups:
                e = np.asarray(g.eid)
                m = np.where(e < n_e, plan.perm[np.minimum(e, n_e - 1)],
                             plan.zero_row).astype(np.int32)
                out.append(g._replace(eid=m))
            return tuple(out)

        ug = _map_eids(ug, up_h, nu)
        ig = _map_eids(ig, ip_h, ni)
        u_pd, i_pd = DeviceWirePlan(up_h), DeviceWirePlan(ip_h)

    if args.residency != "host":
        from ycnr_tpu_torch.models.ooc import auto_wire_budget, \
            wire_to_device

        budget = (int(args.budget_gb * 2**30) if args.budget_gb
                  else None if args.residency == "device"
                  else auto_wire_budget(
                      nu, ni, args.rank, groups=(ug, ig),
                      storage=args.storage,
                      table_rows=((up_h.table_rows, ip_h.table_rows)
                                  if wire_storage else None),
                      prefetch=args.prefetch, device=device))
        t0 = time.time()
        ug, ig, pinned = wire_to_device(ug, ig, budget,
                                        pin_format=args.pin_format,
                                        device=device)
        sync(device)
        host_mb = sum(
            getattr(g, n).nbytes
            for gr in (ug, ig) for g in gr
            for n in ("lo", "hi_pos", "hi_val", "rat", "cnt", "eid")
            if not group_resident(g)) / 2**20
        result["residency"] = {
            "mode": args.residency,
            "formats": sorted({("rect" if g.lo.ndim == 3 else "packed")
                               + (":hbm" if group_resident(g)
                                  else ":host")
                               for gr in (ug, ig) for g in gr}),
            "hbm_pinned_mb": round(pinned / 2**20, 1),
            "streamed_mb": round(host_mb, 1),
            "pin_upload_s": round(time.time() - t0, 3)}
        log(f"residency: {result['residency']}")

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    hbm0 = device_hbm_stats(device)
    if wire_storage:
        from ycnr_tpu_torch.models.ooc import (als_epoch_wire,
                                               ials_epoch_wire,
                                               wire_storage_init)

        # storage-ordered init with init_state's exact per-entity draws
        # (one RNG stream, users then items — see wire_storage_init)
        dU = wire_storage_init(up_h, args.rank, seed=0, device=device)
        dV = wire_storage_init(ip_h, args.rank, seed=0, entity_offset=nu,
                               device=device)
        state = MFState(
            U=dU, V=dV,
            bu=torch.zeros(up_h.table_rows, device=device),
            bi=torch.zeros(ip_h.table_rows, device=device),
            mu=torch.zeros((), device=device))
        epoch_wire = (ials_epoch_wire if args.algo == "ials"
                      else als_epoch_wire)
        ialpha = (alpha,) if args.algo == "ials" else ()

        def ooc_step(s):
            U, V = epoch_wire(s.U, s.V, ug, ig, lam, *ialpha,
                              u_plan=u_pd, i_plan=i_pd, gather_bf16=True,
                              prefetch=args.prefetch,
                              chunk_blocks=args.chunk_blocks)
            return s._replace(U=U, V=V)
    elif args.algo == "ials":
        state = init_state(nu, ni, args.rank, seed=0, device=device)

        def ooc_step(s):
            return ials_epoch_ooc(s, ug, ig, lam, alpha, gather_bf16=True,
                                  prefetch=args.prefetch,
                                  chunk_blocks=args.chunk_blocks)
    else:
        state = init_state(nu, ni, args.rank, seed=0, device=device)

        def ooc_step(s):
            return als_epoch_ooc(s, ug, ig, lam, gather_bf16=True,
                                 prefetch=args.prefetch,
                                 chunk_blocks=args.chunk_blocks)
    sync(device)

    ho_fn = None
    if args.rmse or args.compare:
        ho_fn = (heldout_rmse_fn_mapped(args.scale, up_h.perm, ip_h.perm,
                                        device)
                 if wire_storage else heldout_rmse_fn(args.scale, device))
    if args.rmse:
        from ycnr_tpu_torch.models.ooc import rmse_wire

        # per-epoch held-out from a sample kept on the card (costs ~ms);
        # the train rmse_wire ONCE at the end — it re-streams the host
        # share of the user view
        hos = [round(ho_fn(state), 4)]
        log(f"init: held-out RMSE {hos[0]}")
        for ep in range(args.epochs):
            t0 = time.time()
            state = ooc_step(state)
            sync(device)
            dt = time.time() - t0
            hos.append(round(ho_fn(state), 4))  # untimed, ~ms
            log(f"ooc epoch {ep}: {dt:.3f}s held-out {hos[-1]}")
            if ep == 0:
                t_ooc = {"first_s": round(dt, 3), "steady_s": None}
            else:
                t_ooc["steady_s"] = (round(dt, 3)
                                     if t_ooc["steady_s"] is None
                                     else min(t_ooc["steady_s"],
                                              round(dt, 3)))
        t0 = time.time()
        result["train_rmse_final"] = round(rmse_wire(state, ug, nnz), 6)
        result["train_rmse_eval_s"] = round(time.time() - t0, 3)
        result["heldout_rmse"] = hos
        log(f"final train rmse {result['train_rmse_final']} "
            f"(+{result['train_rmse_eval_s']}s wire eval)")
        if len(hos) > 1 and not hos[-1] < hos[0]:
            log(f"WARNING: RMSE not descending: {hos}")
    else:
        state, t_ooc = time_epochs(ooc_step, state, args.epochs, "ooc",
                                   device)
    hbm1 = device_hbm_stats(device)
    result["ooc"] = t_ooc
    if t_ooc.get("steady_s"):
        result["ooc"]["wire_MBps_effective"] = round(
            wire_mb / t_ooc["steady_s"], 1)
    result["hbm"] = {"before": hbm0, "after_peak": hbm1}
    if hbm1:
        result["hbm"]["peak_gb"] = round(
            hbm1.get("peak_bytes_in_use", 0) / 2**30, 2)
        result["hbm"]["limit_gb"] = round(
            hbm1.get("bytes_limit", 0) / 2**30, 2)
    result["hbm"]["model_peak_gb"] = round(
        _model_peak(args, ug, ig, nu, ni, result,
                    (up_h, ip_h) if wire_storage else None) / 2**30, 2)
    if result["hbm"].get("after_peak"):
        # reset when the epochs began: the peak of this run alone
        result["hbm"]["note"] = ("after_peak counts from the first ooc "
                                 "epoch, the resident run excluded")

    if args.compare:
        from ycnr_tpu_torch.models.bucketed_phase import (als_epoch_fn,
                                                          device_bucketed,
                                                          ials_epoch_fn,
                                                          uses_fused)

        ooc_state = state
        # cache hits: the wire build above generated this COO, and the
        # layouts share the bench's tags
        tu, ti, tr, nu, ni = get_coo(args.scale)
        ul, il = bench.cached_layouts(
            tu, ti, tr, nu, ni, 32, args.rank, "bucketed", args.groups,
            bench.coo_tag(nu, ni, nr, 0))
        a = alpha if args.algo == "ials" else None
        rdt = (torch.bfloat16 if uses_fused(device, torch.float32, a, True,
                                            args.rank) else None)
        dul = device_bucketed(ul, device=device, rating_dtype=rdt)
        dil = device_bucketed(il, device=device, rating_dtype=rdt)
        del ul, il
        state = init_state(nu, ni, args.rank, seed=0, device=device)
        sync(device)
        if args.algo == "ials":
            res_epoch = ials_epoch_fn(dul, dil, lam, alpha, gather_bf16=True)
        else:
            res_epoch = als_epoch_fn(dul, dil, lam, gather_bf16=True)
        state, t_res = time_epochs(res_epoch, state, args.epochs,
                                   "resident", device)
        result["resident"] = t_res
        result["ooc_vs_resident"] = (
            round(t_ooc["steady_s"] / t_res["steady_s"], 2)
            if t_res["steady_s"] > 0 else None)
        # wire-order tables: the resident run's in entity order
        result["compare"] = _compare(
            ooc_state, state, ho_fn,
            heldout_rmse_fn(args.scale, device) if wire_storage else None)

    emit(result)
    return result


if __name__ == "__main__":
    main()
