"""Single-GPU training loop (counterpart of the single-chip path of
``ycnr_tpu/train/loop.py``).

Runs any of the algorithm families from a RunConfig — ALS-WR and iALS on
the bucketed layout, biased SGD (batched and stream) and BPR — with
per-epoch held-out RMSE (``1 - hit_rate`` for BPR), JSONL metrics, early
stopping, checkpoints with resume, warm start, and the factors published
into shared memory after every epoch (``cfg.publish_shm``). With
``cfg.ooc`` ALS/iALS train from the packed or RECT rating wire
(``models/ooc.py``) and stream SGD from the host stream or its compact
wire (``ops/sgd_wire.py``), pinned on the device or streamed from host
memory as ``cfg.ooc_residency`` says. With ``cfg.mesh.n_shards > 1`` it
trains sharded over ``torch.distributed`` (``train/sharded.py``), with
``cfg.ooc`` from the wire sliced across the ranks
(``parallel/ooc_mesh.py``). Orbax checkpoints are not ported and are
refused.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ycnr_tpu_torch import full_precision_matmul, resolve_device
from ycnr_tpu_torch.config import RunConfig
from ycnr_tpu_torch.data.dataset import Dataset, load_dataset
from ycnr_tpu_torch.eval.ranking import hit_rate_at_n, ranking_metrics_at_n
from ycnr_tpu_torch.models.base import (
    MFState,
    grow_state,
    init_state,
    rmse_padded,
    zero_cold_entities,
)
from ycnr_tpu_torch.models.bpr import BPRTrainer, prepare_bpr_data
from ycnr_tpu_torch.models.bucketed_phase import (
    als_epoch_fn,
    als_epochs_bucketed,
    device_bucketed,
    ials_epoch_fn,
    ials_epochs_bucketed,
    uses_fused,
)
from ycnr_tpu_torch.models.ooc import (
    als_epoch_ooc,
    auto_wire_budget,
    group_resident,
    ials_epoch_ooc,
    wire_nbytes,
    wire_to_device,
)
from ycnr_tpu_torch.models.sgd import BiasedSGD, prepare_sgd_data
from ycnr_tpu_torch.models.sgd_stream import StreamSGD, prepare_stream_sgd
from ycnr_tpu_torch.ops.bucketed import build_bucketed
from ycnr_tpu_torch.ops.layout import pad_coo
from ycnr_tpu_torch.ops.packed import build_packed, build_rect
from ycnr_tpu_torch.ops.sgd_wire import (
    compact_from_stream,
    compact_resident,
    put_compact,
    sgd_wire_budget,
)
from ycnr_tpu_torch.train.checkpoint import (
    config_dict,
    load_checkpoint,
    save_checkpoint,
)
from ycnr_tpu_torch.train.metrics import MetricsLogger


@dataclass
class TrainResult:
    state: MFState
    dataset: Dataset
    rmse_history: list
    out_dir: Optional[str]


def _check_supported(cfg: RunConfig):
    if cfg.ooc and cfg.ooc_wire not in ("rect", "packed"):
        raise ValueError(f"ooc_wire must be 'rect' or 'packed', got "
                         f"{cfg.ooc_wire!r}")
    if cfg.ooc and cfg.ooc_residency not in ("auto", "device", "host"):
        raise ValueError(f"ooc_residency must be 'auto', 'device' or "
                         f"'host', got {cfg.ooc_residency!r}")
    if cfg.mesh.n_shards > 1 and cfg.ooc:
        if cfg.algorithm not in ("als", "ials"):
            raise ValueError(
                "ooc=True on a mesh supports als/ials (mode-A wire "
                "sharding, parallel/ooc_mesh.py); sgd/bpr stream-OOC "
                "is single-chip")
        if cfg.mesh.vstep_mode == "item_sharded":
            raise ValueError("ooc=True shards the wire mode-A "
                             "(gram_psum); item_sharded is resident-only")
    if cfg.ooc and not (cfg.algorithm in ("als", "ials")
                        or (cfg.algorithm == "sgd"
                            and cfg.sgd.method == "stream")):
        raise ValueError("ooc=True supports als/ials and stream-SGD "
                         "(--sgd-method stream); the batched-SGD/BPR "
                         "layouts are per-batch device data")
    if cfg.checkpoint_backend != "npz":
        raise NotImplementedError("orbax checkpoints are not ported")


def _algo_params(cfg: RunConfig):
    return {"als": cfg.als, "sgd": cfg.sgd, "ials": cfg.ials,
            "bpr": cfg.bpr}[cfg.algorithm]


def _early_stop(cfg: RunConfig, history: list, metrics, epoch: int) -> bool:
    """True when the last `patience` epochs brought no improvement of at
    least min_delta over the best RMSE before them. Checkpoints carry the
    RMSE history (manifest extra), so a resumed run's window spans the
    WHOLE trajectory, not just post-resume epochs."""
    p = cfg.early_stop_patience
    if p <= 0 or len(history) <= p:
        return False
    if min(history[-p:]) > min(history[:-p]) - cfg.early_stop_min_delta:
        metrics.log(event="early_stop", epoch=epoch,
                    best_rmse=round(min(history), 6))
        return True
    return False


def _ckpt_extra(history: list) -> dict:
    """Manifest payload that lets a resumed run continue its early-stop
    window where it left off."""
    return {"rmse_history": [round(float(x), 6) for x in history]}


def _resumed_history(manifest) -> list:
    return list(manifest.get("extra", {}).get("rmse_history", []))


def _start_state(cfg: RunConfig, ds: Dataset, params, resume, warm_start,
                 metrics, mu: float, dtype, device):
    """(state, start_epoch, rmse_history) for every train path.

    resume = continue the SAME run (epoch counter + early-stop history carry
    over); warm_start = start a NEW run from a previous run's factors, grown
    to the current dataset's catalog (models/base.grow_state)."""
    if resume and warm_start:
        raise ValueError("resume and warm_start are mutually exclusive: "
                         "resume continues a run, warm_start begins a new "
                         "one from its factors")
    if resume:
        state, manifest = load_checkpoint(resume, device=device)
        metrics.log(event="resume", epoch=manifest["epoch"])
        return state, manifest["epoch"], _resumed_history(manifest)
    if warm_start:
        state, manifest = load_checkpoint(warm_start, device=device)
        if manifest["rank"] != params.rank:
            raise ValueError(
                f"warm-start checkpoint rank {manifest['rank']} != config "
                f"rank {params.rank} (factor growth is catalog-only)")
        state = grow_state(state, ds.n_users, ds.n_items, seed=cfg.seed)
        metrics.log(event="warm_start", from_epoch=manifest["epoch"],
                    new_users=ds.n_users - manifest["n_users"],
                    new_items=ds.n_items - manifest["n_items"])
        return state, 0, []
    return init_state(ds.n_users, ds.n_items, params.rank, seed=cfg.seed,
                      mu=mu, dtype=dtype, device=device), 0, []


def _shm_writer(cfg: RunConfig, state: MFState):
    """The live-factor publisher of ``cfg.publish_shm``, or None."""
    if not cfg.publish_shm:
        return None
    from ycnr_tpu_torch.serve.shm import FactorShmWriter

    return FactorShmWriter(cfg.publish_shm, state.n_users, state.n_items,
                           state.rank)


def _bucketed_layouts(cfg: RunConfig, ds: Dataset, params, dtype, device):
    """The user and item bucketed layouts of an ALS/iALS run on ``device``
    (ratings in bf16 where the phase runs the fused branch)."""
    bf16 = params.gather_dtype == "bfloat16"
    alpha = None if cfg.algorithm == "als" else cfg.ials.alpha
    rating_dtype = (torch.bfloat16
                    if uses_fused(device, dtype, alpha, bf16, params.rank)
                    else dtype)
    return tuple(device_bucketed(build_bucketed(
        a, b, ds.train_r, na, nb, cfg.data.chunk_len, params.rank,
        max_groups=cfg.data.max_groups), dtype, device, rating_dtype)
        for a, b, na, nb in ((ds.train_u, ds.train_i, ds.n_users, ds.n_items),
                             (ds.train_i, ds.train_u, ds.n_items,
                              ds.n_users)))


def _ooc_wire(cfg: RunConfig, ds: Dataset, params, device, metrics):
    """The user and item rating wire of an out-of-core ALS/iALS run:
    packed or RECT (``cfg.ooc_wire``), pinned on ``device`` as
    ``cfg.ooc_residency`` says ("auto": whole groups under
    ``auto_wire_budget``, largest first; "device": all of it, or an
    error; "host": none), the rest streamed every epoch."""
    build = build_rect if cfg.ooc_wire == "rect" else build_packed
    dul = build(ds.train_u, ds.train_i, ds.train_r, ds.n_users, ds.n_items,
                params.rank, max_groups=cfg.data.max_groups)
    dil = build(ds.train_i, ds.train_u, ds.train_r, ds.n_items, ds.n_users,
                params.rank, max_groups=cfg.data.max_groups)
    if cfg.ooc_residency != "host":
        budget = (None if cfg.ooc_residency == "device"
                  else auto_wire_budget(ds.n_users, ds.n_items, params.rank,
                                        groups=(dul, dil), device=device))
        dul, dil, pinned = wire_to_device(dul, dil, budget, device=device)
        streamed = wire_nbytes(
            [g for g in (*dul, *dil) if not group_resident(g)])
        metrics.log(event="ooc_residency", hbm_pinned_bytes=pinned,
                    streamed_bytes=streamed)
    return dul, dil


def _ooc_stream(cfg: RunConfig, ds: Dataset, params, data, device,
                metrics):
    """An out-of-core stream-SGD run's data: the host stream ``data`` as
    the compact wire, pinned on ``device`` when ``cfg.ooc_residency``
    allows ("auto": if it fits ``sgd_wire_budget``), else streamed; the
    flat host stream where the compact wire cannot encode it."""
    try:
        comp = compact_from_stream(data, ds.n_items)
    except ValueError as e:
        # batch beyond u16, or f64 ratings off the f32 wire
        metrics.log(event="sgd_wire_fallback", reason=str(e))
        return data
    wire_bytes = comp.nbytes  # counted on the host wire
    if cfg.ooc_residency != "host":
        budget = (None if cfg.ooc_residency == "device"
                  else sgd_wire_budget(ds.n_users, ds.n_items, params.rank,
                                       device=device))
        if budget is None or wire_bytes <= budget:
            comp = put_compact(comp, device)
    metrics.log(event="sgd_wire", format="compact", wire_bytes=wire_bytes,
                hbm_pinned=compact_resident(comp))
    return comp


def _epoch_fn(cfg: RunConfig, ds: Dataset, params, dtype, device, metrics):
    """``(state, epoch_idx) -> state`` for the configured algorithm, with
    its training data laid out on ``device`` (or, out of core, as its
    wire)."""
    if cfg.algorithm in ("als", "ials"):
        bf16 = params.gather_dtype == "bfloat16"
        if cfg.ooc:
            dul, dil = _ooc_wire(cfg, ds, params, device, metrics)
            if cfg.algorithm == "als":
                return lambda state, epoch: als_epoch_ooc(
                    state, dul, dil, cfg.als.lam, gather_bf16=bf16)
            return lambda state, epoch: ials_epoch_ooc(
                state, dul, dil, cfg.ials.lam, cfg.ials.alpha,
                gather_bf16=bf16)
        # single-device fast path: bucketed (segsum-free) layout
        dul, dil = _bucketed_layouts(cfg, ds, params, dtype, device)
        if cfg.algorithm == "als":
            fn = als_epoch_fn(dul, dil, cfg.als.lam, bf16)
        else:
            fn = ials_epoch_fn(dul, dil, cfg.ials.lam, cfg.ials.alpha, bf16)
        return lambda state, epoch: fn(state)
    if cfg.algorithm == "bpr":
        trainer = BPRTrainer(cfg.bpr.lam, cfg.bpr.lr, cfg.bpr.lr_decay,
                             cfg.bpr.batch_size, seed=cfg.seed,
                             grad_mode=cfg.bpr.grad_mode,
                             shuffle=cfg.bpr.shuffle)
        data = prepare_bpr_data(
            ds.train_u, ds.train_i, cfg.bpr.batch_size, ds.n_users,
            ds.n_items,
            # composition seed is FIXED (0): any random partition works,
            # and keeping it config-independent lets a grid entry
            # reproduce as a standalone run at any seed
            shuffle_rows_seed=(0 if cfg.bpr.shuffle == "batches" else None),
            device=device)
    elif cfg.sgd.method == "stream":
        # stream order concentrates a user's ratings, the case "sum"
        # diverges on (models/sgd.py docstring) — "capped" reproduces the
        # shuffled path's effective step sizes safely (sgd_stream.py)
        gm = "capped" if cfg.sgd.grad_mode == "sum" else cfg.sgd.grad_mode
        trainer = StreamSGD(cfg.sgd.lam, cfg.sgd.lr, cfg.sgd.lr_decay,
                            seed=cfg.seed, grad_mode=gm)
        # out of core, the stream stays on the host (NumPy)
        data, _ = prepare_stream_sgd(
            ds.train_u, ds.train_i, ds.train_r, cfg.sgd.batch_size,
            ds.n_users, ds.n_items, seed=cfg.seed, dtype=dtype,
            grad_mode=gm, device=False if cfg.ooc else device)
        if cfg.ooc:
            data = _ooc_stream(cfg, ds, params, data, device, metrics)
    else:
        trainer = BiasedSGD(cfg.sgd.lam, cfg.sgd.lr, cfg.sgd.lr_decay,
                            cfg.sgd.batch_size, seed=cfg.seed,
                            grad_mode=cfg.sgd.grad_mode)
        data = prepare_sgd_data(ds.train_u, ds.train_i, ds.train_r,
                                cfg.sgd.batch_size, ds.n_users, ds.n_items,
                                dtype, device=device)
    return lambda state, epoch: trainer.epoch(state, data, epoch)


def train(cfg: RunConfig, dataset: Optional[Dataset] = None,
          resume: Optional[str] = None, warm_start: Optional[str] = None,
          out_dir: Optional[str] = None, device=None, mesh=None,
          backend: Optional[str] = None) -> TrainResult:
    """Train per config on ``device`` (default ``"cuda"``). Without a CUDA
    device the default raises; a CPU run passes ``device="cpu"``.

    ``cfg.mesh.n_shards > 1`` trains sharded (``train/sharded.py``): as
    the rank of ``mesh`` when given, as this process's rank inside a
    process group, else over ``n_shards`` rank processes started here.
    With ``cfg.ooc`` (ALS-WR / iALS, gram_psum) each rank trains from its
    slice of the rating wire pinned on its device, whatever
    ``cfg.ooc_residency`` says, as the JAX package does.
    ``backend`` (for that launch) None means NCCL on the card and gloo
    with ``device="cpu"``; NCCL needs a card a rank."""
    _check_supported(cfg)
    full_precision_matmul()
    if cfg.mesh.n_shards > 1:
        from ycnr_tpu_torch.train.sharded import train_sharded

        return train_sharded(cfg, dataset, resume, warm_start, out_dir,
                             device, mesh, backend)
    device = resolve_device(device, "train()")
    params = _algo_params(cfg)
    ds = dataset or load_dataset(cfg.data, rank_hint=params.rank)
    out = out_dir if out_dir is not None else (
        os.path.join(cfg.out_dir, cfg.name) if cfg.out_dir else None)
    metrics = MetricsLogger(os.path.join(out, "metrics.jsonl") if out
                            else None, append=bool(resume))
    dtype = getattr(torch, params.dtype)
    mu = ds.mu if cfg.algorithm == "sgd" else 0.0
    state, start_epoch, history = _start_state(
        cfg, ds, params, resume, warm_start, metrics, mu, dtype, device)
    state = zero_cold_entities(state, ds.train_u, ds.train_i)

    def coo(arrays):
        pu, pi, pr, n = arrays
        return tuple(torch.as_tensor(x, device=device)
                     for x in (pu, pi, pr)) + (n,)

    test_coo = coo(ds.padded_test())
    train_coo = (coo(pad_coo(ds.train_u, ds.train_i, ds.train_r, ds.n_users,
                             ds.n_items))
                 if cfg.log_train_rmse and cfg.algorithm != "bpr" else None)

    def hit_rate():
        return hit_rate_at_n(state, ds.train_u, ds.train_i, ds.test_u,
                             ds.test_i, n=cfg.topn, max_users=512)

    shm_writer = _shm_writer(cfg, state)
    # fused_epochs is not applied to out-of-core runs, as in the reference
    if (cfg.fused_epochs > 1 and cfg.algorithm in ("als", "ials")
            and not cfg.ooc):
        state = _fused_epoch_blocks(cfg, ds, params, state, start_epoch,
                                    history, dtype, device, test_coo,
                                    train_coo, metrics, out, shm_writer)
        epochs_done = params.epochs  # the blocks ran everything
    else:
        epochs_done = start_epoch
        epoch_fn = _epoch_fn(cfg, ds, params, dtype, device, metrics)
    for epoch in range(epochs_done, params.epochs):
        t0 = time.time()
        state = epoch_fn(state, epoch)
        if state.U.is_cuda:
            torch.cuda.synchronize(state.U.device)
        epoch_s = time.time() - t0
        if cfg.algorithm == "bpr":
            # BPR scores are unscaled ranking logits — RMSE vs ratings is
            # meaningless; the per-epoch quality metric (and the early-stop
            # history) is 1 - hit-rate@N (lower = better, like RMSE)
            hr = hit_rate()
            history.append(1.0 - hr)
            record = dict(epoch=epoch + 1, hit_rate=round(hr, 4),
                          epoch_s=round(epoch_s, 4), algo="bpr")
        else:
            rmse = float(rmse_padded(state, *test_coo))
            history.append(rmse)
            record = dict(epoch=epoch + 1, rmse_test=round(rmse, 6),
                          epoch_s=round(epoch_s, 4), algo=cfg.algorithm)
            if train_coo is not None:
                record["rmse_train"] = round(
                    float(rmse_padded(state, *train_coo)), 6)
            if cfg.algorithm == "ials" or cfg.log_hit_rate:
                # RMSE vs raw ratings is not meaningful for preference
                # scores (and log_hit_rate asks for ranking quality from
                # the explicit trainers too); report the ranking metric
                record["hit_rate"] = round(hit_rate(), 4)
        metrics.log(**record)
        stop = _early_stop(cfg, history, metrics, epoch + 1)
        if out and cfg.checkpoint_every and (
                (epoch + 1) % cfg.checkpoint_every == 0
                or epoch + 1 == params.epochs or stop):
            save_checkpoint(os.path.join(out, "ckpt"), state, epoch + 1,
                            config=config_dict(cfg),
                            extra=_ckpt_extra(history))
        if shm_writer is not None:
            shm_writer.publish(state, epoch + 1)
        if stop:
            break
    if shm_writer is not None:
        shm_writer.close()
    if (cfg.algorithm in ("ials", "bpr") or cfg.log_hit_rate) and history:
        # final full ranking suite for the implicit models (per-epoch
        # records carry only the cheap hit-rate)
        metrics.log(event="ranking", **ranking_metrics_at_n(
            state, ds.train_u, ds.train_i, ds.test_u, ds.test_i,
            n=cfg.topn, max_users=2048))
    if cfg.measure_serving:
        _log_serving_metric(cfg, ds, state, metrics)
    return TrainResult(state=state, dataset=ds, rmse_history=history,
                       out_dir=out)


def _fused_epoch_blocks(cfg, ds, params, state, start_epoch, history,
                        dtype, device, test_coo, train_coo, metrics, out,
                        shm_writer):
    """ALS/iALS epochs in blocks of ``cfg.fused_epochs``, with the JAX
    package's block boundaries (``ycnr_tpu/train/loop._fused_epoch_blocks``).

    There a block is one device program; here it is
    ``als_epochs_bucketed`` / ``ials_epochs_bucketed``, which run eagerly,
    so nothing is fused, but what the reference does at a block's end is
    behaviour and is kept: one record per epoch with ``epoch_s`` = block
    wall / k and ``fused=k``, the iALS hit rate on a block's last epoch
    only, early stopping, checkpoints and shm publishes at block ends.
    Appends to ``history`` in place and returns the final state."""
    dul, dil = _bucketed_layouts(cfg, ds, params, dtype, device)
    bf16 = params.gather_dtype == "bfloat16"
    epoch = start_epoch
    while epoch < params.epochs:
        k = min(cfg.fused_epochs, params.epochs - epoch)
        t0 = time.time()
        if cfg.algorithm == "als":
            state, (rt, rq) = als_epochs_bucketed(
                state, dul, dil, cfg.als.lam, k, test_coo, train_coo,
                gather_bf16=bf16)
        else:
            state, (rt, rq) = ials_epochs_bucketed(
                state, dul, dil, cfg.ials.lam, cfg.ials.alpha, k, test_coo,
                train_coo, gather_bf16=bf16)
        rt = rt.tolist()  # waits for the block
        per_epoch_s = (time.time() - t0) / k
        rq = rq.tolist() if train_coo is not None else None
        for j in range(k):
            history.append(float(rt[j]))
            record = dict(epoch=epoch + j + 1,
                          rmse_test=round(float(rt[j]), 6),
                          epoch_s=round(per_epoch_s, 4), algo=cfg.algorithm,
                          fused=k)
            if rq is not None:
                record["rmse_train"] = round(float(rq[j]), 6)
            if cfg.algorithm == "ials" and j == k - 1:
                # only the block's final state exists, as in the reference
                record["hit_rate"] = round(hit_rate_at_n(
                    state, ds.train_u, ds.train_i, ds.test_u, ds.test_i,
                    n=cfg.topn, max_users=512), 4)
            metrics.log(**record)
        epoch += k
        stop = _early_stop(cfg, history, metrics, epoch)
        if out and cfg.checkpoint_every and (
                epoch % cfg.checkpoint_every == 0
                or epoch == params.epochs or stop):
            save_checkpoint(os.path.join(out, "ckpt"), state, epoch,
                            config=config_dict(cfg),
                            extra=_ckpt_extra(history))
        if shm_writer is not None:
            shm_writer.publish(state, epoch)
        if stop:
            break
    return state


def _time_serving(call, device):
    """One call to warm, sync, then time a second call with a device sync.
    Inputs must already live on the device."""
    def sync():
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize(device)

    call()
    sync()
    t0 = time.time()
    call()
    sync()
    return max(time.time() - t0, 1e-9)


def _log_serving_metric(cfg, ds, state, metrics, **extra):
    """Time top-N for all rated users on the device (BASELINE.json:2's
    'top-10 recs/sec' metric), logged as the run's final record."""
    from ycnr_tpu_torch.eval.recommend import (_topn_blocks, bits_tensor,
                                               build_rated_bits, use_fused)
    from ycnr_tpu_torch.models.base import device_layout
    from ycnr_tpu_torch.ops.fused_topn import fused_topn_blocks

    dev = state.U.device
    dlay = device_layout(ds.user_layout, state.U.dtype, dev)
    bits = bits_tensor(build_rated_bits(ds.user_layout, ds.n_items), dev)
    n_served = int((np.asarray(ds.user_layout.entity_ids)
                    < ds.n_users).sum())
    # too small a catalog for K2: exact on the CPU, an error on the card
    scorer = (cfg.scorer if use_fused(cfg.scorer, ds.n_items, cfg.topn, dev)
              else "exact")
    if scorer != "exact":
        dt = _time_serving(lambda: fused_topn_blocks(
            state, dlay.entity_ids, bits, cfg.topn,
            score_bf16=(scorer != "fused32")), dev)
    else:
        dt = _time_serving(
            lambda: _topn_blocks(state, dlay, cfg.topn, bits), dev)
    metrics.log(event="serving", users=n_served, topn=cfg.topn,
                scorer=scorer, serve_s=round(dt, 4),
                recs_per_s=round(n_served / dt, 1), **extra)
