"""Single-GPU training loop (counterpart of the single-chip path of
``ycnr_tpu/train/loop.py``).

Runs any of the algorithm families from a RunConfig — ALS-WR and iALS on
the bucketed layout, biased SGD (batched and stream) and BPR — with
per-epoch held-out RMSE (``1 - hit_rate`` for BPR), JSONL metrics, early
stopping, checkpoints with resume, and warm start. Sharded and out-of-core
training, shm publishing and orbax checkpoints are not ported yet and are
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
    device_bucketed,
    ials_epoch_fn,
    uses_fused,
)
from ycnr_tpu_torch.models.sgd import BiasedSGD, prepare_sgd_data
from ycnr_tpu_torch.models.sgd_stream import StreamSGD, prepare_stream_sgd
from ycnr_tpu_torch.ops.bucketed import build_bucketed
from ycnr_tpu_torch.ops.layout import pad_coo
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
    if cfg.mesh.n_shards > 1 or cfg.ooc:
        raise NotImplementedError("the port trains on one GPU, resident")
    if cfg.publish_shm or cfg.checkpoint_backend != "npz":
        raise NotImplementedError("shm publishing and orbax checkpoints "
                                  "are not ported")


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


def _epoch_fn(cfg: RunConfig, ds: Dataset, params, dtype, device):
    """``(state, epoch_idx) -> state`` for the configured algorithm, with
    its training data laid out on ``device``."""
    if cfg.algorithm in ("als", "ials"):
        # single-device fast path: bucketed (segsum-free) layout
        bf16 = params.gather_dtype == "bfloat16"
        alpha = None if cfg.algorithm == "als" else cfg.ials.alpha
        rating_dtype = (torch.bfloat16
                        if uses_fused(device, dtype, alpha, bf16) else dtype)
        dul = device_bucketed(build_bucketed(
            ds.train_u, ds.train_i, ds.train_r, ds.n_users, ds.n_items,
            cfg.data.chunk_len, params.rank, max_groups=cfg.data.max_groups),
            dtype, device, rating_dtype)
        dil = device_bucketed(build_bucketed(
            ds.train_i, ds.train_u, ds.train_r, ds.n_items, ds.n_users,
            cfg.data.chunk_len, params.rank, max_groups=cfg.data.max_groups),
            dtype, device, rating_dtype)
        if cfg.algorithm == "als":
            fn = als_epoch_fn(dul, dil, cfg.als.lam, bf16)
        else:
            fn = ials_epoch_fn(dul, dil, cfg.ials.lam, alpha, bf16)
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
        data, _ = prepare_stream_sgd(
            ds.train_u, ds.train_i, ds.train_r, cfg.sgd.batch_size,
            ds.n_users, ds.n_items, seed=cfg.seed, dtype=dtype,
            grad_mode=gm, device=device)
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
          out_dir: Optional[str] = None, device=None) -> TrainResult:
    """Train per config on ``device`` (default ``"cuda"``). Without a CUDA
    device the default raises; a CPU run passes ``device="cpu"``."""
    _check_supported(cfg)
    full_precision_matmul()
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
    epoch_fn = _epoch_fn(cfg, ds, params, dtype, device)

    def hit_rate():
        return hit_rate_at_n(state, ds.train_u, ds.train_i, ds.test_u,
                             ds.test_i, n=cfg.topn, max_users=512)

    for epoch in range(start_epoch, params.epochs):
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
        if stop:
            break
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
