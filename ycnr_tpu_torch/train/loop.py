"""Single-GPU training loop for ALS-WR and iALS on the bucketed layout
(counterpart of the single-chip path of ``ycnr_tpu/train/loop.py``).

Flow, as in the reference: preset -> dataset -> bucketed layouts ->
``init_state`` + ``zero_cold_entities`` -> epochs with held-out RMSE ->
checkpoints. Sharded, out-of-core, SGD/BPR, resume/warm-start, early
stopping, hit-rate metrics and shm publishing are not ported yet and are
refused.
"""

from __future__ import annotations

import json
import os
import sys
import time
from dataclasses import dataclass, asdict
from typing import Optional

import torch

from ycnr_tpu_torch import full_precision_matmul, resolve_device
from ycnr_tpu_torch.config import RunConfig
from ycnr_tpu_torch.data.dataset import Dataset, load_dataset
from ycnr_tpu_torch.models.base import (
    MFState,
    init_state,
    rmse_padded,
    zero_cold_entities,
)
from ycnr_tpu_torch.models.bucketed_phase import (
    als_epoch_fn,
    device_bucketed,
    ials_epoch_fn,
    uses_fused,
)
from ycnr_tpu_torch.ops.bucketed import build_bucketed
from ycnr_tpu_torch.ops.layout import pad_coo
from ycnr_tpu_torch.train.checkpoint import save_checkpoint


@dataclass
class TrainResult:
    state: MFState
    dataset: Dataset
    rmse_history: list
    out_dir: Optional[str]


def _check_supported(cfg: RunConfig):
    if cfg.algorithm not in ("als", "ials"):
        raise NotImplementedError(
            f"the port trains als/ials only, not {cfg.algorithm!r}")
    if cfg.mesh.n_shards > 1 or cfg.ooc:
        raise NotImplementedError("the port trains on one GPU, resident")
    if (cfg.early_stop_patience > 0 or cfg.publish_shm
            or cfg.checkpoint_backend != "npz"):
        raise NotImplementedError("early stopping, shm publishing and "
                                  "orbax checkpoints are not ported")


def _log(record: dict):
    print(json.dumps(record), file=sys.stderr, flush=True)


def train(cfg: RunConfig, dataset: Optional[Dataset] = None,
          out_dir: Optional[str] = None, device=None) -> TrainResult:
    """Train per config on ``device`` (default ``"cuda"``). Without a CUDA
    device the default raises; a CPU run passes ``device="cpu"``."""
    _check_supported(cfg)
    full_precision_matmul()
    device = resolve_device(device, "train()")
    params = cfg.als if cfg.algorithm == "als" else cfg.ials
    ds = dataset or load_dataset(cfg.data, rank_hint=params.rank)
    out = out_dir if out_dir is not None else (
        os.path.join(cfg.out_dir, cfg.name) if cfg.out_dir else None)
    dtype = getattr(torch, params.dtype)
    bf16 = params.gather_dtype == "bfloat16"

    state = init_state(ds.n_users, ds.n_items, params.rank, seed=cfg.seed,
                       dtype=dtype, device=device)
    state = zero_cold_entities(state, ds.train_u, ds.train_i)
    pu, pi, pr, n_test = ds.padded_test()
    test_coo = (pu, pi, pr, n_test)
    train_coo = (pad_coo(ds.train_u, ds.train_i, ds.train_r, ds.n_users,
                         ds.n_items) if cfg.log_train_rmse else None)
    alpha = None if cfg.algorithm == "als" else cfg.ials.alpha
    rating_dtype = (torch.bfloat16 if uses_fused(device, dtype, alpha, bf16)
                    else dtype)
    dul = device_bucketed(build_bucketed(
        ds.train_u, ds.train_i, ds.train_r, ds.n_users, ds.n_items,
        cfg.data.chunk_len, params.rank, max_groups=cfg.data.max_groups),
        dtype, device, rating_dtype)
    dil = device_bucketed(build_bucketed(
        ds.train_i, ds.train_u, ds.train_r, ds.n_items, ds.n_users,
        cfg.data.chunk_len, params.rank, max_groups=cfg.data.max_groups),
        dtype, device, rating_dtype)
    if cfg.algorithm == "als":
        epoch_fn = als_epoch_fn(dul, dil, cfg.als.lam, bf16)
    else:
        epoch_fn = ials_epoch_fn(dul, dil, cfg.ials.lam, alpha, bf16)

    history = []
    for epoch in range(params.epochs):
        t0 = time.time()
        state = epoch_fn(state)
        if state.U.is_cuda:
            torch.cuda.synchronize(state.U.device)
        epoch_s = time.time() - t0
        rmse = float(rmse_padded(state, *test_coo))
        history.append(rmse)
        record = dict(epoch=epoch + 1, rmse_test=round(rmse, 6),
                      epoch_s=round(epoch_s, 4), algo=cfg.algorithm)
        if train_coo is not None:
            record["rmse_train"] = round(
                float(rmse_padded(state, *train_coo)), 6)
        _log(record)
        if out and cfg.checkpoint_every and (
                (epoch + 1) % cfg.checkpoint_every == 0
                or epoch + 1 == params.epochs):
            save_checkpoint(os.path.join(out, "ckpt"), state, epoch + 1,
                            config=asdict(cfg),
                            extra={"rmse_history": [round(x, 6)
                                                    for x in history]})
    return TrainResult(state=state, dataset=ds, rmse_history=history,
                       out_dir=out)
