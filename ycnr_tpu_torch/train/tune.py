"""Hyperparameter sweep for ALS-WR, iALS, stream SGD and BPR (counterpart
of ``ycnr_tpu/train/tune.py``).

The JAX package stacks the grid's models on a leading axis and runs them
under one ``lax.map`` inside one compiled program, so that no grid entry
pays a TPU compile. The port runs eagerly and has nothing to compile: it
loops over the grid entries. What is shared is built once per call, as
there: the device layouts (bucketed for ALS/iALS, the resident stream for
SGD, the padded BPR rows and rated bits), the held-out COO and BPR's AUC
triples. Every entry starts from ``init_state`` at its seed (with the cold
rows zeroed) and runs the same epoch code as ``train()``, so each entry
equals a standalone ``train()`` at the same seed and hyperparameters.

SGD sweeps run the stream trainer, as the reference's do (its epoch core
takes lam and lr as plain inputs; the batched trainer is not swept), with
the stream order pinned to ``cfg.seed``. BPR sweeps score each epoch by the
held-out pairwise AUC over fixed triples and rank by the final hit rate.
The leaderboard's keys, order and best pick are the reference's.

The sharded sweep (``cfg.mesh.n_shards = D > 1``, the reference's
``_sweep_sharded``) deals the grid entries to the ranks: the grid is padded
to a multiple of D with copies of its last entry, rank r trains the r-th
contiguous slice with the same single-GPU code, and the final states and
trajectories are all-gathered (no other collective), so every rank ends
with the single-process sweep's ``TuneResult``. It runs as the rank of
``mesh`` when given, as this process's rank inside a process group, else
over D rank processes started here (``parallel.mesh.spawn_ranks``).
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch

from ycnr_tpu_torch import full_precision_matmul, resolve_device
from ycnr_tpu_torch.config import RunConfig
from ycnr_tpu_torch.data.dataset import Dataset, load_dataset
from ycnr_tpu_torch.eval.ranking import hit_rate_at_n
from ycnr_tpu_torch.models.base import (
    MFState,
    init_state,
    rmse_padded,
    to_numpy,
    zero_cold_entities,
)
from ycnr_tpu_torch.models.bucketed_phase import (
    als_epochs_bucketed,
    ials_epochs_bucketed,
)
from ycnr_tpu_torch.train.loop import _algo_params, _bucketed_layouts


@dataclass
class TuneResult:
    leaderboard: list  # dicts sorted best-first (see tune() for keys)
    best: dict
    best_state: MFState
    dataset: Dataset


def _bpr_eval_triples(ds: Dataset, seed: int):
    """Fixed held-out AUC triples: every test positive paired with one
    uniformly drawn item unrated by that user (train OR test). Drawn once
    per sweep so each epoch's AUC is comparable; the rare user who rated
    the whole catalog is dropped. NumPy arrays, the reference's draws."""
    from ycnr_tpu_torch.models.bpr import pack_rated_bits

    bits = pack_rated_bits(
        np.concatenate([ds.train_u, ds.test_u]),
        np.concatenate([ds.train_i, ds.test_i]),
        ds.n_users, ds.n_items)
    rng = np.random.default_rng(seed)
    eu = np.asarray(ds.test_u, np.int32)
    ei = np.asarray(ds.test_i, np.int32)
    ej = rng.integers(0, ds.n_items, len(eu)).astype(np.int32)

    def _coll(j):
        return ((bits[eu, j // 32] >> (j % 32).astype(np.uint32)) & 1) == 1

    if len(eu) == 0:
        raise ValueError(
            "BPR sweep has no held-out positives to score AUC on — the "
            "split produced an empty test set (test_fraction=0, or a "
            "last-out split where every user has <= k ratings). Use a "
            "split that leaves test ratings, or sweep by RMSE instead.")
    for _ in range(64):  # vectorized rejection; a few rounds suffice
        bad = _coll(ej)
        if not bad.any():
            break
        ej[bad] = rng.integers(0, ds.n_items, int(bad.sum()))
    keep = ~_coll(ej)
    if not keep.any():
        raise ValueError(
            "BPR sweep AUC triples are empty after dropping users who "
            "rated the whole catalog — every epoch's AUC would be NaN. "
            "The catalog is too small relative to the rating density for "
            "a meaningful AUC; use an RMSE-based sweep.")
    return eu[keep], ei[keep], ej[keep]


def _auc(state: MFState, eu, ei, ej) -> float:
    """Held-out pairwise AUC: the share of triples whose test positive
    outscores the sampled unrated item."""
    Ue = state.U[eu]
    xi = (Ue * state.V[ei]).sum(1) + state.bi[ei]
    xj = (Ue * state.V[ej]).sum(1) + state.bi[ej]
    return float((xi > xj).to(state.U.dtype).mean())


def _gather_entries(mesh, finals, trajs, n_grid: int):
    """Every rank's final states and trajectories, in grid order, on
    every rank (all-gathers of equal shapes), pad entries dropped."""
    traj = torch.as_tensor(np.stack(trajs), device=mesh.device)
    trajs = torch.cat(mesh.all_gather(traj)).cpu().numpy()[:n_grid]
    fields = [torch.cat(mesh.all_gather(torch.stack(list(xs))))
              for xs in zip(*finals)]
    states = [MFState(*(f[s] for f in fields)) for s in range(n_grid)]
    return states, list(trajs)


def _spawn_tune(cfg, lams, alphas, lrs, seeds, n_epochs, dataset, device,
                backend, params):
    """The sharded sweep over ``cfg.mesh.n_shards`` rank processes;
    rank 0's result, its best state on ``device``."""
    from ycnr_tpu_torch.models.base import state_from_numpy
    from ycnr_tpu_torch.parallel.mesh import spawn_ranks
    from ycnr_tpu_torch.train.sharded import _DS_ARRAYS, _ds_meta

    dev = resolve_device(device, "tune()")  # no card: say so first
    ds = dataset or load_dataset(cfg.data, rank_hint=params.rank)
    res = spawn_ranks(
        "ycnr_tpu_torch.train.tune:rank_tune", cfg.mesh.n_shards,
        backend=backend, device=device,
        arrays={k: getattr(ds, k) for k in _DS_ARRAYS},
        kwargs=dict(cfg=cfg, lams=list(lams), alphas=alphas, lrs=lrs,
                    seeds=list(seeds), epochs=n_epochs,
                    ds_meta=_ds_meta(ds)))
    state = state_from_numpy(*res["best_state"], device=dev,
                             dtype=getattr(torch, params.dtype))
    return TuneResult(leaderboard=res["leaderboard"], best=res["best"],
                      best_state=state, dataset=ds)


def rank_tune(mesh, cfg, lams, alphas, lrs, seeds, epochs, ds_meta,
              **arrays):
    """One rank process of the sharded sweep; rank 0 returns the board,
    the best entry and its state as NumPy."""
    res = tune(cfg, lams, alphas=alphas, lrs=lrs, seeds=seeds, epochs=epochs,
               dataset=Dataset(**ds_meta, **arrays), mesh=mesh)
    return {"leaderboard": res.leaderboard, "best": res.best,
            "best_state": to_numpy(res.best_state)}


def _check_grid(cfg: RunConfig, params, lams, alphas, lrs, seeds, epochs):
    """The reference's grid checks, in its order; returns (alphas, lrs,
    n_epochs) with the defaults filled in."""
    implicit = cfg.algorithm == "ials"
    is_sgd = cfg.algorithm == "sgd"
    is_bpr = cfg.algorithm == "bpr"
    if implicit and not alphas:
        alphas = [params.alpha]
    if alphas and not implicit:
        raise ValueError("alphas only applies to algorithm='ials'")
    if (is_sgd or is_bpr) and not lrs:
        lrs = [params.lr]
    if is_sgd and any(int(s) != cfg.seed for s in seeds):
        # train() uses cfg.seed for both the init and the stream order, so
        # a winner at another init seed could not reproduce as a run
        raise ValueError(
            "SGD sweeps do not take a seed axis: stream order is pinned "
            f"to cfg.seed ({cfg.seed}); vary cfg.seed per sweep instead")
    if lrs and not (is_sgd or is_bpr):
        raise ValueError("lrs only applies to algorithm='sgd'/'bpr'")
    if not lams:
        raise ValueError("tune() needs at least one lambda value")
    n_epochs = int(epochs if epochs is not None else params.epochs)
    if n_epochs <= 0:
        raise ValueError(f"epochs must be positive, got {n_epochs}")
    return alphas, lrs, n_epochs


def tune(cfg: RunConfig, lams: Sequence[float],
         alphas: Optional[Sequence[float]] = None,
         lrs: Optional[Sequence[float]] = None,
         seeds: Sequence[int] = (0,), epochs: Optional[int] = None,
         dataset: Optional[Dataset] = None, device=None, mesh=None,
         backend: Optional[str] = None) -> TuneResult:
    """Grid sweep on ``device`` (None: the card). Axes: lambda, x alpha
    (iALS), x lr (SGD, BPR), x init seed. Leaderboard sorted by the
    selection metric:

    * als / sgd: final held-out RMSE, ascending;
    * ials / bpr: hit_rate@cfg.topn (up to 512 sampled test users, the
      metric train() logs), descending.

    Entries: {lam, alpha?, lr?, seed, rmse: [E], rmse_final, best_epoch,
    hit_rate?}; BPR's carry {auc: [E], auc_final} instead of the RMSE. The
    best entry's trained state is returned. All S final states stay on the
    device: S * (n_users + n_items) * rank floats.
    """
    implicit = cfg.algorithm == "ials"
    is_sgd = cfg.algorithm == "sgd"
    is_bpr = cfg.algorithm == "bpr"
    params = _algo_params(cfg)
    alphas, lrs, n_epochs = _check_grid(cfg, params, lams, alphas, lrs,
                                        seeds, epochs)
    D = cfg.mesh.n_shards
    if D > 1 and mesh is None:
        import torch.distributed as dist

        from ycnr_tpu_torch.parallel.mesh import make_mesh

        if not dist.is_initialized():
            return _spawn_tune(cfg, lams, alphas, lrs, seeds, n_epochs,
                               dataset, device, backend, params)
        mesh = make_mesh(D, device=device)
    if mesh is not None and mesh.world != D:
        raise ValueError(f"cfg.mesh.n_shards = {D}, the mesh has "
                         f"{mesh.world} ranks")
    device = mesh.device if mesh is not None else resolve_device(device,
                                                                 "tune()")
    full_precision_matmul()
    ds = dataset or load_dataset(cfg.data, rank_hint=params.rank)
    dtype = getattr(torch, params.dtype)
    pu, pi, pr, n_test = ds.padded_test()
    test_coo = tuple(torch.as_tensor(x, device=device)
                     for x in (pu, pi, pr)) + (n_test,)

    aux = ([float(a) for a in alphas] if implicit
           else [float(x) for x in lrs] if (is_sgd or is_bpr) else [0.0])
    grid = list(itertools.product(
        [float(x) for x in lams], aux, [int(s) for s in seeds]))
    mu = ds.mu if is_sgd else 0.0

    if is_bpr:
        from ycnr_tpu_torch.models.bpr import BPRTrainer, prepare_bpr_data

        data = prepare_bpr_data(
            ds.train_u, ds.train_i, params.batch_size, ds.n_users,
            ds.n_items,
            # train()'s fixed composition seed, so entries reproduce
            shuffle_rows_seed=(0 if params.shuffle == "batches" else None),
            device=device)
        triples = tuple(torch.as_tensor(x, device=device).long()
                        for x in _bpr_eval_triples(ds, cfg.seed))
    elif is_sgd:
        from ycnr_tpu_torch.models.sgd_stream import (StreamSGD,
                                                      prepare_stream_sgd)

        gm = "capped" if params.grad_mode == "sum" else params.grad_mode
        data, _ = prepare_stream_sgd(
            ds.train_u, ds.train_i, ds.train_r, params.batch_size,
            ds.n_users, ds.n_items, seed=cfg.seed, dtype=dtype,
            grad_mode=gm, device=device)
    else:
        dul, dil = _bucketed_layouts(cfg, ds, params, dtype, device)
        bf16 = params.gather_dtype == "bfloat16"

    # the sharded sweep: pad the grid to a multiple of D (pad entries
    # recompute the last one and are dropped) and take this rank's slice
    grid_run = grid + [grid[-1]] * ((-len(grid)) % D)
    per = len(grid_run) // D
    mine = (grid_run[mesh.rank * per:(mesh.rank + 1) * per]
            if mesh is not None else grid)
    finals, trajs = [], []
    for lam, aux_val, seed in mine:
        state = zero_cold_entities(
            init_state(ds.n_users, ds.n_items, params.rank, seed=seed,
                       mu=mu, dtype=dtype, device=device),
            ds.train_u, ds.train_i)
        if is_bpr or is_sgd:
            trainer = (BPRTrainer(lam, aux_val, params.lr_decay,
                                  params.batch_size, seed=seed,
                                  grad_mode=params.grad_mode,
                                  shuffle=params.shuffle) if is_bpr
                       else StreamSGD(lam, aux_val, params.lr_decay,
                                      seed=cfg.seed, grad_mode=gm))
            traj = []
            for ep in range(n_epochs):
                state = trainer.epoch(state, data, ep)
                traj.append(_auc(state, *triples) if is_bpr
                            else float(rmse_padded(state, *test_coo)))
        elif implicit:
            state, (rt, _) = ials_epochs_bucketed(
                state, dul, dil, lam, aux_val, n_epochs, test_coo,
                gather_bf16=bf16)
            traj = rt.tolist()
        else:
            state, (rt, _) = als_epochs_bucketed(
                state, dul, dil, lam, n_epochs, test_coo, gather_bf16=bf16)
            traj = rt.tolist()
        finals.append(state)
        trajs.append(np.asarray(traj, np.float64))
    if mesh is not None:
        finals, trajs = _gather_entries(mesh, finals, trajs, len(grid))

    board = []
    for s, (lam, aux_val, seed) in enumerate(grid):
        traj = trajs[s]
        if is_bpr:
            # the trajectory is held-out pairwise AUC (higher = better)
            entry = {"lam": lam, "lr": aux_val, "seed": seed,
                     "auc": [round(float(x), 6) for x in traj],
                     "auc_final": round(float(traj[-1]), 6),
                     "best_epoch": int(np.argmax(traj)) + 1}
        else:
            entry = {"lam": lam, "seed": seed,
                     "rmse": [round(float(x), 6) for x in traj],
                     "rmse_final": round(float(traj[-1]), 6),
                     "best_epoch": int(np.argmin(traj)) + 1}
        if is_sgd:
            entry["lr"] = aux_val
        if implicit or is_bpr:
            if implicit:
                entry["alpha"] = aux_val
            entry["hit_rate"] = round(hit_rate_at_n(
                finals[s], ds.train_u, ds.train_i, ds.test_u, ds.test_i,
                n=cfg.topn, max_users=512), 4)
        board.append(entry)
    board.sort(key=(lambda e: -e["hit_rate"]) if (implicit or is_bpr)
               else (lambda e: e["rmse_final"]))
    best = board[0]
    pos = next(s for s, (lam, aux_val, seed) in enumerate(grid)
               if lam == best["lam"] and seed == best["seed"]
               and aux_val == best.get("alpha", best.get("lr", 0.0)))
    return TuneResult(leaderboard=board, best=best, best_state=finals[pos],
                      dataset=ds)
