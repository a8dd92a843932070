"""Sharded training through ``train()`` (counterpart of
``_train_sharded``, ``_train_sharded_ooc``, ``_train_dual`` and
``_log_serving_metric_sharded`` of ``ycnr_tpu/train/loop.py``).

``train(cfg)`` with ``cfg.mesh.n_shards = D > 1`` comes here and runs in
one of three ways:

* with ``mesh=`` given (a ``parallel.mesh.Mesh``, e.g. a thread rank of
  ``run_ranks``): as that rank;
* inside a process group the caller joined (``init_distributed``, the
  CLI's ``--distributed``, torchrun): as this process's rank;
* outside any process group: it starts D rank processes itself
  (``parallel.mesh.spawn_ranks``; the dataset's arrays written once to a
  temporary ``.npy`` set, with ``cfg.ooc`` the sharded wire built here
  once) and returns rank 0's gathered ``TrainResult``, as the JAX
  package's one call does on one host.

In each, rank 0 alone writes the metrics, the checkpoints and the shm
segment. The JAX package's multi-process job writes from every process
(``tests/test_dcn_2proc.py`` gives each its own out dir); here the ranks
of one host share one ``--out`` and one segment name (``torchrun
--nproc-per-node``), and every rank holds the same gathered state.

Every rank runs every collective in the same order: the gathers of the
checkpoint, the shm publish and the BPR hit rate happen on every rank
whether or not it writes, and early stopping decides on the all-reduced
RMSE, which every rank holds.
"""

from __future__ import annotations

import os
import time
from typing import Optional

import numpy as np
import torch

from ycnr_tpu_torch.config import RunConfig
from ycnr_tpu_torch.data.dataset import Dataset, load_dataset
from ycnr_tpu_torch.eval.ranking import hit_rate_at_n
from ycnr_tpu_torch.models.base import (state_from_numpy, to_numpy,
                                        zero_cold_entities)
from ycnr_tpu_torch.train.checkpoint import config_dict, save_checkpoint
from ycnr_tpu_torch.train.metrics import MetricsLogger

_DS_ARRAYS = ("train_u", "train_i", "train_r", "test_u", "test_i", "test_r")


def train_sharded(cfg: RunConfig, dataset: Optional[Dataset], resume,
                  warm_start, out_dir, device, mesh, backend):
    """``train()`` for ``cfg.mesh.n_shards > 1`` (module docstring)."""
    import torch.distributed as dist

    from ycnr_tpu_torch import resolve_device
    from ycnr_tpu_torch.parallel.mesh import make_mesh, spawn_ranks
    from ycnr_tpu_torch.train.loop import TrainResult, _algo_params

    D = cfg.mesh.n_shards
    params = _algo_params(cfg)
    out = out_dir if out_dir is not None else (
        os.path.join(cfg.out_dir, cfg.name) if cfg.out_dir else None)
    if mesh is not None or dist.is_initialized():
        if mesh is None:
            mesh = make_mesh(D, device=device)
        elif mesh.world != D:
            raise ValueError(f"cfg.mesh.n_shards = {D}, the mesh has "
                             f"{mesh.world} ranks")
        ds = dataset or load_dataset(cfg.data, rank_hint=params.rank)
        return _train_sharded(cfg, ds, out, resume, warm_start, mesh)
    dev = resolve_device(device, "train()")  # no card: say so first
    ds = dataset or load_dataset(cfg.data, rank_hint=params.rank)
    arrays = {k: getattr(ds, k) for k in _DS_ARRAYS}
    wire = None
    if cfg.ooc:
        # the wire is built once, here, and each rank memory-maps its
        # slice of the .npy set
        from ycnr_tpu_torch.parallel.ooc_mesh import split_wire

        sw, meta = _build_wire(cfg, ds, params)
        skel, leaves = split_wire(sw)
        arrays.update(leaves)
        wire = (skel, meta)
    res = spawn_ranks(
        "ycnr_tpu_torch.train.sharded:rank_train", D, backend=backend,
        device=device, arrays=arrays,
        kwargs=dict(cfg=cfg, ds_meta=_ds_meta(ds), out=out, resume=resume,
                    warm_start=warm_start, wire=wire))
    dtype = getattr(torch, params.dtype)
    state = state_from_numpy(*res["state"], device=dev, dtype=dtype)
    return TrainResult(state=state, dataset=ds, rmse_history=res["history"],
                       out_dir=out)


def _ds_meta(ds: Dataset) -> dict:
    return dict(n_users=ds.n_users, n_items=ds.n_items, mu=ds.mu,
                chunk_len=ds.chunk_len, block_chunks=ds.block_chunks,
                rank_hint=ds.rank_hint)


def rank_train(mesh, cfg, ds_meta, out, resume, warm_start, wire=None,
               **arrays):
    """One rank process of ``train()``'s own launch; rank 0 returns the
    gathered state as NumPy and the history. ``wire``: the launcher's
    sharded wire (``split_wire``'s skeleton, its ``ShardedMeta``), whose
    arrays come with the dataset's."""
    ds = Dataset(**ds_meta, **{k: arrays[k] for k in _DS_ARRAYS})
    if wire is not None:
        from ycnr_tpu_torch.parallel.ooc_mesh import join_wire

        wire = (join_wire(wire[0], arrays), wire[1])
    res = _train_sharded(cfg, ds, out, resume, warm_start, mesh, wire)
    return {"state": to_numpy(res.state), "history": res.rmse_history}


def _sync(dev):
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize(dev)


def _epoch_loop(cfg: RunConfig, params, mesh, metrics, out, write: bool,
                start_epoch: int, history: list, shm_writer, run_epoch,
                evaluate, gather, **extra):
    """The epochs of a sharded run, shared by both V-step modes.

    ``run_epoch(epoch)`` trains one epoch; ``evaluate()`` returns the
    epoch's metric (held-out RMSE, or hit rate for BPR, whose history
    tracks 1 - hit rate) and the gathered state if it gathered one;
    ``gather()`` is the collective that gathers the state. At most one
    gather an epoch, reused by the checkpoint and the shm publish; every
    rank runs it, rank 0 (``write``) alone writes. ``extra`` goes on every
    metrics line. Returns the last epoch's gathered state, or None."""
    from ycnr_tpu_torch.train.loop import _ckpt_extra, _early_stop

    D = cfg.mesh.n_shards
    gstate = None
    for epoch in range(start_epoch, params.epochs):
        t0 = time.time()
        run_epoch(epoch)
        _sync(mesh.device)
        epoch_s = time.time() - t0
        value, gstate = evaluate()
        if cfg.algorithm == "bpr":
            history.append(1.0 - value)
            metrics.log(epoch=epoch + 1, hit_rate=round(value, 4),
                        epoch_s=round(epoch_s, 4), algo="bpr", shards=D,
                        **extra)
        else:
            history.append(value)
            metrics.log(epoch=epoch + 1, rmse_test=round(value, 6),
                        epoch_s=round(epoch_s, 4), algo=cfg.algorithm,
                        shards=D, **extra)
        stop = _early_stop(cfg, history, metrics, epoch + 1)
        ckpt = bool(out and cfg.checkpoint_every and (
            (epoch + 1) % cfg.checkpoint_every == 0
            or epoch + 1 == params.epochs or stop))
        if (ckpt or cfg.publish_shm) and gstate is None:
            gstate = gather()
        if ckpt and write:
            save_checkpoint(os.path.join(out, "ckpt"), gstate, epoch + 1,
                            config=config_dict(cfg),
                            extra=_ckpt_extra(history))
        if shm_writer is not None:
            shm_writer.publish(gstate, epoch + 1)
        if stop:
            break
    if shm_writer is not None:
        shm_writer.close()
    return gstate


def _train_sharded(cfg: RunConfig, ds: Dataset, out, resume, warm_start,
                   mesh, wire=None):
    from ycnr_tpu_torch.parallel.shard import (
        build_bpr_bits,
        build_sharded_data,
        gather_state,
        put_shard,
        scatter_state,
        sharded_als_epoch,
        sharded_bpr_epoch,
        sharded_ials_epoch,
        sharded_rmse,
        sharded_sgd_epoch,
    )
    from ycnr_tpu_torch.train.loop import (TrainResult, _algo_params,
                                           _shm_writer, _start_state)

    params = _algo_params(cfg)
    dtype = getattr(torch, params.dtype)
    D = cfg.mesh.n_shards
    dev = mesh.device
    write = mesh.rank == 0
    metrics = MetricsLogger(
        os.path.join(out, "metrics.jsonl") if out and write else None,
        echo=write, append=bool(resume))
    mu = ds.mu if cfg.algorithm == "sgd" else 0.0

    # item_sharded: both factor axes sharded, the other side all-gathered
    # (ALS/iALS only; SGD needs a replicated V)
    if (cfg.mesh.vstep_mode == "item_sharded"
            and cfg.algorithm in ("als", "ials")):
        return _train_dual(cfg, ds, out, resume, warm_start, mesh, write,
                           metrics, params, dtype)
    if cfg.ooc:
        return _train_sharded_ooc(cfg, ds, out, resume, warm_start, mesh,
                                  write, metrics, params, dtype, wire)
    sgd_stream = cfg.algorithm == "sgd" and cfg.sgd.method == "stream"
    host, meta = build_sharded_data(
        ds.train_u, ds.train_i, ds.train_r, ds.n_users, ds.n_items, D,
        chunk_len=cfg.data.chunk_len, block_chunks=cfg.data.block_chunks,
        rank_hint=params.rank, test_u=ds.test_u, test_i=ds.test_i,
        test_r=ds.test_r,
        sgd_batch=(cfg.bpr.batch_size if cfg.algorithm == "bpr"
                   else cfg.sgd.batch_size),
        dtype=dtype, host_user_layout=cfg.measure_serving,
        # the stream path builds its own rating arrays below
        algo="stream-sgd" if sgd_stream else cfg.algorithm)
    data = put_shard(host, mesh)
    del host
    aux = stream = None
    if cfg.algorithm == "bpr":
        aux = put_shard(build_bpr_bits(ds.train_u, ds.train_i, meta,
                                       batch_size=cfg.bpr.batch_size), mesh)
    if sgd_stream:
        from ycnr_tpu_torch.parallel.sgd_stream import (
            build_sharded_stream_sgd, put_stream, sharded_sgd_stream_epoch)

        gm = "capped" if cfg.sgd.grad_mode == "sum" else cfg.sgd.grad_mode
        stream = put_stream(build_sharded_stream_sgd(
            ds.train_u, ds.train_i, ds.train_r, meta, cfg.sgd.batch_size,
            seed=cfg.seed, dtype=dtype, grad_mode=gm)[0], mesh)

    gstate, start_epoch, history = _start_state(
        cfg, ds, params, resume, warm_start, metrics, mu, dtype, dev)
    gstate = zero_cold_entities(gstate, ds.train_u, ds.train_i)
    shm_writer = _shm_writer(cfg, gstate) if write else None
    st = scatter_state(gstate, meta, mesh)

    def run_epoch(epoch):
        nonlocal st
        if cfg.algorithm == "als":
            st = sharded_als_epoch(
                mesh, st, data, cfg.als.lam,
                gather_bf16=cfg.als.gather_dtype == "bfloat16")
        elif cfg.algorithm == "ials":
            st = sharded_ials_epoch(
                mesh, st, data, cfg.ials.lam, cfg.ials.alpha,
                gather_bf16=cfg.ials.gather_dtype == "bfloat16")
        elif cfg.algorithm == "bpr":
            st = sharded_bpr_epoch(
                mesh, st, data, aux, cfg.bpr.lam,
                cfg.bpr.lr * cfg.bpr.lr_decay**epoch, cfg.bpr.batch_size,
                grad_mode=cfg.bpr.grad_mode, shuffle=cfg.bpr.shuffle,
                seed=cfg.seed, epoch=epoch)
        elif stream is not None:
            st = sharded_sgd_stream_epoch(
                mesh, st, stream, cfg.sgd.lam,
                cfg.sgd.lr * cfg.sgd.lr_decay**epoch, seed=cfg.seed,
                epoch=epoch)
        else:
            st = sharded_sgd_epoch(
                mesh, st, data, cfg.sgd.lam,
                cfg.sgd.lr * cfg.sgd.lr_decay**epoch, cfg.sgd.batch_size,
                seed=cfg.seed, epoch=epoch)

    def evaluate():
        if cfg.algorithm == "bpr":
            # ranking logits have no RMSE: hit-rate@N on the gathered
            # factors (every rank gathers and computes it)
            g = gather_state(st, meta, mesh)
            return hit_rate_at_n(g, ds.train_u, ds.train_i, ds.test_u,
                                 ds.test_i, n=cfg.topn, max_users=512), g
        return sharded_rmse(mesh, st, data, meta.test_n), None

    gstate = _epoch_loop(cfg, params, mesh, metrics, out, write, start_epoch,
                         history, shm_writer, run_epoch, evaluate,
                         lambda: gather_state(st, meta, mesh))
    if cfg.measure_serving:
        _log_serving_metric_sharded(cfg, ds, st, data, meta, mesh, metrics)
    if gstate is None:
        gstate = gather_state(st, meta, mesh)
    return TrainResult(state=gstate, dataset=ds, rmse_history=history,
                       out_dir=out)


def _build_wire(cfg: RunConfig, ds: Dataset, params):
    """The stacked host wire of a sharded out-of-core run and its meta."""
    from ycnr_tpu_torch.parallel.ooc_mesh import build_sharded_wire

    return build_sharded_wire(ds.train_u, ds.train_i, ds.train_r,
                              ds.n_users, ds.n_items, cfg.mesh.n_shards,
                              rank_hint=params.rank,
                              max_groups=cfg.data.max_groups)


def _train_sharded_ooc(cfg: RunConfig, ds: Dataset, out, resume, warm_start,
                       mesh, write, metrics, params, dtype, wire):
    """Out of core on the mesh (``parallel/ooc_mesh.py``, ALS-WR / iALS):
    the user-view wire sliced across the ranks, per-rank item-view wires,
    the item-Gram all-reduce. Each rank pins its slice of the wire on its
    device, whatever ``ooc_residency`` says, as the JAX package does (the
    streamed tier is ``feed_sharded_wire`` with ``make_sharded_ooc_epoch(
    ..., wire_as_args=True)``). ``wire``: the launcher's (stacked host
    wire, meta), else built here."""
    from ycnr_tpu_torch.models.ooc import wire_nbytes
    from ycnr_tpu_torch.parallel.ooc_mesh import (make_sharded_ooc_epoch,
                                                  put_sharded_wire,
                                                  put_test_rows)
    from ycnr_tpu_torch.parallel.shard import (gather_state, scatter_state,
                                               sharded_rmse)
    from ycnr_tpu_torch.train.loop import (TrainResult, _shm_writer,
                                           _start_state)

    D = cfg.mesh.n_shards
    sw, meta = wire if wire is not None else _build_wire(cfg, ds, params)
    sw = put_sharded_wire(sw, mesh)
    metrics.log(event="ooc_residency", mesh_shards=D,
                hbm_pinned_bytes=wire_nbytes(sw.ugroups, sw.igroups),
                streamed_bytes=0)

    data = put_test_rows(meta, ds.test_u, ds.test_i, ds.test_r, mesh,
                         dtype)
    gstate, start_epoch, history = _start_state(
        cfg, ds, params, resume, warm_start, metrics, 0.0, dtype,
        mesh.device)
    gstate = zero_cold_entities(gstate, ds.train_u, ds.train_i)
    shm_writer = _shm_writer(cfg, gstate) if write else None
    st = scatter_state(gstate, meta, mesh)

    epoch_fn = make_sharded_ooc_epoch(
        mesh, sw, params.lam,
        alpha=cfg.ials.alpha if cfg.algorithm == "ials" else None,
        gather_bf16=params.gather_dtype == "bfloat16")

    def run_epoch(epoch):
        nonlocal st
        st = epoch_fn(st)

    gstate = _epoch_loop(
        cfg, params, mesh, metrics, out, write, start_epoch, history,
        shm_writer, run_epoch,
        lambda: (sharded_rmse(mesh, st, data, meta.test_n), None),
        lambda: gather_state(st, meta, mesh), ooc=True)
    if cfg.measure_serving:
        metrics.log(event="serving_metric_skipped",
                    note="measure_serving needs the resident sharded "
                         "layout; serve from the checkpoint instead")
    if gstate is None:
        gstate = gather_state(st, meta, mesh)
    return TrainResult(state=gstate, dataset=ds, rmse_history=history,
                       out_dir=out)


def _serving_scorer(cfg, n_items: int, dev) -> str:
    from ycnr_tpu_torch.eval.recommend import use_fused

    # too small a catalog for K2: exact on the CPU, an error on the card
    return (cfg.scorer if use_fused(cfg.scorer, n_items, cfg.topn, dev)
            else "exact")


def _log_serving_metric_sharded(cfg, ds, st, data, meta, mesh, metrics):
    """Top-N for every rated user on the mesh (BASELINE config 5: "full
    top-N serving over 8-chip mesh"), each rank scoring its own users
    through the rated-bits path; rank 0's time is logged."""
    from ycnr_tpu_torch.eval.recommend import bits_tensor, build_rated_bits
    from ycnr_tpu_torch.parallel.shard import topn_local
    from ycnr_tpu_torch.train.loop import _time_serving

    dev = mesh.device
    # the bits go to the device BEFORE timing
    bits = bits_tensor(build_rated_bits(meta.user_layout_host,
                                        ds.n_items)[mesh.rank], dev)
    n_served = int((np.asarray(meta.user_layout_host.entity_ids)
                    < meta.upd).sum())
    scorer = _serving_scorer(cfg, ds.n_items, dev)
    mesh.barrier()
    dt = _time_serving(lambda: topn_local(
        st, data.user_layout.entity_ids, cfg.topn, bits, scorer), dev)
    metrics.log(event="serving", users=n_served, topn=cfg.topn,
                shards=meta.n_shards, mode="mesh", scorer=scorer,
                serve_s=round(dt, 4), recs_per_s=round(n_served / dt, 1))


def _train_dual(cfg: RunConfig, ds: Dataset, out, resume, warm_start, mesh,
                write, metrics, params, dtype):
    from ycnr_tpu_torch.parallel.dual import (
        build_dual_sharded_data,
        dual_als_epoch,
        dual_gather_state,
        dual_ials_epoch,
        dual_rated_bits,
        dual_rmse,
        dual_scatter_state,
        dual_topn_local,
    )
    from ycnr_tpu_torch.parallel.shard import put_shard
    from ycnr_tpu_torch.train.loop import (TrainResult, _shm_writer,
                                           _start_state, _time_serving)

    D = cfg.mesh.n_shards
    dev = mesh.device
    host, meta = build_dual_sharded_data(
        ds.train_u, ds.train_i, ds.train_r, ds.n_users, ds.n_items, D,
        chunk_len=cfg.data.chunk_len, block_chunks=cfg.data.block_chunks,
        rank_hint=params.rank, test_u=ds.test_u, test_i=ds.test_i,
        test_r=ds.test_r, dtype=dtype,
        host_user_layout=cfg.measure_serving)
    data = put_shard(host, mesh)
    del host
    gstate, start_epoch, history = _start_state(
        cfg, ds, params, resume, warm_start, metrics, 0.0, dtype, dev)
    gstate = zero_cold_entities(gstate, ds.train_u, ds.train_i)
    shm_writer = _shm_writer(cfg, gstate) if write else None
    st = dual_scatter_state(gstate, meta, mesh)

    def run_epoch(epoch):
        nonlocal st
        if cfg.algorithm == "als":
            st = dual_als_epoch(
                mesh, st, data, cfg.als.lam,
                gather_bf16=cfg.als.gather_dtype == "bfloat16")
        else:
            st = dual_ials_epoch(
                mesh, st, data, cfg.ials.lam, cfg.ials.alpha,
                gather_bf16=cfg.ials.gather_dtype == "bfloat16")

    gstate = _epoch_loop(
        cfg, params, mesh, metrics, out, write, start_epoch, history,
        shm_writer, run_epoch,
        lambda: (dual_rmse(mesh, st, data, meta.test_n), None),
        lambda: dual_gather_state(st, meta, mesh), mode="item_sharded")
    if gstate is None:
        gstate = dual_gather_state(st, meta, mesh)
    if cfg.measure_serving:
        # V stays sharded: one V all-gather per pass, users scored in
        # item-cat space
        from ycnr_tpu_torch.eval.recommend import bits_tensor

        rated = dual_rated_bits(meta)
        bits = bits_tensor(rated[mesh.rank], dev)
        n_cat = rated.shape[-1] * 32 - 1
        n_served = int((np.asarray(meta.user_layout_host.entity_ids)
                        < meta.upd).sum())
        scorer = _serving_scorer(cfg, n_cat, dev)
        mesh.barrier()
        dt = _time_serving(lambda: dual_topn_local(
            mesh, st, data, cfg.topn, bits, scorer, n_cat), dev)
        metrics.log(event="serving", users=n_served, topn=cfg.topn,
                    shards=meta.n_shards, mode="mesh_item_sharded",
                    scorer=scorer, serve_s=round(dt, 4),
                    recs_per_s=round(n_served / dt, 1))
    return TrainResult(state=gstate, dataset=ds, rmse_history=history,
                       out_dir=out)
