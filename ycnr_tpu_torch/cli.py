"""Command line of the PyTorch/CUDA port (counterpart of ``ycnr_tpu/cli.py``).

    python -m ycnr_tpu_torch prepare   --source ... --store DIR
    python -m ycnr_tpu_torch train     --preset ml100k-als [overrides]
    python -m ycnr_tpu_torch tune      --lams 0.02,0.05 [overrides]
    python -m ycnr_tpu_torch validate  --ckpt DIR --store DIR
    python -m ycnr_tpu_torch recommend --ckpt DIR --store DIR --user 42 -n 10
    python -m ycnr_tpu_torch serve     --shm NAME --store DIR --listen :0
    python -m ycnr_tpu_torch publish   --ckpt DIR --shm NAME
    python -m ycnr_tpu_torch export    --ckpt DIR --out FILE.npz
    python -m ycnr_tpu_torch presets

The subcommands, flags, JSON lines and files are the JAX package's, with
``--device`` in place of ``--platform`` (``publish`` takes it too): by
default the card (``cuda``), ``--device cpu`` for a CPU run; without a card
the default stops with a message. ``train --ooc`` trains out of core
(``--ooc-wire``, ``--ooc-residency``). ``train --shards D`` trains over D
ranks (``train/sharded.py``): D local processes, or with
``--distributed`` (``--coordinator HOST:PORT --num-processes N
--process-id R``, else torchrun's environment) this process's rank of a
job started elsewhere. ``--dist-backend`` names the backend (default NCCL
on the card, gloo with ``--device cpu``; NCCL needs a card a rank, gloo
puts several ranks on one). ``train --ooc --shards D`` trains out of core
over D ranks, each with its slice of the rating wire pinned on its device
(``parallel/ooc_mesh.py``).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

from ycnr_tpu_torch.config import get_preset, list_presets

def _device(args):
    """The device a command runs on: ``--device`` as given, else the card;
    without one, a message instead of a traceback."""
    import torch

    if args.device is None and not torch.cuda.is_available():
        raise SystemExit(f"{args.cmd}: no CUDA device; pass --device cpu "
                         f"for a CPU run")
    return args.device or "cuda"


def _open_store(path: str):
    """Open a RatingsStore that must already hold rows.

    Every subcommand that reads a store means "use previously prepared
    data"; a missing/empty store would otherwise train or serve over zero
    ratings and report rmse 0.0 without any hint of what went wrong.
    """
    from ycnr_tpu_torch.data.store import RatingsStore

    if not os.path.isdir(path):
        # error before RatingsStore() so a typo'd path is not entrenched by
        # its makedirs side effect
        raise SystemExit(
            f"store {path!r} does not exist — run "
            f"`python -m ycnr_tpu_torch prepare --store {path} ...` first")
    st = RatingsStore(path)
    return (st, *_read_rows(st))


def _fold_params(manifest, args):
    """(lam, alpha) for serving-time fold-in solves: explicit --lam/--alpha
    flags win, else the checkpoint manifest's training hyperparams (an iALS
    checkpoint must get the confidence solve, not explicit ALS with default
    lam), else ALS defaults."""
    lam, alpha = 0.05, None
    cfg = (manifest or {}).get("config") or {}
    algo = cfg.get("algorithm")
    if algo == "ials":
        lam = cfg.get("ials", {}).get("lam", 0.1)
        alpha = cfg.get("ials", {}).get("alpha", 40.0)
    elif algo in ("als", "sgd", "bpr"):
        # bpr fold-in approximates with the explicit normal equations at
        # the model's own lam (no closed-form pairwise fold-in exists)
        lam = cfg.get(algo, {}).get("lam", lam)
    if getattr(args, "lam", None) is not None:
        lam = args.lam
    if getattr(args, "alpha", None) is not None:
        alpha = args.alpha if args.alpha > 0 else None
    return lam, alpha


def _read_rows(store):
    u, i, r = store.read_all()
    if len(r) == 0:
        raise SystemExit(
            f"store {store.path!r} is empty — run "
            f"`python -m ycnr_tpu_torch prepare --store {store.path} ...` "
            f"first")
    return u, i, r


def _map_ids(map_col, ids):
    """(dense_pos, bad_mask): original dataset ids looked up against one
    sorted id-map column."""
    import numpy as np

    ids = np.asarray(ids)
    pos = np.searchsorted(map_col, ids)
    bad = (pos >= len(map_col)) | (map_col[np.minimum(
        pos, len(map_col) - 1)] != ids)
    return pos, bad


def _parse_item_list(value: str, maps, n_items: int, flag: str):
    """Comma-separated ORIGINAL item ids -> (original_ids, dense_ids),
    or SystemExit listing the unknown/out-of-range ones — shared by
    recommend --predict and --exclude."""
    import numpy as np

    ii = np.asarray([int(x) for x in value.split(",") if x.strip()],
                    np.int64)
    if maps is not None:
        pos, bad = _map_ids(maps[1], ii)
        if bad.any():
            raise SystemExit(f"{flag}: unknown item ids "
                             f"{ii[bad].tolist()} in this dataset")
        return ii, pos
    bad = (ii < 0) | (ii >= n_items)
    if bad.any():
        raise SystemExit(f"{flag}: item ids {ii[bad].tolist()} not in "
                         f"the catalog (0..{n_items - 1})")
    return ii, ii


def _add_device(p):
    p.add_argument("--device",
                   help="torch device to run on (default: the card, "
                        "'cuda'; 'cpu' for a CPU run)")


def _add_train_overrides(p):
    p.add_argument("--preset", default=None,
                   help="base preset (default ml100k-als; a --config "
                        "file's \"preset\" key also selects it)")
    p.add_argument("--config", metavar="FILE.json",
                   help="JSON config file layered over the preset "
                        "(config.config_from_dict); other flags still win")
    p.add_argument("--source", help="synthetic | path to MovieLens file")
    p.add_argument("--store", help="RatingsStore dir to read instead of source")
    p.add_argument("--epochs", type=int)
    p.add_argument("--rank", type=int)
    p.add_argument("--algorithm", choices=["als", "sgd", "ials", "bpr"])
    p.add_argument("--shards", type=int,
                   help="train over this many ranks (torch.distributed)")
    p.add_argument("--vstep-mode", choices=["gram_psum", "item_sharded"],
                   help="sharded V-step collective strategy")
    p.add_argument("--sgd-method", choices=["batched", "stream"],
                   help="SGD epoch structure: 'batched' = uniformly "
                        "shuffled (oracle semantics), 'stream' = "
                        "user-sorted stream (models/sgd_stream.py)")
    p.add_argument("--out", default=None,
                   help="artifact dir (default: the config's out_dir, "
                        "else ./runs)")
    p.add_argument("--seed", type=int,
                   help="override cfg.seed (factor init + SGD shuffling) "
                        "and the synthetic data seed")
    p.add_argument("--resume", help="checkpoint dir to resume from")
    p.add_argument("--warm-start", metavar="CKPT",
                   help="start a NEW run from this checkpoint's factors, "
                        "grown to the current dataset's catalog")
    _add_device(p)
    p.add_argument("--profile", metavar="DIR",
                   help="write a torch.profiler Chrome trace to DIR")
    p.add_argument("--users", type=int, help="synthetic n_users")
    p.add_argument("--items", type=int, help="synthetic n_items")
    p.add_argument("--ratings", type=int, help="synthetic n_ratings")
    p.add_argument("--calibrated", action="store_true",
                   help="synthetic source only: calibrate to the published "
                        "ML-20M marginals — data/synthetic.py")
    p.add_argument("--max-groups", type=int,
                   help="bucketed-layout group cap (default 16)")
    p.add_argument("--split", choices=["random", "time", "last-out"],
                   help="held-out protocol: random holdout (default), "
                        "temporal global holdout by timestamp, or per-user "
                        "leave-last-k most recent (data/split.py)")
    p.add_argument("--last-k", type=int, dest="last_k",
                   help="k for --split last-out (default 1)")
    p.add_argument("--measure-serving", action="store_true",
                   help="time top-N for all users after training and log "
                        "the recs/s metric")
    p.add_argument("--train-scorer", dest="train_scorer",
                   choices=["exact", "fused", "fused32"],
                   help="serving scorer for --measure-serving (fused = the "
                        "fused scorer kernel; see recommend --scorer)")
    p.add_argument("--publish-shm", metavar="NAME",
                   help="publish factors into shared memory after each "
                        "epoch so serving processes hot-reload them "
                        "(serve.ShmRecommender)")
    p.add_argument("--ckpt-backend", choices=["npz", "orbax"],
                   help="checkpoint array storage (the port writes npz; "
                        "orbax is the JAX package's)")
    p.add_argument("--ooc", action="store_true",
                   help="out-of-core: keep only the factors resident; "
                        "ratings live in a compact wire, pinned on the "
                        "device or streamed from host memory (ALS/iALS, "
                        "stream SGD)")
    p.add_argument("--ooc-wire", choices=["rect", "packed"], default=None,
                   help="OOC wire format: packed (fewest bytes, default) "
                        "or rect (padded, gather-free decode)")
    p.add_argument("--ooc-residency", choices=["auto", "device", "host"],
                   default=None,
                   help="OOC residency: auto (pin what fits, stream the "
                        "rest), device (pin all or fail), host (stream "
                        "all)")
    p.add_argument("--fused-epochs", type=int, metavar="K",
                   help="ALS/iALS: log, checkpoint and early-stop at the "
                        "ends of blocks of K epochs, as the JAX package "
                        "does when it fuses them")
    p.add_argument("--early-stop", type=int, metavar="PATIENCE",
                   help="stop when held-out RMSE hasn't improved for "
                        "PATIENCE epochs")
    p.add_argument("--early-stop-delta", type=float, default=0.0,
                   help="minimum RMSE improvement that counts (with "
                        "--early-stop)")
    p.add_argument("--distributed", action="store_true",
                   help="join a multi-process job through torch.distributed "
                        "(torchrun's environment, or the flags below); run "
                        "one `train --distributed` per rank")
    p.add_argument("--coordinator", metavar="HOST:PORT",
                   help="explicit rendezvous address (implies "
                        "--distributed)")
    p.add_argument("--num-processes", type=int)
    p.add_argument("--process-id", type=int)
    p.add_argument("--dist-backend", choices=["nccl", "gloo"],
                   help="collective backend (default: nccl on the card, "
                        "gloo with --device cpu); nccl needs a card a rank")


def _refuse_unported(args):
    """One line for what the port lacks."""
    if args.ckpt_backend == "orbax":
        raise SystemExit(f"{args.cmd} --ckpt-backend orbax: orbax is a JAX "
                         f"package; the port writes npz checkpoints")


def _build_cfg(args):
    file_cfg = None
    preset = args.preset
    if getattr(args, "config", None):
        with open(args.config) as f:
            file_cfg = json.load(f)
        # the file's {"preset": name} selects the base unless --preset was
        # given explicitly (args.preset defaults to None so we can tell)
        if preset is None:
            preset = file_cfg.get("preset")
    cfg = get_preset(preset or "ml100k-als")
    if file_cfg is not None:
        # inline rather than config.load_config: the raw dict is also
        # peeked for "preset" (above) and "out_dir" (below)
        from ycnr_tpu_torch.config import config_from_dict

        cfg = config_from_dict(file_cfg, cfg)
    if args.algorithm:
        cfg = cfg.replace(algorithm=args.algorithm)
    dkw = {}
    if args.source:
        if args.source == "synthetic":
            dkw["source"] = "synthetic"
        else:
            ext = args.source.rsplit(".", 1)[-1].lower()
            kinds = {"data": "ml-100k", "dat": "ml-1m", "csv": "ml-20m"}
            if ext not in kinds:
                raise SystemExit(
                    f"--source {args.source!r}: unsupported extension "
                    f".{ext} (expected .data / .dat / .csv, or "
                    f"'synthetic')")
            dkw.update(source=kinds[ext], path=args.source)
    for k, a in (("n_users", "users"), ("n_items", "items"),
                 ("n_ratings", "ratings"), ("max_groups", "max_groups"),
                 ("split", "split"), ("last_k", "last_k")):
        v = getattr(args, a, None)
        if v:
            dkw[k] = v
    if getattr(args, "calibrated", False):
        dkw["synthetic_mode"] = "calibrated"
    if dkw:
        cfg = cfg.replace(data=dataclasses.replace(cfg.data, **dkw))
    if args.epochs is not None:
        for field in ("als", "sgd", "ials", "bpr"):
            cfg = cfg.replace(**{field: dataclasses.replace(
                getattr(cfg, field), epochs=args.epochs)})
    if args.rank:
        for field in ("als", "sgd", "ials", "bpr"):
            cfg = cfg.replace(**{field: dataclasses.replace(
                getattr(cfg, field), rank=args.rank)})
    if getattr(args, "sgd_method", None):
        cfg = cfg.replace(sgd=dataclasses.replace(cfg.sgd,
                                                  method=args.sgd_method))
    mesh_kw = {}
    if args.shards:
        mesh_kw["n_shards"] = args.shards
    if getattr(args, "vstep_mode", None):
        mesh_kw["vstep_mode"] = args.vstep_mode
    if mesh_kw:
        cfg = cfg.replace(mesh=dataclasses.replace(cfg.mesh, **mesh_kw))
    if getattr(args, "seed", None) is not None:
        cfg = cfg.replace(seed=args.seed,
                          data=dataclasses.replace(cfg.data,
                                                   seed=args.seed))
    if getattr(args, "measure_serving", False):
        cfg = cfg.replace(measure_serving=True)
    if getattr(args, "train_scorer", None):
        cfg = cfg.replace(scorer=args.train_scorer)
    if getattr(args, "publish_shm", None):
        cfg = cfg.replace(publish_shm=args.publish_shm)
    if getattr(args, "early_stop", None):
        cfg = cfg.replace(early_stop_patience=args.early_stop,
                          early_stop_min_delta=args.early_stop_delta)
    if getattr(args, "fused_epochs", None):
        cfg = cfg.replace(fused_epochs=args.fused_epochs)
    if getattr(args, "ooc", False):
        cfg = cfg.replace(ooc=True)
    if getattr(args, "ooc_wire", None):
        cfg = cfg.replace(ooc_wire=args.ooc_wire)
    if getattr(args, "ooc_residency", None):
        cfg = cfg.replace(ooc_residency=args.ooc_residency)
    if args.out is not None:
        cfg = cfg.replace(out_dir=args.out)
    elif not cfg.out_dir and not (file_cfg and "out_dir" in file_cfg):
        # nobody chose an out_dir -> ./runs; an explicit "" in the config
        # file means "no artifacts" and is honored
        cfg = cfg.replace(out_dir="runs")
    return cfg


def _store_dataset(args, cfg):
    """Dataset from a RatingsStore dir (--store), or None to let the
    train/tune path load cfg.data itself."""
    if not getattr(args, "store", None):
        return None
    from ycnr_tpu_torch.data.dataset import Dataset as DS
    from ycnr_tpu_torch.data.split import split_coo

    st, u, i, r = _open_store(args.store)
    n_users, n_items = st.meta["n_users"], st.meta["n_items"]
    # the ts column (~8 bytes/row on disk) only matters to temporal splits
    ts = st.read_ts() if cfg.data.split != "random" else None
    (tu, ti, tr), (su, si, sr) = split_coo(
        u, i, r, ts, method=cfg.data.split,
        test_fraction=cfg.data.test_fraction, seed=cfg.data.seed,
        last_k=cfg.data.last_k)
    params = {"als": cfg.als, "sgd": cfg.sgd, "ials": cfg.ials,
              "bpr": cfg.bpr}[cfg.algorithm]
    return DS(n_users=n_users, n_items=n_items, train_u=tu, train_i=ti,
              train_r=tr, test_u=su, test_i=si, test_r=sr,
              mu=float(tr.mean()), chunk_len=cfg.data.chunk_len,
              rank_hint=params.rank)


def cmd_train(args):
    _refuse_unported(args)
    if args.distributed or args.coordinator:
        from ycnr_tpu_torch.parallel.mesh import init_distributed

        pid = init_distributed(args.coordinator, args.num_processes,
                               args.process_id, backend=args.dist_backend,
                               device=args.device)
        print(json.dumps({"event": "distributed", "process_id": pid}))
    device = _device(args)
    cfg = _build_cfg(args)
    from ycnr_tpu_torch.train.loop import train

    ds = _store_dataset(args, cfg)

    def run():
        return train(cfg, dataset=ds, resume=args.resume,
                     warm_start=args.warm_start, device=device,
                     backend=args.dist_backend)

    if args.profile:
        from ycnr_tpu_torch.utils.profiling import trace

        with trace(args.profile):
            result = run()
    else:
        result = run()
    last = result.rmse_history[-1] if result.rmse_history else None
    # bpr's history tracks 1 - hit-rate (ranking logits have no RMSE);
    # surface the metric under its real name
    metric = ("final_hit_rate", round(1.0 - last, 6)) \
        if cfg.algorithm == "bpr" and last is not None \
        else ("final_rmse", last)
    print(json.dumps({
        "run": cfg.name, "algorithm": cfg.algorithm,
        "epochs": len(result.rmse_history),
        metric[0]: metric[1],
        "out_dir": result.out_dir,
    }))


def cmd_tune(args):
    """Hyperparameter sweep (train/tune.py): the lambda (x alpha for iALS,
    x lr for SGD/BPR) x seed grid, the device layouts built once per rank;
    a --ranks axis sweeps the whole grid at each rank. Prints one JSON
    line per config (best first) and saves the winner's trained factors
    as a normal checkpoint."""
    import dataclasses as dc

    _refuse_unported(args)
    device = _device(args)
    cfg = _build_cfg(args)

    def _floats(s):
        return [float(x) for x in s.split(",") if x.strip()]

    lams = _floats(args.lams)
    alphas = _floats(args.alphas) if args.alphas else None
    if alphas and cfg.algorithm != "ials":
        raise SystemExit("--alphas only applies to --algorithm ials")
    lrs = _floats(args.lrs) if args.lrs else None
    if lrs and cfg.algorithm not in ("sgd", "bpr"):
        raise SystemExit("--lrs only applies to --algorithm sgd/bpr")
    seeds = ([int(x) for x in args.seeds.split(",")] if args.seeds
             else [cfg.seed])
    ranks = ([int(x) for x in args.ranks.split(",")] if args.ranks
             else [None])
    from ycnr_tpu_torch.train.tune import tune

    field = cfg.algorithm
    ranked = cfg.algorithm in ("ials", "bpr")  # hit-rate metrics
    metric = (lambda e: -e["hit_rate"]) if ranked \
        else (lambda e: e["rmse_final"])
    board = []  # merged entries across ranks
    results = []  # (rank, TuneResult) per rank
    # one store read + split serves every rank: the split depends only on
    # cfg.data, and tune() builds the rank-dependent layouts from the COO
    ds = _store_dataset(args, cfg)

    def run():
        for rk in ranks:
            cfg_r = cfg if rk is None else cfg.replace(**{field: dc.replace(
                getattr(cfg, field), rank=rk)})
            res = tune(cfg_r, lams, alphas=alphas, lrs=lrs, seeds=seeds,
                       epochs=args.epochs, dataset=ds, device=device,
                       backend=args.dist_backend)
            results.append((rk, res))
            board.extend([{"rank": rk, **e} for e in res.leaderboard]
                         if rk is not None else res.leaderboard)

    if args.profile:
        from ycnr_tpu_torch.utils.profiling import trace

        with trace(args.profile):
            run()
    else:
        run()
    board.sort(key=metric)
    for entry in board:
        print(json.dumps(entry))
    # the global winner is its own rank's grid-best (same metric), so its
    # trained state is that rank's best_state
    best_entry = board[0]
    best_res = min(results, key=lambda t: metric(t[1].best))[1]
    out = {"event": "best", **best_entry}
    if cfg.out_dir:
        from ycnr_tpu_torch.train.checkpoint import (config_dict,
                                                     save_checkpoint)

        best_cfg = cfg.replace(seed=best_entry["seed"])
        pkw = {"lam": best_entry["lam"]}
        if "rank" in best_entry:
            pkw["rank"] = best_entry["rank"]
        if "alpha" in best_entry:
            pkw["alpha"] = best_entry["alpha"]
        if "lr" in best_entry:
            pkw["lr"] = best_entry["lr"]
            if field == "sgd":
                pkw["method"] = "stream"  # the sgd sweep ran the stream
                #                           trainer (BPRConfig has no method)
        best_cfg = best_cfg.replace(**{field: dc.replace(
            getattr(best_cfg, field), **pkw)})
        out_dir = os.path.join(cfg.out_dir, f"{cfg.name}-tune")
        os.makedirs(out_dir, exist_ok=True)
        epochs_run = len(best_entry.get("rmse") or best_entry["auc"])
        save_checkpoint(os.path.join(out_dir, "ckpt"), best_res.best_state,
                        epochs_run, config=config_dict(best_cfg))
        with open(os.path.join(out_dir, "tune.jsonl"), "w") as f:
            for entry in board:
                f.write(json.dumps(entry) + "\n")
        out["out_dir"] = out_dir
    print(json.dumps(out))


def cmd_prepare(args):
    import numpy as np

    from ycnr_tpu_torch.data.movielens import load_movielens
    from ycnr_tpu_torch.data.store import RatingsStore
    from ycnr_tpu_torch.data.synthetic import synthetic_ratings

    store = RatingsStore(args.store)
    if args.source == "synthetic":
        if args.calibrated:
            from ycnr_tpu_torch.data.synthetic import (
                synthetic_ratings_calibrated)

            u, i, r = synthetic_ratings_calibrated(
                args.users, args.items, args.ratings, seed=args.seed)
        else:
            u, i, r = synthetic_ratings(args.users, args.items,
                                        args.ratings, seed=args.seed)
        # stream order as time — continued from the store's existing rows
        # so re-running prepare keeps "later batch = later time" true
        ts = store.n_rows + np.arange(len(r), dtype=np.int64)
    else:
        u, i, r, _, _, umap, imap, ts = load_movielens(
            args.source, return_maps=True, return_ts=True)
        store.set_id_maps(umap, imap)  # dense index -> original dataset id
    if store.n_rows > 0 and not store.meta.get("has_ts"):
        # appending to a pre-timestamp store: columns are all-or-none, so
        # match its schema rather than hard-failing the incremental import
        print(json.dumps({"event": "warn", "msg":
                          "store has no timestamp column; dropping ts "
                          "from this batch (re-prepare into a fresh store "
                          "to enable --split time/last-out)"}),
              file=sys.stderr)
        ts = None
    for s in range(0, len(r), args.portion):
        store.append(u[s:s + args.portion], i[s:s + args.portion],
                     r[s:s + args.portion],
                     ts=None if ts is None else ts[s:s + args.portion])
    print(json.dumps({"store": args.store, "rows": store.n_rows,
                      "n_users": store.meta["n_users"],
                      "n_items": store.meta["n_items"],
                      "id_maps": bool(store.meta.get("has_id_maps")),
                      "timestamps": bool(store.meta.get("has_ts"))}))


def cmd_recommend(args):
    if not args.ckpt and not args.shm and not getattr(args, "popular",
                                                      False):
        # --popular only counts store rows; it never loads factor state
        raise SystemExit("recommend: one of --ckpt / --shm is required")
    import numpy as np

    from ycnr_tpu_torch.data.store import RatingsStore
    from ycnr_tpu_torch.eval.recommend import NEG_INF

    if not os.path.isdir(args.store):
        # same guard as _open_store: don't let RatingsStore's makedirs
        # entrench a typo'd path before erroring
        raise SystemExit(
            f"store {args.store!r} does not exist — run "
            f"`python -m ycnr_tpu_torch prepare --store {args.store} ...` "
            f"first")
    store = RatingsStore(args.store)
    maps = store.id_maps()  # dense -> original dataset ids (if imported)

    excl = None
    if getattr(args, "exclude", None):
        for bad_flag in ("rated", "popular", "similar", "predict"):
            if getattr(args, bad_flag, None):
                raise SystemExit(
                    f"--exclude applies to top-N lists (--user / --all); "
                    f"it is not supported with --{bad_flag}")
        _, excl = _parse_item_list(args.exclude, maps,
                                   int(store.meta["n_items"]), "--exclude")

    def _load_state():
        """(state, manifest | None) on the command's device; shm segments
        carry no manifest."""
        if args.shm:
            from ycnr_tpu_torch.serve.shm import FactorShmReader

            with FactorShmReader(args.shm) as reader:
                return reader.read(device=_device(args))[0], None
        from ycnr_tpu_torch.train.checkpoint import load_checkpoint

        return load_checkpoint(args.ckpt, device=_device(args))

    if getattr(args, "all", False):
        # batch offline serving: top-N for EVERY rated user through the
        # rated-bits path, written as JSONL
        from ycnr_tpu_torch.eval.recommend import overfetch_n, recommend_all
        from ycnr_tpu_torch.ops.layout import build_blocked_csr

        u, i, r = _read_rows(store)
        state, _ = _load_state()
        if (int(u.max(initial=0)) >= state.n_users
                or int(i.max(initial=0)) >= state.n_items):
            raise SystemExit(
                f"store ids exceed the factor dims "
                f"({state.n_users} users x {state.n_items} items) — "
                "wrong store for these factors?")
        lay = build_blocked_csr(u, i, r, state.n_users, state.n_items,
                                rank_hint=state.rank)
        # --exclude: over-fetch so every list stays full after filtering
        n_fetch = args.n if excl is None else overfetch_n(args.n,
                                                          len(excl))
        # an explicit fused scorer on a catalog K2 cannot take raises on
        # the card (eval/recommend.use_fused); it is never swapped
        users, items, scores = recommend_all(state, lay, n=n_fetch,
                                             method=args.scorer)
        if maps is not None:
            users = maps[0][users]
        out = open(args.save, "w") if args.save else sys.stdout
        try:
            for j in range(len(users)):
                # users with fewer than n unrated items get NEG_INF-masked
                # tail entries whose indices are padded columns — drop them
                # before any id-map lookup (padded index >= len(maps[1]))
                keep = scores[j] > NEG_INF / 2
                if excl is not None:
                    keep &= ~np.isin(items[j], excl)
                keep &= np.cumsum(keep) <= args.n  # trim back to n
                row = items[j][keep]
                if maps is not None:
                    row = maps[1][row]
                out.write(json.dumps({
                    "user": int(users[j]),
                    "items": [int(x) for x in row],
                    "scores": [round(float(x), 4)
                               for x in scores[j][keep]],
                }) + "\n")
        finally:
            if args.save:
                out.close()
                print(json.dumps({"event": "recommend_all",
                                  "users": int(len(users)), "n": args.n,
                                  "save": args.save}))
        return

    if getattr(args, "popular", False):
        # zero-history fallback: top-N by training rating count (shared
        # implementation with engine.popular — eval/recommend.top_popular)
        from ycnr_tpu_torch.eval.recommend import top_popular

        u, i, r = _read_rows(store)
        top = top_popular(i, int(store.meta["n_items"]), args.n)
        if maps is not None:
            top = maps[1][top]
        print(json.dumps({"popular": [int(x) for x in top]}))
        return

    if getattr(args, "similar", None) is not None:
        # item-item "more like this": factor-row similarity over V
        from ycnr_tpu_torch.eval.similar import similar_items

        state, _ = _load_state()
        for iid in args.similar:
            dense = iid
            if maps is not None:
                pos, bad = _map_ids(maps[1], [iid])
                if bad[0]:
                    print(json.dumps({"item": iid, "error":
                                      "unknown item id in this dataset"}))
                    continue
                dense = int(pos[0])
            elif not 0 <= iid < state.n_items:
                # dense-id store: an out-of-range id would gather the zero
                # trash row and print a junk list
                print(json.dumps({"item": iid, "error":
                                  f"item id not in the catalog "
                                  f"(0..{state.n_items - 1})"}))
                continue
            top_i, top_s = similar_items(state, [dense], args.n,
                                         metric=args.metric)
            items = top_i[0][top_s[0] > NEG_INF / 2]
            if maps is not None:
                items = maps[1][np.asarray(items)]
            print(json.dumps({"item": iid,
                              "similar": [int(x) for x in items]}))
        return

    if args.rated:
        # ad-hoc cold user: "--rated item:rating,..." -> fold-in serving
        # (row gather + K1 on the card; needs only the factor state)
        from ycnr_tpu_torch.serve.fold_in import recommend_fold_in

        pairs = [p.split(":") for p in args.rated.split(",")]
        ii = np.asarray([int(a) for a, _ in pairs])
        rr = np.asarray([float(b) for _, b in pairs], np.float32)
        if maps is not None:
            pos, bad = _map_ids(maps[1], ii)
            if bad.any():
                print(json.dumps({"user": "cold", "error":
                                  "unknown item ids in this dataset",
                                  "items": [int(x) for x in ii[bad]]}))
                return
            ii = pos
        state, manifest = _load_state()
        lam, alpha = _fold_params(manifest, args)
        top_i, top_s = recommend_fold_in(state, [ii], [rr], n=args.n,
                                         lam=lam, alpha=alpha)
        # drop the NEG_INF-masked tail (fewer unrated items than n): their
        # indices are padding and would break the maps[1] lookup
        items = top_i[0][top_s[0] > NEG_INF / 2]
        if maps is not None:
            items = maps[1][np.asarray(items)]
        print(json.dumps({"user": "cold",
                          "items": [int(x) for x in items]}))
        return

    from ycnr_tpu_torch.serve.engine import Recommender

    u, i, r = _read_rows(store)
    rec = Recommender(_load_state()[0], u, i)
    pred_items = None
    if getattr(args, "predict", None):
        # point prediction r_hat(u, i) instead of top-N
        if not args.user:
            raise SystemExit("recommend --predict needs --user")
        pred_items = _parse_item_list(args.predict, maps,
                                      int(store.meta["n_items"]),
                                      "--predict")
    for uid in args.user:
        dense = uid
        if maps is not None:
            pos = np.searchsorted(maps[0], uid)
            if pos >= len(maps[0]) or maps[0][pos] != uid:
                print(json.dumps({"user": uid,
                                  "error": "unknown user id in this dataset"}))
                continue
            dense = int(pos)
        if pred_items is not None:
            scores = rec.predict(dense, pred_items[1])
            print(json.dumps({"user": uid,
                              "items": [int(x) for x in pred_items[0]],
                              "scores": [round(float(s), 4)
                                         for s in scores]}))
            continue
        items = rec.recommend(dense, args.n, exclude=excl)
        if maps is not None:
            items = maps[1][np.asarray(items)]
        print(json.dumps({"user": uid, "items": [int(x) for x in items]}))


def cmd_serve(args):
    """Long-running serving loop: one request per stdin line, one JSON
    response per stdout line (the protocol of ``serve/server.py``). With
    --shm the factors hot-reload whenever the trainer republishes; with
    --listen the same protocol runs behind a thread-per-connection TCP
    server; with --shm-cache computed lists are shared with every serving
    process attached to that cache segment."""
    if not args.ckpt and not args.shm:
        raise SystemExit("serve: one of --ckpt / --shm is required")
    device = _device(args)
    from ycnr_tpu_torch.serve.server import ServingApp

    store, u, i, r = _open_store(args.store)
    maps = store.id_maps()
    manifest = None
    shared_cache = None
    if args.shm_cache:
        from ycnr_tpu_torch.serve.cache import ShmRecCache

        shared_cache = ShmRecCache(args.shm_cache)
    if args.shm:
        from ycnr_tpu_torch.serve.shm import ShmRecommender

        rec = ShmRecommender(args.shm, u, i, cache=shared_cache,
                             device=device)
    else:
        from ycnr_tpu_torch.serve.engine import Recommender
        from ycnr_tpu_torch.train.checkpoint import load_checkpoint

        state0, manifest = load_checkpoint(args.ckpt, device=device)
        rec = Recommender(state0, u, i, train_r=r, cache=shared_cache)
    fold_lam, fold_alpha = _fold_params(manifest, args)
    app = ServingApp(
        rec, maps=maps, n=args.n, fold_lam=fold_lam, fold_alpha=fold_alpha,
        store_meta=store.meta, source="shm" if args.shm else "ckpt",
        epoch=(manifest.get("epoch") if manifest else None),
        shm=bool(args.shm))

    ready = {"event": "ready", "users": int(store.meta["n_users"]),
             "items": int(store.meta["n_items"])}
    eng = rec.engine if args.shm else rec
    if args.precompute:
        ready["precomputed"] = eng.precompute_all(args.n)
    if args.precompute_similar:
        ready["precomputed_similar"] = eng.precompute_similar(args.n)
    if args.listen:
        from ycnr_tpu_torch.serve.server import serve_tcp

        host, _, port = args.listen.rpartition(":")
        with serve_tcp(app, host, int(port)) as srv:
            ready["listen"] = "%s:%d" % srv.server_address[:2]
            print(json.dumps(ready), flush=True)
            srv.serve_forever()
    else:
        print(json.dumps(ready), flush=True)
        for line in sys.stdin:
            line = line.strip()
            if line:
                print(app.handle(line), flush=True)


def cmd_publish(args):
    """Load a checkpoint and publish it into a named shm segment (boots a
    serving fleet from durable storage)."""
    from ycnr_tpu_torch.serve.shm import publish_checkpoint

    epoch = publish_checkpoint(args.ckpt, args.shm, device=_device(args))
    print(json.dumps({"shm": args.shm, "ckpt": args.ckpt, "epoch": epoch}))


def cmd_export(args):
    """Export trained factors as one portable .npz keyed by ORIGINAL
    dataset ids. Keys: user_ids, item_ids, U, V, bu, bi, mu (padding rows
    dropped; ids dense 0..n-1 when the store was imported without maps)."""
    import numpy as np
    import torch

    from ycnr_tpu_torch.models.base import unpad
    from ycnr_tpu_torch.train.checkpoint import load_checkpoint

    state, manifest = load_checkpoint(args.ckpt, device=_device(args))
    if state.U.dtype not in (torch.float32, torch.float64):
        # portable contract: downstream np.load must see plain floats
        state = state._replace(**{k: v.float() for k, v in
                                  state._asdict().items()})
    U, V, bu, bi, mu = unpad(state)
    user_ids = np.arange(state.n_users, dtype=np.int64)
    item_ids = np.arange(state.n_items, dtype=np.int64)
    id_space = "dense"
    if args.store:
        from ycnr_tpu_torch.data.store import RatingsStore

        maps = RatingsStore(args.store).id_maps()
        if maps is not None:
            if len(maps[0]) != state.n_users or \
                    len(maps[1]) != state.n_items:
                raise SystemExit(
                    f"store maps cover {len(maps[0])} users x "
                    f"{len(maps[1])} items but the checkpoint holds "
                    f"{state.n_users} x {state.n_items} — wrong store?")
            user_ids, item_ids = maps
            id_space = "dataset"
    np.savez_compressed(args.out, user_ids=user_ids, item_ids=item_ids,
                        U=U, V=V, bu=bu, bi=bi, mu=np.float32(mu))
    print(json.dumps({
        "out": args.out, "users": int(state.n_users),
        "items": int(state.n_items), "rank": int(state.rank),
        "epoch": manifest["epoch"], "id_space": id_space}))


def cmd_validate(args):
    """Held-out validation from a checkpoint: RMSE over a split, plus
    hit-rate@N or the full ranking suite."""
    import torch

    from ycnr_tpu_torch.data.split import split_coo
    from ycnr_tpu_torch.eval.ranking import hit_rate_at_n
    from ycnr_tpu_torch.models.base import rmse_padded
    from ycnr_tpu_torch.ops.layout import pad_coo
    from ycnr_tpu_torch.train.checkpoint import load_checkpoint

    state, manifest = load_checkpoint(args.ckpt, device=_device(args))
    store, u, i, r = _open_store(args.store)
    if (int(u.max(initial=0)) >= state.n_users
            or int(i.max(initial=0)) >= state.n_items):
        # out-of-range ids would gather trash rows and print a plausible
        # but wrong RMSE — refuse instead
        raise SystemExit(
            f"store {args.store!r} holds users up to {int(u.max())} / "
            f"items up to {int(i.max())}, but the checkpoint was trained "
            f"on {state.n_users} users x {state.n_items} items — wrong "
            "store for this checkpoint?")
    (tu, ti, tr), (su, si, sr) = split_coo(
        u, i, r, store.read_ts() if args.split != "random" else None,
        method=args.split, test_fraction=args.test_fraction,
        seed=args.seed, last_k=args.last_k)
    pu, pi, pr, n = pad_coo(su, si, sr, state.n_users, state.n_items)
    dev = state.U.device
    rmse = float(rmse_padded(state, torch.as_tensor(pu, device=dev),
                             torch.as_tensor(pi, device=dev),
                             torch.as_tensor(pr, device=dev), n))
    out = {"ckpt": args.ckpt, "epoch": manifest["epoch"],
           "n_test": int(n), "rmse_test": round(rmse, 6)}
    if args.ranking:
        from ycnr_tpu_torch.eval.ranking import ranking_metrics_at_n

        out["ranking"] = ranking_metrics_at_n(
            state, tu, ti, su, si, n=args.n, max_users=args.max_users)
    elif args.hit_rate:
        out["hit_rate"] = round(hit_rate_at_n(
            state, tu, ti, su, si, n=args.n, max_users=args.max_users), 4)
    print(json.dumps(out))


def cmd_presets(args):
    for name in list_presets():
        cfg = get_preset(name)
        print(f"{name}: algo={cfg.algorithm} "
              f"rank={_rank(cfg)} shards={cfg.mesh.n_shards} "
              f"data={cfg.data.source}")


def _rank(cfg):
    return {"als": cfg.als.rank, "sgd": cfg.sgd.rank, "ials": cfg.ials.rank,
            "bpr": cfg.bpr.rank}[cfg.algorithm]


def main(argv=None):
    ap = argparse.ArgumentParser(prog="ycnr_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("train", help="train a model from a preset")
    _add_train_overrides(p)
    p.set_defaults(fn=cmd_train)

    p = sub.add_parser("tune", help="hyperparameter sweep")
    _add_train_overrides(p)
    p.add_argument("--lams", required=True,
                   help="comma-separated lambda grid, e.g. 0.02,0.05,0.1")
    p.add_argument("--alphas",
                   help="comma-separated iALS confidence-alpha grid "
                        "(ials only; crossed with --lams)")
    p.add_argument("--lrs",
                   help="comma-separated SGD/BPR learning-rate grid "
                        "(crossed with --lams; SGD sweeps run the stream "
                        "trainer)")
    p.add_argument("--ranks",
                   help="comma-separated factor-rank grid; the whole grid "
                        "is swept at each rank")
    p.add_argument("--seeds",
                   help="comma-separated init seeds to cross with the grid "
                        "(default: the config seed)")
    p.set_defaults(fn=cmd_tune)

    p = sub.add_parser("prepare", help="import ratings into a store")
    p.add_argument("--source", required=True,
                   help="synthetic | MovieLens file path")
    p.add_argument("--store", required=True)
    p.add_argument("--users", type=int, default=1000)
    p.add_argument("--items", type=int, default=500)
    p.add_argument("--ratings", type=int, default=50000)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--portion", type=int, default=1_000_000)
    p.add_argument("--calibrated", action="store_true",
                   help="synthetic: calibrate to published ML-20M "
                        "marginals (see train --calibrated)")
    p.set_defaults(fn=cmd_prepare)

    p = sub.add_parser("recommend",
                       help="serve top-N from a checkpoint or shm store")
    p.add_argument("--ckpt", help="checkpoint dir (or use --shm)")
    p.add_argument("--shm", metavar="NAME",
                   help="attach factors from a shared-memory store "
                        "published by `train --publish-shm` / `publish`")
    p.add_argument("--store", required=True)
    p.add_argument("--user", type=int, nargs="*", default=[],
                   help="trained user ids to serve (or use --rated)")
    p.add_argument("--rated", metavar="ITEM:RATING,...",
                   help="serve a cold user by fold-in from this ad-hoc "
                        "rating list instead of a trained user id")
    p.add_argument("--popular", action="store_true",
                   help="zero-history fallback: top-N items by training "
                        "rating count")
    p.add_argument("--predict", metavar="ITEM,ITEM,...",
                   help="point prediction mode: print r_hat(user, item) "
                        "for each --user x given item instead of top-N")
    p.add_argument("--exclude", metavar="ITEM,ITEM,...",
                   help="drop these catalog items from every top-N list")
    p.add_argument("--similar", type=int, nargs="*", default=None,
                   metavar="ITEM",
                   help="item-item mode: top-N most similar catalog items "
                        "per given item id (factor-row similarity over V)")
    p.add_argument("--metric", choices=["cosine", "dot"], default="cosine",
                   help="similarity metric for --similar")
    p.add_argument("--all", action="store_true",
                   help="batch mode: top-N for EVERY rated user as JSONL "
                        "(stdout, or --save FILE)")
    p.add_argument("--save", metavar="FILE",
                   help="with --all: write the JSONL here and print a "
                        "summary line instead")
    p.add_argument("--scorer", choices=["exact", "fused", "fused32"],
                   default="exact",
                   help="with --all: serving scorer. fused = the fused "
                        "scorer kernel (bf16 score precision); fused32 = "
                        "the kernel with f32 scores")
    p.add_argument("-n", type=int, default=10)
    _add_device(p)
    p.add_argument("--lam", type=float,
                   help="fold-in regularization override (default: the "
                        "checkpoint's training lam)")
    p.add_argument("--alpha", type=float,
                   help="fold-in implicit-confidence alpha override "
                        "(0 forces the explicit solve)")
    p.set_defaults(fn=cmd_recommend)

    p = sub.add_parser("serve",
                       help="serving loop: user ids on stdin, JSON recs on "
                            "stdout (hot-reloads factors with --shm)")
    p.add_argument("--ckpt")
    p.add_argument("--shm", metavar="NAME")
    p.add_argument("--store", required=True)
    p.add_argument("-n", type=int, default=10)
    _add_device(p)
    p.add_argument("--listen", metavar="HOST:PORT",
                   help="serve the same line protocol over TCP instead of "
                        "stdin (port 0 picks a free port, printed in the "
                        "ready line)")
    p.add_argument("--shm-cache", metavar="NAME",
                   help="share computed top-N lists across every serving "
                        "process through a POSIX-shm cache segment "
                        "(entries are keyed by the published factor epoch, "
                        "so a republish invalidates fleet-wide)")
    p.add_argument("--precompute", action="store_true",
                   help="bulk-fill the cache with top-N for EVERY rated "
                        "user at startup (one pass through the fused "
                        "scorer kernel)")
    p.add_argument("--precompute-similar", action="store_true",
                   help="bulk-fill the cache with top-N similar items for "
                        "EVERY live catalog item at startup")
    p.add_argument("--lam", type=float,
                   help="fold-in regularization override (default: the "
                        "checkpoint's training lam)")
    p.add_argument("--alpha", type=float,
                   help="fold-in implicit-confidence alpha override "
                        "(0 forces the explicit solve)")
    p.set_defaults(fn=cmd_serve)

    p = sub.add_parser("publish",
                       help="publish checkpoint factors into shared memory "
                            "for serving processes")
    p.add_argument("--ckpt", required=True)
    p.add_argument("--shm", metavar="NAME", required=True)
    _add_device(p)
    p.set_defaults(fn=cmd_publish)

    p = sub.add_parser("export",
                       help="export factors as a portable .npz keyed by "
                            "original dataset ids")
    p.add_argument("--ckpt", required=True)
    p.add_argument("--out", required=True, metavar="FILE.npz")
    p.add_argument("--store",
                   help="store dir whose id maps key the export (omit for "
                        "dense 0..n-1 ids)")
    _add_device(p)
    p.set_defaults(fn=cmd_export)

    p = sub.add_parser("validate", help="held-out RMSE from a checkpoint")
    p.add_argument("--ckpt", required=True)
    p.add_argument("--store", required=True)
    p.add_argument("--test-fraction", type=float, default=0.1)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--split", choices=["random", "time", "last-out"],
                   default="random",
                   help="held-out protocol (match the training --split so "
                        "train and validate see the same test rows)")
    p.add_argument("--last-k", type=int, dest="last_k", default=1,
                   help="k for --split last-out")
    p.add_argument("--hit-rate", action="store_true")
    p.add_argument("--ranking", action="store_true",
                   help="full top-N suite: hit-rate, precision, recall, "
                        "NDCG, MAP @N")
    p.add_argument("-n", type=int, default=10)
    p.add_argument("--max-users", type=int, default=2048)
    _add_device(p)
    p.set_defaults(fn=cmd_validate)

    p = sub.add_parser("presets", help="list config presets")
    p.set_defaults(fn=cmd_presets)

    args = ap.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
