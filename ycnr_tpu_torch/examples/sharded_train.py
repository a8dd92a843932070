"""Sharded training through the library API: 8 rank processes, users
partitioned across them, the item Gram matrices all-reduced each epoch.
On the card every rank needs a card of its own for NCCL; ``--backend
gloo`` puts all of them on one (their collectives then go through host
memory), and ``--device cpu`` runs them on the CPU over gloo.

Run: python -m ycnr_tpu_torch.examples.sharded_train [--device cpu]
"""

import argparse

import numpy as np

N_USERS, N_ITEMS, RANK = 1_000, 400, 8


def rank_main(mesh, u, i, r, su, si, sr):
    """What every rank runs; rank 0's return value comes back."""
    from ycnr_tpu_torch.models.base import init_state
    from ycnr_tpu_torch.parallel import (build_sharded_data, gather_state,
                                         put_shard, scatter_state,
                                         sharded_als_epoch,
                                         sharded_recommend_all, sharded_rmse)

    # every rank builds all shards' arrays on the host, keeps its own
    host, meta = build_sharded_data(u, i, r, N_USERS, N_ITEMS,
                                    n_shards=mesh.world, chunk_len=16,
                                    rank_hint=RANK, test_u=su, test_i=si,
                                    test_r=sr)
    data = put_shard(host, mesh)
    st = scatter_state(init_state(N_USERS, N_ITEMS, RANK, seed=0,
                                  device=mesh.device), meta, mesh)
    for epoch in range(4):
        st = sharded_als_epoch(mesh, st, data, lam=0.05)
        rmse = sharded_rmse(mesh, st, data, meta.test_n)  # all ranks call
        if mesh.rank == 0:
            print(f"epoch {epoch + 1}: rmse={rmse:.4f}", flush=True)

    # top-N for every user, each rank scoring its own users against the
    # replicated V, the lists gathered on every rank
    users, items, _ = sharded_recommend_all(mesh, st, data, meta, n=5)
    # back to a plain single-GPU MFState (checkpointing / serving); a
    # collective, so every rank calls it
    state = gather_state(st, meta, mesh)
    if mesh.rank == 0:
        print("first user:", users[0], "items:", items[0], flush=True)
    return tuple(state.U.shape), tuple(state.V.shape)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", help="torch device (default: the card)")
    ap.add_argument("--ranks", type=int, default=8)
    ap.add_argument("--backend", choices=["nccl", "gloo"],
                    help="default: nccl on the card, gloo on the CPU")
    args = ap.parse_args(argv)

    from ycnr_tpu_torch.data.split import train_test_split
    from ycnr_tpu_torch.data.synthetic import synthetic_ratings
    from ycnr_tpu_torch.parallel import spawn_ranks

    u, i, r = synthetic_ratings(N_USERS, N_ITEMS, 40_000, true_rank=6,
                                seed=0)
    (tu, ti, tr), (su, si, sr) = train_test_split(u, i, r, 0.1, seed=0)
    shapes = spawn_ranks(
        "ycnr_tpu_torch.examples.sharded_train:rank_main", args.ranks,
        backend=args.backend, device=args.device,
        arrays=dict(u=tu, i=ti, r=tr, su=su, si=si, sr=sr))
    print("gathered factors:", *shapes)


if __name__ == "__main__":
    main()
