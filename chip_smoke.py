"""Smoke run of the PyTorch/CUDA port (``ycnr_tpu_torch``) on one GPU.

Run from the repository root:  python3 chip_smoke.py

1. device: needs CUDA (exits 1 without it; there is no CPU path);
2. build: compiles the CUDA kernels (nvcc) and the native MovieLens parser
   (g++) from ``ycnr_tpu_torch/csrc``; the parser is held to the Python
   parser on a 200,000-row file;
3. K1's warp body (batched SPD solve, n <= 64) against its plain version
   in float64, n = 10, 32, 64, with padding and ill-conditioned (guarded)
   systems; timed at n = 64 beside the plain solve and
   ``torch.linalg.solve`` at B = 20,000, and alone at B = 8 and B = 256;
4. K2 (fused masked scorer) on one MovieLens-20M-width serving block and
   on one ragged block (rank 10), bf16 and f32 score buffers: within its
   stated bound of its plain version and of a float64 sum, rated and
   padding columns exactly ``NEG_INF``, segment maxima exactly those of
   the stored scores;
5. ``row_gather`` against ``table[idx]`` and ``take_along_rows`` against
   ``torch.gather``, bit for bit, at widths 64/128, bf16/f32, int32/int64
   indices, from the 26,744-row and 480,189-row tables; each timed beside
   its plain version and that one PyTorch call;
6. the main path as ``bench.py`` runs it: ALS-WR rank 64 on the
   ML-20M-shaped synthetic set (generated once on the host lane, see
   below, into the port's bench cache, ``ycnr_tpu_torch/tools/bench.py``,
   in a directory of the script's own: the split read back bit-equal to
   ``train_test_split`` of the set, and read from there, with the layouts
   cached beside it, by every bench and tool run below),
   bucketed layout (8 groups), bf16 gathers through the fused gather ->
   Gram kernel with the ridge in its epilogue
   (first held to its bound on the smallest-R and largest-R blocks of both
   layouts, then on every block of the user layout with a bf16 table of
   the item factor's shape at w 128, 192, 256 and 250: the 4-warp body's
   widest and the wide body's, each within its bound of the plain version
   and within F64_REL of float64, bit-symmetric, padding exact, a second
   run bit-equal, timed beside the plain version, the bound and the
   figures of the mma.sync wide body it replaced), then K1; 4 epochs with held-out RMSE, held to the reference
   trajectory and to PR 2's; epoch 3 profiled by kernel;
7. serving: ``Recommender.precompute_all`` through K2 for every user,
   checked against the exact scorer on a sample, plus single and batch
   requests; one serving pass profiled by kernel;
8. the blocked-layout path (``ALSWR``, ``ImplicitALS``: row gather,
   sorted-segment sums, K1) at full width: every block's gather bit-equal
   to plain indexing, then the path against the bucketed path with f32
   gathers from the same start, held-out RMSE to 1e-4;
9. fold-in of 256 users against a float64 solve, no rated item served;
10. the two gather probes at a reduced size (``take_along_rows``; run
    right after item 5, while the host lane makes the data);
11. biased SGD at the full width of the ``ml1m-sgd`` preset (synthetic
    ML-1M shape, rank 16, batch 8,192, 20 epochs) through ``train()``,
    batched and stream: one batched epoch against the float64 oracle,
    held-out RMSE falling, the stream run within 0.02 of the batched one,
    one epoch twice bit-equal, a run resumed from its epoch-10 checkpoint
    bit-equal to the uninterrupted one, trash rows zero; one epoch of each
    profiled by kernel;
12. ``row_gather`` at the row widths those trainers give it (64-, 68- and
    136-byte rows: its 16-, 4- and 8-byte paths) on their own tables and
    index batches, bit for bit, timed cold in the L2 beside ``table[idx]``
    and the bound (and warm, and at 1,048,576 rows from a large table);
13. BPR at the full width of the ``ml20m-bpr`` preset (rank 32, batch
    65,536, ``emean``, ``shuffle="batches"``, 2 epochs) through
    ``train()`` on the ML-20M-shaped set: one epoch of each shuffle mode
    on the ML-1M-shaped set against the float64 oracle, hit-rate@10 above
    the start's, ``bu`` and ``mu`` untouched, one epoch twice bit-equal,
    the final ranking event finite, ``measure_serving`` through the fused
    scorer (K2 launches, the event says ``fused``); one epoch profiled by
    kernel;
14. online serving on the trained main-path state: ``add_ratings`` (row
    gather + K1) against a float64 solve, ``compact``, ``popular``,
    ``similar`` / ``precompute_similar`` against a float64 cosine,
    ``recommend_cold``;
15. K1's tiled body (64 < n <= 256) at n = 65, 96, 127, 128, 129, 160,
    192, 250 and 256 on 20,000 guarded systems (4,096 at the five sizes
    not timed) against a float64 solve
    (within cond(A) n 2^-24 on the first 512), padding rows exactly 0, and
    on 64 well-conditioned systems against its plain-torch mirror
    (``tests/k1_tiled_mirror.py``, 1e-5); timed at n = 96, 128,
    192 and 256 as in item 3 (run right after item 3);
16. ALS-WR at ranks 128 and 192 with bf16 gathers through ``train()`` on
    the ML-20M-shaped set, 2 epochs each: ``fused_gram`` (at 192 its wide
    body; no ``row_gather``) -> K1's tiled body; RMSE
    falls, trash and cold rows 0, held-out RMSE within 2e-6 and the
    factors within 1e-2 of the same run with the solve patched to the plain
    version in float64, while a control run with A and b rounded to TF32
    fails that pair; at 192 also the same
    run with the route patched back to row gather -> einsum -> K1 (within
    1e-4 at each epoch) and ``train(ooc=True)`` with the wire pinned (bit
    for bit); s/epoch, one more epoch by kernel (K1's share); one rank-256
    epoch on the rank-192 layouts (the wide body at w 256); then fold-in
    of 256 users at rank 192 and, from a random start, at rank 256;
17. the command line in process (``ycnr_tpu_torch.cli.main``) at full
    width from a ``RatingsStore`` of the same arrays: ``train --preset
    ml20m-als`` (the main path's split through a config file) held to an
    in-process ``train()`` and the reference trajectory, ``validate
    --hit-rate``, ``recommend --all --scorer fused`` (K2) against in-process
    ``recommend_all``, ``--user``, ``--rated`` (fold-in), ``export``, and a
    three-lam ``tune`` whose entries equal standalone ``train()`` runs;
18. the serving processes at the same width: the CLI's ``train
    --publish-shm`` segment bit-equal to its checkpoint (epoch 4),
    ``publish``, then ``ShmRecommender`` + ``ShmRecCache`` +
    ``ServingApp`` behind ``serve_tcp`` in process: ``precompute_all``
    (K2), 8 clients x 256 single-user lines, 16 ``batch:`` lines of 1,024
    users, 256 ``cold:`` lines (row gather + K1), ``predict:`` /
    ``exclude:`` / ``similar:`` / ``popular`` / ``stats``, held to the
    in-process engine (up to f32 ties; K2's own lists where the cache
    holds them) and, for 256 users, a float64 host scoring; three
    republishes under traffic (every answer one published state's list,
    epochs monotone on each connection, then all at the last); a second
    ``python -m ycnr_tpu_torch serve`` process on the same segment and
    cache (the same lists, hits on the first process's entries);
19. out-of-core training on the main path's arrays (``models/ooc.py``):
    the packed wire of both views (host build seconds, bytes a rating,
    RECT bytes); ALS-WR 4 epochs through ``train(ooc=True)`` with the wire
    pinned ("device", RECT) and streamed from host memory ("host",
    packed), and through ``als_epoch_ooc`` with half of it pinned, each
    bit-equal to the resident ``train()`` of the same config (RMSE
    trajectory and factors), within 1e-3 of the reference trajectory,
    trash and cold rows 0, with s/epoch, bytes streamed, epoch 3 by kernel
    and the peak device memory (the streamed run's below the resident
    run's, and within ``auto_wire_budget``'s reserve); one iALS epoch
    streamed, bit-equal to the resident epoch; wire-order storage (2
    epochs) against the classic OOC run from the same init; ``rmse_wire``
    against ``rmse_padded``; stream SGD with ``ml1m-sgd``'s
    hyperparameters on these arrays (2 epochs, one batch order) in its
    four forms (flat / compact, resident / streamed), bit-equal; and
    ``train --ooc --preset ml20m-als`` on the store of item 17, equal to
    the resident ``train()``;
20. the mesh (``parallel/``) on the main path's arrays, written once as an
    ``.npy`` set and read by real rank processes of the port's launcher:
    ALS-WR rank 64, bf16 gathers, gram_psum, 4 epochs from the main path's
    start, at D = 1 over NCCL and D = 2 over gloo (both ranks on cuda:0),
    the RMSE held to the reference trajectory (1e-3) and to the resident
    main path (1e-4), trash rows 0, K1 and ``row_gather`` launched on
    every rank, bytes and host milliseconds of the collectives, peak
    memory per rank; after the D = 2 run ``sharded_recommend_all`` with
    K2 on every rank (4,096 lists held to ``recommend_users`` on the
    gathered state) and one item_sharded epoch; NCCL asked for two ranks
    on one card raises the port's error; and ``train --shards 2
    --dist-backend gloo --epochs 2`` from item 17's store;
21. out of core on the mesh (``parallel/ooc_mesh.py``) on the same .npy
    set, at D = 1 over NCCL and D = 2 over gloo on cuda:0: ``train(ooc=
    True)`` as each rank (ALS-WR rank 64, lam 0.05, bf16 gathers, 4
    epochs: RMSE held to the reference trajectory, the resident blocked
    run and the resident main path, the gathered U and V to the blocked
    run's, trash and cold rows 0, K1 and ``fused_gram`` launched on every
    rank, peak memory a rank); on a wire the launcher builds once, 4
    pinned epochs through ``make_sharded_ooc_epoch`` (s/epoch, 445,036,800
    bytes all-reduced a rank an epoch, at D = 1 epoch 3 by kernel and the
    idle share) and a streamed pair bit-equal to them (bytes staged); at D = 2
    one iALS epoch (K1 and ``row_gather`` on every rank) against a
    resident blocked iALS epoch; and ``train --ooc --shards 2
    --dist-backend gloo --epochs 2`` from item 17's store.
22. "bench": ``python -m ycnr_tpu_torch.tools.bench --algo als --topn
    --groups both`` as a process at the ML-20M width: exactly one stdout
    line with bench.py's keys and ``vs_baseline`` null; its 8-group RMSE
    after epochs 1-4 within 1e-6 of item 6's and both runs' within 1e-3 of
    the reference; K1 and ``fused_gram`` over the epochs, K2 in the top-10
    passes, no rated item served; then ``run_bench`` in process with
    ``--layout blocked`` (4 epochs, reference within 1e-3), ``--rank 128``
    (RMSE falls, K1's tiled body), ``--algo ials``, ``--algo sgd`` batched
    and stream (RMSE falls), ``--algo bpr`` (2 epochs each);
23. "tools": in process at the ML-20M width, ``bench_ooc --compare`` with
    the wire pinned and streamed (factors and held-out RMSE bit-equal to
    the resident run, within 1e-5 of item 6's epoch 3), ``--probe``
    (host-to-device GB/s), ``--algo sgd`` on the compact wire (held-out
    RMSE falls); ``bench_bpr_batch`` at 65,536 and 262,144; ``soak`` at
    its defaults for 8 s (no error, epochs never back on a connection);
    ``loadgen`` against item 17's store and checkpoint (its server a
    process, ``--precompute``: no error); ``quality_calibrated --scale
    ml20m`` for 2 epochs (hit@10 rises for BPR and iALS); ``free -g``.

The host lane (``HostLane``, a process started with the script) makes
the host-only builds the phases read, while the card runs the earlier
phases: the main path's data (beside the kernel build and items 3-5), the
layouts of the bench cache, the out-of-core phases' wires, the mesh
ranks' sharded data and ``quality_calibrated``'s dataset.

Every path runs with the kernels' launch counts set to 0 just before it,
and each kernel must have launched on the paths that use it; K1's tiled
body launches on no rank-64 path. Every failed
check raises, so the exit code is nonzero. Stdout ends with the card's
name and power limit (``nvidia-smi``), a JSON line of per-kernel results
(time, plain time, one PyTorch call's time, bound) and, last,
``{"ok": true, "device": ...}``.
"""

from __future__ import annotations

import contextlib
import json
import os
import pickle
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

# Held-out RMSE after epochs 1-4 of bench.py's main path, from the JAX
# package's own run (BENCH_r05.json); the port is held to it to 1e-3.
ANCHOR_RMSE = (1.6774, 0.5815, 0.5383, 0.4985)
RMSE_TOL = 1e-3
# K1: max over systems of |x - x_ref|_inf / |x_ref|_inf against a float64
# solve of the same float32 systems. f32 Cholesky's forward error is about
# cond(A) * n * 6e-8; the systems below keep cond(A) within ~1e4.
K1_RTOL = 1e-3
# fused32 vs the exact scorer on the same bf16-rounded factors: the two sum
# the same exact products in different orders, so scores agree to f32
# rounding (64 terms of magnitude ~5: < 2e-5); ids may differ only there.
TIE_TOL = 5e-5
SAMPLE_USERS = 4096
# fused (bf16 score buffer): segments are chosen from exact f32 maxima,
# but candidates are ranked by bf16-rounded scores, so a pick may differ
# from the exact scorer's only where the two scores round to within one
# bf16 step (2^-7 relative) of each other.
BF16_REL = 2.0 ** -7
# bench.py's main path (BASELINE.json config 3): ML-20M shape, rank 64
MAIN = dict(n_users=138_493, n_items=26_744, n_ratings=20_000_263, rank=64,
            lam=0.05, groups=8)
# s/epoch on this path, epochs 2-4, of the earlier slices (NVIDIA H100
# 80GB HBM3, 700 W), and PR 2's held-out RMSE trajectory
PR1_S_EPOCH = 0.1175
PR2_S_EPOCH = 0.0507
PR3_S_EPOCH = 0.0230
PR2_RMSE = (1.677441, 0.581494, 0.538312, 0.498509)
PR2_RMSE_TOL = 1e-4
# The blocked path against the bucketed path, same start, f32 gathers:
# the two sum the same products in other orders.
BLOCKED_RMSE_TOL = 1e-4
IALS = dict(lam=0.1, alpha=40.0)  # IALSConfig's defaults
# fold-in rows (f32, row gather + K1) against a float64 solve of the same
# systems: f32 Cholesky's forward error is about cond(A) * n * 6e-8.
FOLD_RTOL = 1e-3
FOLD_USERS = 256
GATHER_ROWS = 65_536  # the TPU gather bench's rows per step
GATHER_ITERS = 20  # calls per CUDA graph when timing a gather
GATHER_TABLES = (26_744, 480_189)  # ML-20M items, Netflix users
# SGD and BPR on the card (f32) against the float64 oracle on the host after
# one epoch from the same start with the same draws: the factors are ~0.1
# and one epoch's updates sum a few thousand f32 terms per row.
ORACLE_ATOL = 1e-4
# the stream trainer's final held-out RMSE against the batched trainer's
# (the band the JAX package's tests/test_sgd_stream.py pins)
STREAM_BAND = 0.02
ONLINE_RTOL = 1e-3  # add_ratings rows against a float64 solve (as fold-in)
SIM_TOL = 1e-5  # similar(): f32 cosine against float64, ties at the cut
# H100 SXM peaks (NVIDIA data sheet) for bound_ms: HBM3 bytes/s, dense bf16
# tensor-core and f32 CUDA-core FLOP/s
HBM_BYTES_PER_S = 3.35e12
PEAK_BF16 = 989e12
PEAK_F32 = 67e12


_T0 = time.time()


def log(*a):
    """A line of the run's log, prefixed by the seconds since the start."""
    print(f"[{time.time() - _T0:6.1f} s]", *a, flush=True)


def check(ok: bool, what: str):
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def sync():
    torch.cuda.synchronize()


def cuda_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Mean milliseconds per call on the card (CUDA events)."""
    for _ in range(warmup):
        fn()
    sync()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    sync()
    return start.elapsed_time(end) / iters


def k1_bound_ms(n: int, B: int):
    """K1's bound for B systems of size n: read A's lower triangle and b,
    write x, against the Cholesky factorization's n^3/3 flops and the two
    triangular solves' 2 n^2 (an FMA counts two), on the f32 CUDA cores.
    A is symmetric (its callers symmetrize it: ops/gram.py, fused_gram's
    epilogue), so n (n + 1) / 2 of its floats are all that a solve must
    read; counting the whole square would put the bound above the time of
    a body that reads only the triangle."""
    return bound_ms(4 * B * (n * (n + 1) // 2 + 2 * n),
                    B * (n ** 3 / 3 + 2 * n * n), PEAK_F32)


def guarded_systems(n: int, batch: int, seed: int, dev):
    """ALS-like guarded normal equations: A = F^T F over R gathered rows
    (rows past the slot's count are zero padding) + (lam*cnt + (cnt==0)) I,
    symmetrized; b = F^T r. About 5% of the slots are padding (cnt = 0:
    A = I, b = 0); a fifth have factor rows 5x larger, which with a small
    count leaves cond(A) in the thousands."""
    rng = np.random.default_rng(seed)
    R, lam = 32, 0.05
    cnt = rng.integers(1, R + 1, batch)
    cnt[rng.random(batch) < 0.05] = 0
    scale = np.where(rng.random(batch) < 0.2, 0.5, 0.1)[:, None, None]
    F = rng.normal(0.0, 1.0, (batch, R, n)) * scale
    r = rng.normal(3.0, 1.0, (batch, R))
    live = np.arange(R)[None, :] < cnt[:, None]
    F = np.where(live[:, :, None], F, 0.0).astype(np.float32)
    r = np.where(live, r, 0.0).astype(np.float32)
    Ft = torch.as_tensor(F, device=dev)
    rt = torch.as_tensor(r, device=dev)
    c = torch.as_tensor(cnt, dtype=torch.float32, device=dev)
    A = Ft.transpose(1, 2) @ Ft
    A = A + (lam * c + (c == 0))[:, None, None] * torch.eye(n, device=dev)
    A = (0.5 * (A + A.transpose(1, 2))).contiguous()
    b = torch.einsum("brk,br->bk", Ft, rt).contiguous()
    return A, b, torch.as_tensor(cnt == 0, device=dev)


def phase_k1(dev) -> dict:
    """K1's warp body (n <= 64) at n = 10, 32 and 64 on 20,000 guarded
    systems against a float64 solve, padding rows exactly 0; timed at n =
    64 (the main path's) beside the plain version, torch.linalg.solve and
    the bound, and over CUDA graphs at B = 8 and 256."""
    from ycnr_tpu_torch.ops.spd_solve import spd_solve_cuda, \
        spd_solve_reference

    worst_rel = worst_abs = 0.0
    for n in (10, 32, 64):
        A, b, pad = guarded_systems(n, 20_000, seed=n, dev=dev)
        x = spd_solve_cuda(A, b)
        ref = spd_solve_reference(A.double(), b.double())
        plain = spd_solve_reference(A, b)
        sync()
        err = (x.double() - ref).abs()
        rel = (err.amax(1) / ref.abs().amax(1).clamp_min(1e-300))[~pad]
        prel = ((plain.double() - ref).abs().amax(1)
                / ref.abs().amax(1).clamp_min(1e-300))[~pad]
        check(bool(torch.isfinite(x).all()), f"K1 n={n}: finite")
        check(bool((x[pad] == 0).all()), f"K1 n={n}: padding rows exactly 0")
        log(f"K1 n={n} B={A.shape[0]}: max rel err {rel.max().item():.3e} "
            f"(plain f32 {prel.max().item():.3e}), max abs "
            f"{err.max().item():.3e}, padding rows exactly 0: "
            f"{int(pad.sum())}")
        check(rel.max().item() < K1_RTOL,
              f"K1 n={n}: max rel err < {K1_RTOL}")
        worst_rel = max(worst_rel, rel.max().item())
        worst_abs = max(worst_abs, err.max().item())
    n, B = 64, 20_000
    A, b, _ = guarded_systems(n, B, seed=64, dev=dev)
    out = k1_times(A, b, iters=10)
    out.update(max_abs_err=worst_abs, max_rel_err=worst_rel)
    return out


def k1_times(A, b, iters: int) -> dict:
    """K1 on A, b timed in turns with its plain version (cholesky +
    cholesky_solve) and torch.linalg.solve (plain, kernel, library,
    kernel, plain; the least of each kept), beside the bound; and over
    CUDA graphs of 20 calls on the first 8 and 256 systems (the epoch's
    longest rating lists come 8 to a call: a call is shorter than the
    host's launch)."""
    from ycnr_tpu_torch.ops.spd_solve import spd_solve_cuda, \
        spd_solve_reference
    from ycnr_tpu_torch.tools.probe_gather import graph_ms

    B, n = b.shape
    plain_ms = cuda_ms(lambda: spd_solve_reference(A, b), iters, warmup=1)
    ms = cuda_ms(lambda: spd_solve_cuda(A, b), iters, warmup=1)
    lib_ms = cuda_ms(lambda: torch.linalg.solve(A, b), iters, warmup=1)
    ms = min(ms, cuda_ms(lambda: spd_solve_cuda(A, b), iters, warmup=1))
    plain_ms = min(plain_ms, cuda_ms(lambda: spd_solve_reference(A, b),
                                     iters, warmup=1))
    bnd = k1_bound_ms(n, B)
    small = {}
    for m in (8, 256):
        As, bs = A[:m].contiguous(), b[:m].contiguous()
        small[m] = graph_ms(lambda: spd_solve_cuda(As, bs), 20)
    log(f"K1 n={n} B={B}: kernel {ms:.4f} ms, plain (torch.linalg."
        f"cholesky + cholesky_solve, f32) {plain_ms:.4f} ms, "
        f"torch.linalg.solve {lib_ms:.4f} ms, bound {bnd[0]:.4f} ms "
        f"({bnd[1]}), {100 * bnd[0] / ms:.1f}% of it; B=8 "
        f"{small[8]:.4f} ms, B=256 {small[256]:.4f} ms (device time, CUDA "
        f"graph of 20 calls)")
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
            "bound_ms": bnd[0], "bound_by": bnd[1], "b8_ms": small[8],
            "b256_ms": small[256]}


# K1's tiled body: the sizes held to float64 and to its mirror, and the
# sizes timed (every rank from 65 to 256 runs fused_gram + K1, 128 and
# 192 through train(), 256 one epoch; fold-in at 192 and 256)
K1_WIDE_NS = (65, 96, 127, 128, 129, 160, 192, 250, 256)
K1_TIMED_NS = (96, 128, 192, 256)
K1_UNTIMED_B = 4_096  # systems held to float64 at the sizes not timed
# the kernel against its plain-torch mirror (tests/k1_tiled_mirror.py) on
# well-conditioned systems: the same operations in the same order, the
# kernel's multiply-adds fused, the mirror's rounded twice
K1_MIRROR_RTOL = 1e-5


def k1_tiled_mirror():
    """tests/k1_tiled_mirror.py, loaded from its path (``tests/`` stays
    off ``sys.path``)."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                        "k1_tiled_mirror.py")
    spec = importlib.util.spec_from_file_location("k1_tiled_mirror", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def phase_k1_wide(dev) -> dict:
    """K1's tiled body (64 < n <= 256) at every n of K1_WIDE_NS, on B =
    20,000 guarded systems (K1_UNTIMED_B at the sizes not timed; padding
    systems among them): held to a float64
    solve within K1_RTOL over all systems and within f32 Cholesky's
    forward error cond(A) n 2^-24 on the first 512 (eigenvalues in
    float64), padding rows exactly 0; on 64 well-conditioned systems held
    to its plain-torch mirror within K1_MIRROR_RTOL; at K1_TIMED_NS timed
    (``k1_times``)."""
    from ycnr_tpu_torch.ops.spd_solve import spd_solve_cuda, \
        spd_solve_reference
    from ycnr_tpu_torch.tools.bench_solve_score import spd_systems

    tiled_solve_mirror = k1_tiled_mirror().tiled_solve_mirror
    gen = torch.Generator(device=dev)
    gen.manual_seed(11)
    out = {}
    for n in K1_WIDE_NS:
        B = 20_000 if n in K1_TIMED_NS else K1_UNTIMED_B
        A, b, pad = guarded_systems(n, B, seed=n, dev=dev)
        x = spd_solve_cuda(A, b)
        ref = spd_solve_reference(A.double(), b.double())
        sync()
        err = (x.double() - ref).abs()
        rel = err.amax(1) / ref.abs().amax(1).clamp_min(1e-300)
        check(bool(torch.isfinite(x).all()), f"K1 n={n}: finite")
        check(bool((x[pad] == 0).all()), f"K1 n={n}: padding rows exactly 0")
        live = ~pad[:512]
        w = torch.linalg.eigvalsh(A[:512][live].double())
        bound = w[:, -1] / w[:, 0] * n * 2.0 ** -24
        within = bool((rel[:512][live] <= bound).all())
        Aw, bw = spd_systems(64, n, gen, dev)
        Aw[:3] = torch.eye(n, device=dev)
        bw[:3] = 0
        xw = spd_solve_cuda(Aw, bw)
        xm = tiled_solve_mirror(Aw.cpu(), bw.cpu())
        mrel = ((xw.cpu() - xm).abs().amax(1)
                / xm.abs().amax(1).clamp_min(1e-30))[3:].max().item()
        log(f"K1 n={n} B={B}: max rel err {rel[~pad].max().item():.3e}, max "
            f"abs {err.max().item():.3e}; first 512: cond(A) up to "
            f"{(w[:, -1] / w[:, 0]).max().item():.3e}, every system within "
            f"cond(A) n 2^-24: {within}; padding rows exactly 0: "
            f"{int(pad.sum())}; against its mirror (64 systems) max rel "
            f"{mrel:.3e}")
        check(rel[~pad].max().item() < K1_RTOL,
              f"K1 n={n}: max rel err < {K1_RTOL}")
        check(within, f"K1 n={n}: within cond(A) n 2^-24 of float64")
        check(bool((xw[:3] == 0).all()) and mrel <= K1_MIRROR_RTOL,
              f"K1 n={n}: within {K1_MIRROR_RTOL} of its mirror, padding "
              f"exactly 0")
        max_abs = err.max().item()
        del ref, err, w
        if n in K1_TIMED_NS:
            out[n] = k1_times(A, b, iters=5)
            out[n]["max_abs_err"] = max_abs
        del A, b, x
        torch.cuda.empty_cache()
    return out


def random_rated_bits(n_users: int, n_items: int, density: float, seed: int):
    """Packed rated bits in the build_rated_bits layout for a random mask."""
    rng = np.random.default_rng(seed)
    w = 4 * (-(-(n_items + 1) // 128))
    mask = np.zeros((n_users, w * 32), bool)
    mask[:, :n_items] = rng.random((n_users, n_items)) < density
    mask[:, n_items:] = True  # trash and pad columns are always masked
    return np.packbits(mask, axis=1, bitorder="little").view("<u4")


def k2_inputs(n_users: int, n_items: int, k: int, seed: int, dev):
    """One serving block: N(0, 0.5) factors, N(0, 0.1) biases, 1% of the
    items rated, trash and pad columns masked."""
    from ycnr_tpu_torch.eval.recommend import bits_tensor

    rng = np.random.default_rng(seed)
    bits_np = random_rated_bits(n_users, n_items, 0.01, seed=seed + 1)
    m = bits_np.shape[1] * 32
    V = np.zeros((m, k), np.float32)
    V[:n_items] = rng.normal(0, 0.5, (n_items, k))
    bi = np.zeros(m, np.float32)
    bi[:n_items] = rng.normal(0, 0.1, n_items)
    rows = torch.as_tensor(rng.normal(0, 0.5, (n_users, k)), device=dev,
                           dtype=torch.float32).to(torch.bfloat16)
    return (rows, torch.as_tensor(V, device=dev).to(torch.bfloat16),
            torch.as_tensor(bi, device=dev), bits_tensor(bits_np, dev))


def k2_check(name: str, rows, V, bi, bits, n_items: int, score_bf16: bool):
    """K2 against its plain version (f32 scores) within the stated bound,
    against a float64 sum, and its exact invariants. Returns the kernel's
    outputs and its largest error against the plain version."""
    from ycnr_tpu_torch.ops.fused_topn import (NEG_INF, fused_scores_bound,
                                               fused_scores_cuda,
                                               fused_scores_reference)

    seg_k, s3_k = fused_scores_cuda(rows, V, bi, bits, score_bf16)
    seg_p, s3_p = fused_scores_reference(rows, V, bi, bits, False)
    sync()
    u_b, n_seg = seg_k.shape
    flat_k = s3_k.reshape(u_b, -1).float()
    flat_p = s3_p.reshape(u_b, -1)
    masked = flat_p == NEG_INF
    check(bool(masked[:, n_items:].all()), f"K2 {name}: pad columns masked")
    neg = torch.tensor(NEG_INF, device=rows.device).to(s3_k.dtype).float()
    exact_mask = bool((flat_k[masked] == neg).all()
                      and (flat_k[~masked] > NEG_INF / 2).all())
    bound = fused_scores_bound(rows, V, bi)
    tol = bound + 2.0 ** -7 * flat_p.abs() if score_bf16 else bound
    err = torch.where(masked, torch.zeros_like(flat_k),
                      (flat_k - flat_p).abs())
    share = (err / tol.clamp_min(1e-30)).max().item()
    seg_err = (seg_k - seg_p).abs()
    seg_ok = bool((seg_err <= bound.reshape(u_b, n_seg, -1).amax(2)).all())
    del tol, bound
    top = s3_k.amax(2)
    seg_exact = (torch.equal(seg_k.bfloat16(), top) if score_bf16
                 else torch.equal(seg_k, top))
    s64 = rows.double() @ V.double().T + bi.double()[None, :]
    err64 = torch.where(masked, torch.zeros_like(s64),
                        (flat_k.double() - s64).abs())
    b64 = fused_scores_bound(rows, V, bi, f64=True)
    if score_bf16:  # the stored scores are rounded to bf16
        b64 = b64 + 2.0 ** -8 * s64.abs()
    share64 = (err64 / b64.clamp_min(1e-300)).max().item()
    perr64 = torch.where(masked, torch.zeros_like(s64),
                         (flat_p.double() - s64).abs()).max().item()
    log(f"K2 {name}: rated and pad columns exactly NEG_INF, no other: "
        f"{exact_mask}; segmax {'.bfloat16() ' if score_bf16 else ''}== "
        f"s3.amax(2) exactly: {seg_exact}; max |s3 - plain| "
        f"{err.max().item():.3e} ({share:.3e} of the stated bound), max "
        f"|segmax - plain| {seg_err.max().item():.3e} (within the bound: "
        f"{seg_ok}); max |s3 - float64 sum| {err64.max().item():.3e} "
        f"({share64:.3e} of its bound; plain f32 version "
        f"{perr64:.3e})")
    check(exact_mask, f"K2 {name}: rated and pad columns exactly NEG_INF")
    check(seg_exact, f"K2 {name}: segmax equals the stored scores' maxima")
    check(share <= 1.0, f"K2 {name}: s3 within the bound of the plain "
          f"version")
    check(seg_ok, f"K2 {name}: segmax within the bound of the plain "
          f"version")
    check(share64 <= 1.0, f"K2 {name}: s3 within the bound of a float64 "
          f"sum")
    return seg_k, s3_k, max(err.max().item(), seg_err.max().item())


def phase_k2(dev) -> dict:
    from ycnr_tpu_torch.ops.fused_topn import (fused_scores_cuda,
                                               fused_scores_reference)

    # a ragged block first: 1,000 users (not whole tiles), rank 10 (rows
    # not whole 16-byte chunks, padded to 16 in the kernel)
    rag = k2_inputs(1000, 3000, 10, 17, dev)
    for score_bf16 in (True, False):
        k2_check(f"{'bf16' if score_bf16 else 'f32'} scores, ragged 1000 "
                 f"users x 3000 items, k=10", *rag, 3000, score_bf16)
    n_users, n_items, k = 4096, 26_744, 64
    rows, Vt, bit, bits = k2_inputs(n_users, n_items, k, 7, dev)
    m = Vt.shape[0]
    out = {}
    for score_bf16 in (True, False):
        name = "bf16" if score_bf16 else "f32"
        seg_k, s3_k, diff = k2_check(
            f"{name} scores, {n_users} users x {n_items} items, k={k}",
            rows, Vt, bit, bits, n_items, score_bf16)
        # in turns: plain, kernel, kernel, plain
        plain_ms = cuda_ms(lambda: fused_scores_reference(
            rows, Vt, bit, bits, score_bf16), iters=2, warmup=1)
        ms = cuda_ms(lambda: fused_scores_cuda(rows, Vt, bit, bits,
                                               score_bf16))
        ms = min(ms, cuda_ms(lambda: fused_scores_cuda(rows, Vt, bit, bits,
                                                       score_bf16)))
        plain_ms = min(plain_ms, cuda_ms(lambda: fused_scores_reference(
            rows, Vt, bit, bits, score_bf16), iters=2, warmup=0))
        # read rows, V, bias, bits; write segmax and s3; U.V^T in bf16
        nbytes = (2 * (n_users + m) * k + 4 * m + bits.numel() * 4
                  + seg_k.numel() * 4 + s3_k.numel() * s3_k.element_size())
        bnd = bound_ms(nbytes, 2 * n_users * m * k, PEAK_BF16)
        log(f"K2 {name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
            f"{bnd[0]:.4f} ms ({bnd[1]}), {bnd[0] / ms:.3f} of the bound; no "
            f"single PyTorch call computes masked scores with segment "
            f"maxima")
        out[name] = {"max_abs_err": diff, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": bnd[0], "bound_by": bnd[1]}
        del seg_k, s3_k
    return out


def bound_ms(nbytes: float, ops: float, peak: float):
    """The least time the card could take: the larger of the bytes over the
    memory rate and the operations over the peak rate for their type
    (H100 SXM data sheet). Returns (ms, what sets it)."""
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    to = ops / peak * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def phase_gather(dev) -> dict:
    """row_gather against table[idx] and take_along_rows against
    torch.gather (row-broadcast idx2, T3's form), bit for bit, in 16 cases;
    each timed beside its plain version and one PyTorch call, as device
    time (the calls take ~10-50 us, about what the host takes to launch
    one). The timed calls rotate over copies of the inputs so that each
    finds its table rows and indices cold, as its bound counts them."""
    from ycnr_tpu_torch.ops.row_gather import (row_gather_cuda,
                                               row_gather_reference,
                                               take_along_rows_cuda,
                                               take_along_rows_reference)
    from ycnr_tpu_torch.tools.probe_gather import cold_sets, graph_ms

    rng = np.random.default_rng(11)
    out = {}
    for n in GATHER_TABLES:
        for w in (64, 128):
            base = rng.standard_normal((n, w), dtype=np.float32)
            for dt in (torch.bfloat16, torch.float32):
                table = torch.as_tensor(base, device=dev).to(dt)
                for it in (torch.int32, torch.int64):
                    idx = torch.as_tensor(
                        rng.integers(0, n, GATHER_ROWS), device=dev).to(it)
                    got = row_gather_cuda(table, idx)
                    want = row_gather_reference(table, idx)
                    idx2 = idx[:, None].expand(GATHER_ROWS, w).contiguous()
                    idx2l = idx2.long()
                    got2 = take_along_rows_cuda(table, idx2)
                    want2 = take_along_rows_reference(table, idx2)
                    sync()
                    name = (f"n={n} w={w} {str(dt)[6:]} "
                            f"{str(it)[6:]}")
                    check(torch.equal(got, want),
                          f"row_gather {name}: bit-equal to table[idx]")
                    check(torch.equal(got2, want2),
                          f"take_along_rows {name}: bit-equal to "
                          f"torch.gather")
                    eb, ib = table.element_size(), idx.element_size()
                    rows_read = int(torch.unique(idx).numel())
                    row_bytes = (GATHER_ROWS * (ib + w * eb)
                                 + rows_read * w * eb)
                    take_bytes = (GATHER_ROWS * w * (ib + eb)
                                  + rows_read * w * eb)
                    rb = bound_ms(row_bytes, 0, PEAK_F32)
                    tb = bound_ms(take_bytes, 0, PEAK_F32)
                    # device time per call over CUDA graphs whose calls
                    # rotate over copies of the inputs (cold L2), in turns:
                    # plain, kernel, library, kernel
                    sets = cold_sets((table, idx, idx2, idx2l),
                                     min(row_bytes, take_bytes), GATHER_ITERS)

                    def cold_ms(fn):
                        return graph_ms(fn, GATHER_ITERS, sets=sets)

                    plain_ms = cold_ms(
                        lambda T, i, i2, i2l: row_gather_reference(T, i))
                    ms = cold_ms(lambda T, i, i2, i2l: row_gather_cuda(T, i))
                    lib_ms = cold_ms(lambda T, i, i2, i2l: T[i])
                    ms = min(ms, cold_ms(
                        lambda T, i, i2, i2l: row_gather_cuda(T, i)))
                    tplain = cold_ms(lambda T, i, i2, i2l:
                                     take_along_rows_reference(T, i2))
                    tms = cold_ms(
                        lambda T, i, i2, i2l: take_along_rows_cuda(T, i2))
                    tlib = cold_ms(
                        lambda T, i, i2, i2l: torch.gather(T, 0, i2l))
                    tms = min(tms, cold_ms(
                        lambda T, i, i2, i2l: take_along_rows_cuda(T, i2)))
                    del sets
                    log(f"gather {name} m={GATHER_ROWS} (cold L2): "
                        f"bit-equal; "
                        f"row_gather kernel {ms:.4f} ms, plain {plain_ms:.4f}"
                        f" ms, table[idx] {lib_ms:.4f} ms, bound "
                        f"{rb[0]:.4f} ms; take_along_rows kernel {tms:.4f} "
                        f"ms, plain {tplain:.4f} ms, torch.gather (int64) "
                        f"{tlib:.4f} ms, bound {tb[0]:.4f} ms")
                    out[(n, w, str(dt)[6:], str(it)[6:])] = dict(
                        row=dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                                 bound_ms=rb[0], bound_by=rb[1]),
                        take=dict(ms=tms, plain_ms=tplain, library_ms=tlib,
                                  bound_ms=tb[0], bound_by=tb[1]))
    ratio = {k: v["take"]["ms"] / v["take"]["library_ms"]
             for k, v in out.items()}
    worst = max(ratio, key=ratio.get)
    log(f"take_along_rows vs torch.gather: slower in "
        f"{sum(r > 1 for r in ratio.values())} of {len(ratio)} cases; "
        f"kernel / torch.gather from {min(ratio.values()):.3f} to "
        f"{ratio[worst]:.3f} (at {worst})")
    # the blocked path's shape (f32 rank-64 rows of the items table) and
    # T3's probe form (bf16, int64 row-broadcast indices)
    return {"row_gather": dict(out[(GATHER_TABLES[0], 64, "float32",
                                    "int32")]["row"], max_abs_err=0.0),
            "take_along_rows": dict(out[(GATHER_TABLES[0], 64, "bfloat16",
                                         "int64")]["take"], max_abs_err=0.0)}


def phase_fused_gram(state, dul, dil) -> dict:
    """fused_gram with the main path's ridge against its plain version on
    the main path's own blocks (the start factors in bf16): the smallest-R
    and largest-R groups of both layouts, within the stated bound, A
    bit-symmetric, padding entities exactly A = I, b = 0, and within
    F64_REL of a float64 sum of the same products. Then one user phase's
    normal equations timed both ways."""
    from ycnr_tpu_torch.ops.fused_gram import (F64_REL, fused_gram_bound,
                                               fused_gram_cuda,
                                               fused_gram_f64_error,
                                               fused_gram_reference)

    lam = MAIN["lam"]
    worst = 0.0
    for side, lay, F in (("user", dul, state.V), ("item", dil, state.U)):
        table = F.to(torch.bfloat16)
        n_ent = (state.U if side == "user" else state.V).shape[0] - 1
        for which, g in (("smallest", lay[0]), ("largest", lay[-1])):
            # a group's last block holds its padding entities
            oi, rat, eid = g.other_idx[-1], g.rating[-1], g.entity_ids[-1]
            cnt = g.entity_cnt[-1]
            reg = lam * cnt + (cnt == 0)
            A, b = fused_gram_cuda(table, oi, rat, reg)
            Ap, bp = fused_gram_reference(table, oi, rat, reg)
            bA, bb = fused_gram_bound(table[oi].float(), rat, reg)
            rel = fused_gram_f64_error(table, oi, rat, reg, A, b)
            rel_plain = fused_gram_f64_error(table, oi, rat, reg, Ap, bp)
            sync()
            errA = (A - Ap).abs()
            errb = (b - bp).abs()
            pad = eid == n_ent
            eye = torch.eye(A.shape[-1], device=A.device)
            name = (f"{side} layout, {which} R={oi.shape[1]}, "
                    f"NE={oi.shape[0]}")
            log(f"fused_gram (ridge) {name}: max |A - plain| "
                f"{errA.max().item():.3e}, max |b - plain| "
                f"{errb.max().item():.3e}, largest share of the bound "
                f"{(errA / bA.clamp_min(1e-30)).max().item():.3e}, within "
                f"the bound: {bool((errA <= bA).all() and (errb <= bb).all())}"
                f", A bit-symmetric: {torch.equal(A, A.transpose(1, 2))}, "
                f"padding entities exactly A = I, b = 0: {int(pad.sum())}; "
                f"against float64, relative to |F|^T|F| (+ reg I): A "
                f"{rel[0]:.3e}, b {rel[1]:.3e} (plain f32: A "
                f"{rel_plain[0]:.3e}, b {rel_plain[1]:.3e}; limit {F64_REL:.3e})")
            check(bool((errA <= bA).all()), f"fused_gram {name}: A in bound")
            check(max(rel) <= F64_REL,
                  f"fused_gram {name}: within {F64_REL:.3e} of float64")
            check(bool((errb <= bb).all()), f"fused_gram {name}: b in bound")
            check(torch.equal(A, A.transpose(1, 2)),
                  f"fused_gram {name}: A bit-symmetric")
            check(bool(pad.any()), f"fused_gram {name}: has padding")
            check(bool((A[pad] == eye).all() and (b[pad] == 0).all()),
                  f"fused_gram {name}: padding entities exactly A = I, b = 0")
            worst = max(worst, errA.max().item(), errb.max().item())
    table = state.V.to(torch.bfloat16)
    blocks = [(oi, rr, lam * c + (c == 0)) for g in dul
              for oi, rr, c in zip(g.other_idx, g.rating, g.entity_cnt)]
    plain_ms = cuda_ms(lambda: [fused_gram_reference(table, oi, r, reg)
                                for oi, r, reg in blocks], iters=3, warmup=1)
    ms = cuda_ms(lambda: [fused_gram_cuda(table, oi, r, reg)
                          for oi, r, reg in blocks], iters=3, warmup=1)
    ms = min(ms, cuda_ms(lambda: [fused_gram_cuda(table, oi, r, reg)
                                  for oi, r, reg in blocks], iters=3,
                         warmup=0))
    w = table.shape[1]
    slots = sum(oi.numel() for oi, _, _ in blocks)
    ents = sum(oi.shape[0] for oi, _, _ in blocks)
    # read idx, ratings, reg and the table (once per call); write A and b;
    # the lower half of F^T F and b in bf16 on the tensor cores
    nbytes = (slots * (blocks[0][0].element_size() + 2)
              + ents * 4 * (1 + w * w + w) + len(blocks) * table.numel() * 2)
    bnd = bound_ms(nbytes, slots * (w * (w + 1) + 2 * w), PEAK_BF16)
    log(f"fused_gram (ridge), one user phase's normal equations "
        f"({len(blocks)} blocks, {slots:,} slots, {ents:,} entities): "
        f"kernel {ms:.3f} ms, plain gather -> f32 einsum -> ridge -> "
        f"symmetrize {plain_ms:.3f} ms, bound {bnd[0]:.3f} ms ({bnd[1]}), "
        f"{bnd[0] / ms:.3f} of the bound; no single PyTorch call computes "
        f"a gathered Gram")
    return {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bnd[0], "bound_by": bnd[1]}


# fused_gram on one user phase's blocks at these widths: the 4-warp body's
# widest (for reference) and the wide body's, one of them w % 8 != 0 (its
# plain loads)
GRAM_WIDTHS = (128, 192, 256, 250)
# the wide body this one replaced (8 warps on mma.sync) on the same phase
# and lists, the log's "was": ms a phase, long lists' ns a slot, short
# lists' share of their byte bound (NVIDIA H100 80GB HBM3, 700 W)
MMA_SYNC_GRAM = {192: dict(ms=32.874, long_ns=0.704, short_share=0.641),
             256: dict(ms=47.576, long_ns=0.934, short_share=0.776),
             250: dict(ms=128.036)}
GRAM_CHECK_ENTITIES = 2048  # entities a check's float64 sums take at once


def phase_fused_gram_widths(dul, n_items: int, smi: str) -> dict:
    """fused_gram with the main path's ridge on one user phase's blocks
    (the main path's layout: 42 blocks, its padding entities included) on
    a bf16 table of the item factor's shape, [n_items + 1, w] with the
    zero trash row last, at every width of GRAM_WIDTHS: each block within
    fused_gram_bound of the plain version and within F64_REL of a float64
    sum, A bit-symmetric, padding entities exactly A = reg I, b = 0, a
    second run bit-equal; then the phase timed (CUDA events) beside the
    plain version and the bound (the bytes of A)."""
    from ycnr_tpu_torch.ops.fused_gram import (F64_REL, NARROW_W,
                                               fused_gram_bound,
                                               fused_gram_cuda,
                                               fused_gram_f64_error,
                                               fused_gram_reference)

    lam = MAIN["lam"]
    dev = dul[0].other_idx.device
    blocks = [(oi, rr, lam * c + (c == 0), eid) for g in dul
              for oi, rr, c, eid in zip(g.other_idx, g.rating, g.entity_cnt,
                                        g.entity_ids)]
    n_users = MAIN["n_users"]
    out = {}
    for w in GRAM_WIDTHS:
        gen = torch.Generator(device=dev)
        gen.manual_seed(w)
        table = (0.1 * torch.randn(n_items + 1, w, generator=gen,
                                   device=dev)).bfloat16()
        table[-1] = 0
        worst_abs = worst_share = worst_rel = worst_plain = 0.0
        n_pad = 0
        for oi, rr, reg, eid in blocks:
            A, b = fused_gram_cuda(table, oi, rr, reg)
            A2, b2 = fused_gram_cuda(table, oi, rr, reg)
            sync()
            check(torch.equal(A, A2) and torch.equal(b, b2),
                  f"fused_gram w={w}: a second run bit-equal")
            del A2, b2
            check(torch.equal(A, A.transpose(1, 2)),
                  f"fused_gram w={w}: A bit-symmetric")
            pad = eid == n_users
            n_pad += int(pad.sum())
            check(bool((A[pad] == reg[pad][:, None, None]
                        * torch.eye(w, device=dev)).all()
                       and (b[pad] == 0).all()),
                  f"fused_gram w={w}: padding entities exactly A = reg I, "
                  f"b = 0")
            for c0 in range(0, oi.shape[0], GRAM_CHECK_ENTITIES):
                c = slice(c0, c0 + GRAM_CHECK_ENTITIES)
                Ap, bp = fused_gram_reference(table, oi[c], rr[c], reg[c])
                bA, bb = fused_gram_bound(table[oi[c]].float(), rr[c],
                                          reg[c])
                errA, errb = (A[c] - Ap).abs(), (b[c] - bp).abs()
                check(bool((errA <= bA).all() and (errb <= bb).all()),
                      f"fused_gram w={w}: within its bound of the plain "
                      f"version")
                rel = fused_gram_f64_error(table, oi[c], rr[c], reg[c],
                                           A[c], b[c])
                rel_p = fused_gram_f64_error(table, oi[c], rr[c], reg[c],
                                             Ap, bp)
                worst_abs = max(worst_abs, errA.max().item(),
                                errb.max().item())
                worst_share = max(worst_share, (errA / bA.clamp_min(
                    1e-30)).max().item())
                worst_rel = max(worst_rel, *rel)
                worst_plain = max(worst_plain, *rel_p)
                del Ap, bp, bA, bb, errA, errb
            del A, b
        check(n_pad > 0, f"fused_gram w={w}: the blocks hold padding")
        check(worst_rel <= F64_REL,
              f"fused_gram w={w}: within {F64_REL:.3e} of float64")
        torch.cuda.empty_cache()

        def phase(fn):
            for oi, rr, reg, _ in blocks:
                fn(table, oi, rr, reg)

        plain_ms = cuda_ms(lambda: phase(fused_gram_reference), iters=2,
                           warmup=1)
        ms = cuda_ms(lambda: phase(fused_gram_cuda), iters=3, warmup=1)
        ms = min(ms, cuda_ms(lambda: phase(fused_gram_cuda), iters=3,
                             warmup=0))
        slots = sum(oi.numel() for oi, _, _, _ in blocks)
        ents = sum(oi.shape[0] for oi, _, _, _ in blocks)
        nbytes = (slots * (blocks[0][0].element_size() + 2)
                  + ents * 4 * (1 + w * w + w)
                  + len(blocks) * table.numel() * 2)
        bnd = bound_ms(nbytes, slots * (w * (w + 1) + 2 * w), PEAK_BF16)
        body = "4-warp" if w <= NARROW_W else "wide"
        was = (f" (was {MMA_SYNC_GRAM[w]['ms']:.3f} ms on mma.sync, "
               f"{bnd[0] / MMA_SYNC_GRAM[w]['ms']:.3f} of the bound)"
               if w in MMA_SYNC_GRAM else "")
        log(f"fused_gram (ridge) w={w} ({body} body), one user phase "
            f"({len(blocks)} blocks, {slots:,} slots, {ents:,} entities, "
            f"{n_pad:,} padding): within its bound of the plain version "
            f"(largest share {worst_share:.3e}, max abs {worst_abs:.3e}), "
            f"against float64 {worst_rel:.3e} (plain f32 {worst_plain:.3e};"
            f" limit {F64_REL:.3e}), bit-symmetric, padding exact, a second"
            f" run bit-equal; kernel {ms:.3f} ms{was}, plain "
            f"{plain_ms:.3f} ms, bound {bnd[0]:.3f} ms ({bnd[1]}), "
            f"{bnd[0] / ms:.3f} of it; on {smi}")
        out[w] = {"max_abs_err": worst_abs, "ms": ms, "plain_ms": plain_ms,
                  "bound_ms": bnd[0], "bound_by": bnd[1]}
        if w % 64 == 0:
            out[w].update(gram_split(table, gen, smi))
        del table
        torch.cuda.empty_cache()
    return out


def gram_split(table, gen, smi: str) -> dict:
    """Where fused_gram's time goes at the table's width: long lists whose
    A is negligible (264 entities x 16,384 slots: the loop, ns a slot) and
    short lists whose A is most of the bytes (25,000 x 16: the share of
    the byte bound), random rows, no ridge."""
    from ycnr_tpu_torch.ops.fused_gram import fused_gram_cuda

    n, w = table.shape
    dev = table.device
    res = {}
    for name, ne, R in (("long", 264, 16_384), ("short", 25_000, 16)):
        idx = torch.randint(0, n - 1, (ne, R), generator=gen, device=dev)
        rat = (1 + 4 * torch.rand(ne, R, generator=gen, device=dev)
               ).bfloat16()
        ms = cuda_ms(lambda: fused_gram_cuda(table, idx, rat), iters=3,
                     warmup=1)
        bnd = bound_ms(ne * R * 10 + ne * 4 * (w * w + w) + n * w * 2,
                       ne * R * (w * (w + 1) + 2 * w), PEAK_BF16)
        res[name] = {"ms": ms, "ns_slot": ms * 1e6 / (ne * R),
                     "bound_ms": bnd[0], "bound_by": bnd[1]}
        del idx, rat
    lg, sh = res["long"], res["short"]
    old = MMA_SYNC_GRAM.get(w)
    was = (f" (was {old['long_ns']} ns a slot and {old['short_share']} of "
           f"the short lists' bound on mma.sync)" if old else "")
    log(f"fused_gram w={w}, where the time goes: long lists (264 x 16,384) "
        f"{lg['ms']:.3f} ms = {lg['ns_slot']:.3f} ns a slot, bound "
        f"{lg['bound_ms']:.3f} ms ({lg['bound_by']}), "
        f"{lg['bound_ms'] / lg['ms']:.3f} of it; short lists (25,000 x 16) "
        f"{sh['ms']:.3f} ms, bound {sh['bound_ms']:.3f} ms "
        f"({sh['bound_by']}), {sh['bound_ms'] / sh['ms']:.3f} of it{was}; "
        f"on {smi}")
    return {"split": res}


def phase_ingest():
    """The native parser, built here, against the Python parser on an
    ML-20M-format file with a header (host code; no kernel)."""
    from ycnr_tpu_torch.data import movielens, native
    from ycnr_tpu_torch.native import get_ingest_lib
    from ycnr_tpu_torch.tools.bench_ingest import generate

    t0 = time.time()
    check(get_ingest_lib() is not None, "the native parser built")
    log(f"build: native parser compiled and loaded in "
        f"{time.time() - t0:.1f} s")
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "ratings.csv")
        generate(path, 200_000)
        t0 = time.time()
        got = native.parse_ratings_native(path, ",", want_ts=True)
        t_native = time.time() - t0
        t0 = time.time()
        want = movielens._parse_python(path, ",", want_ts=True)
        t_python = time.time() - t0
        loaded = movielens.load_movielens(path)
    check(got is not None and all(np.array_equal(g, w)
                                  for g, w in zip(got, want)),
          "native parser equals the Python parser")
    check(len(loaded[0]) == 200_000, "load_movielens read every row")
    log(f"ingest: 200,000 rows, native parser {t_native:.3f} s, Python "
        f"parser {t_python:.3f} s, equal arrays")


def reset_launches():
    from ycnr_tpu_torch.ops import fused_gram, fused_topn, gram, row_gather, \
        spd_solve

    for mod in (spd_solve, fused_topn, row_gather, fused_gram):
        mod.launches = 0
    spd_solve.body_launches.update(dict.fromkeys(spd_solve.body_launches, 0))
    row_gather.take_launches = 0
    gram.guarded_solves = 0


def read_launches() -> dict:
    from ycnr_tpu_torch.ops import fused_gram, fused_topn, gram, row_gather, \
        spd_solve

    return {"spd_solve": spd_solve.launches,
            # K1's tiled body (64 < n <= 256), counted apart for its rows
            "spd_solve tiled": spd_solve.body_launches["tiled"],
            "fused_scores": fused_topn.launches,
            "row_gather": row_gather.launches,
            "take_along_rows": row_gather.take_launches,
            "fused_gram": fused_gram.launches,
            "guarded_batched_solve (calls)": gram.guarded_solves}


def profile_breakdown(fn, what: str, by_kernel=None):
    """Run fn under torch.profiler and print the device time by kernel
    (kernel events only, so nothing is counted twice). Returns fn's result
    and the device milliseconds; fills ``by_kernel`` (name -> ms) when
    given one."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    sync()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out = fn()
        sync()

    def dev_us(e):
        for a in ("self_device_time_total", "self_cuda_time_total"):
            v = getattr(e, a, None)
            if v:
                return v
        return 0

    rows = sorted(((dev_us(e), e.count, e.key) for e in prof.key_averages()
                   if getattr(e, "device_type", None) == DeviceType.CUDA
                   and dev_us(e) > 0), reverse=True)
    total = sum(r[0] for r in rows) / 1e3
    if by_kernel is not None:
        for us, _, key in rows:
            by_kernel[key] = by_kernel.get(key, 0.0) + us / 1e3
    log(f"profile of {what}: {total:.3f} ms of device time by kernel")
    for us, count, key in rows[:12]:
        log(f"  {us / 1e3:9.3f} ms  {100 * us / 1e3 / total:5.1f}%  "
            f"{count:5d}x  {key[:90]}")
    return out, total


def ids_equal_up_to_ties(ids_a, vals_a, ids_b, vals_b, tol: float) -> bool:
    """Per row: the two top-n value lists agree within tol, and every id
    that only one side returned scores within tol of the row's n-th value
    (an equal-score tie at the cut, up to f32 summation order)."""
    if not np.allclose(vals_a, vals_b, rtol=0, atol=tol):
        return False
    for ia, ib, va, vb in zip(ids_a, ids_b, vals_a, vals_b):
        score = dict(zip(ia.tolist(), va.tolist()))
        score.update(zip(ib.tolist(), vb.tolist()))
        for x in set(ia.tolist()) ^ set(ib.tolist()):
            if abs(score[x] - va[-1]) > tol:
                return False
    return True


def phase_blocked(dev, user_lay, item_lay, ul, il, test_coo) -> dict:
    """ALSWR (2 epochs) and ImplicitALS (1 epoch) on the blocked layouts
    against the bucketed path (host layouts ul, il) with f32 gathers, from
    init_state(seed=0)."""
    from ycnr_tpu_torch.models import ALSWR, ImplicitALS
    from ycnr_tpu_torch.models.base import (device_layout, init_state,
                                            rmse_padded)
    from ycnr_tpu_torch.models.bucketed_phase import (als_epoch_fn,
                                                      device_bucketed,
                                                      ials_epoch_fn)
    from ycnr_tpu_torch.ops.row_gather import row_gather_cuda

    n_users, n_items, rank, lam = (MAIN[k] for k in ("n_users", "n_items",
                                                     "rank", "lam"))
    log(f"blocked layouts: user blocks {user_lay.other_idx.shape}, item "
        f"blocks {item_lay.other_idx.shape}")
    dlu = device_layout(user_lay, torch.float32, dev)
    dli = device_layout(item_lay, torch.float32, dev)

    # Both sides of the RMSE comparison below run row_gather, so every
    # block's gather is first held to plain indexing, at the shapes and
    # index dtype this path gives the kernel, from the start factors.
    st = init_state(n_users, n_items, rank, seed=0, device=dev)
    for side, lay, F in (("user", dlu, st.V), ("item", dli, st.U)):
        for j, oi in enumerate(lay.other_idx):
            got = row_gather_cuda(F, oi)
            check(torch.equal(got, F[oi]), f"row_gather, blocked {side} "
                  f"layout block {j}: bit-equal to F[idx]")
        oi = lay.other_idx[0]
        ms = cuda_ms(lambda: row_gather_cuda(F, oi))
        plain_ms = cuda_ms(lambda: F[oi])
        log(f"row_gather, blocked {side} layout: {lay.other_idx.shape[0]} "
            f"blocks of {tuple(oi.shape)} {str(oi.dtype)[6:]} indices into "
            f"the [{F.shape[0]}, {F.shape[1]}] f32 table bit-equal to "
            f"F[idx]; one block: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
    del st, got

    def run(epoch_fn, n_epochs):
        st = init_state(n_users, n_items, rank, seed=0, device=dev)
        out = []
        for _ in range(n_epochs):
            t0 = time.time()
            st = epoch_fn(st)
            sync()
            out.append((float(rmse_padded(st, *test_coo)),
                        time.time() - t0))
        return out

    sync()
    reset_launches()
    als = ALSWR(lam)
    ials = ImplicitALS(**IALS)
    b_als = run(lambda st: als.epoch(st, dlu, dli), 2)
    b_ials = run(lambda st: ials.epoch(st, dlu, dli), 1)
    launches = read_launches()
    log(f"blocked path kernel launches: {launches}")
    check(launches["row_gather"] > 0, "row_gather launched on the blocked "
          "path")
    check(launches["spd_solve"] > 0, "K1 launched on the blocked path")
    dul = device_bucketed(ul, torch.float32, dev)
    dil = device_bucketed(il, torch.float32, dev)
    k_als = run(als_epoch_fn(dul, dil, lam, gather_bf16=False), 2)
    k_ials = run(ials_epoch_fn(dul, dil, IALS["lam"], IALS["alpha"],
                               gather_bf16=False), 1)
    for name, blocked, bucketed in (("ALSWR", b_als, k_als),
                                    ("ImplicitALS", b_ials, k_ials)):
        for ep, ((rb, tb), (rk, tk)) in enumerate(zip(blocked, bucketed)):
            log(f"{name} epoch {ep + 1}: held-out rmse blocked {rb:.6f} "
                f"({tb:.3f} s), bucketed f32 gathers {rk:.6f} ({tk:.3f} s), "
                f"|diff| {abs(rb - rk):.2e}")
            check(abs(rb - rk) <= BLOCKED_RMSE_TOL,
                  f"{name} epoch {ep + 1}: blocked rmse within "
                  f"{BLOCKED_RMSE_TOL} of the bucketed path's")
    return launches


def phase_fold_in(state, tu, ti, tr) -> dict:
    """Fold in 256 sampled users from their training lists: rows within
    FOLD_RTOL of a float64 solve on the card; no rated item served."""
    from ycnr_tpu_torch.serve.fold_in import (_pad_lists, fold_in_users,
                                              recommend_fold_in)

    rng = np.random.default_rng(5)
    users = np.sort(rng.choice(np.unique(tu), FOLD_USERS, replace=False))
    order = np.argsort(tu, kind="stable")
    tus, tis, trs = tu[order], ti[order], tr[order]
    lo = np.searchsorted(tus, users)
    hi = np.searchsorted(tus, users, "right")
    items = [tis[a:b] for a, b in zip(lo, hi)]
    ratings = [trs[a:b] for a, b in zip(lo, hi)]
    lam = MAIN["lam"]

    sync()
    reset_launches()
    rows = fold_in_users(state, items, ratings, lam=lam)
    top_i, _ = recommend_fold_in(state, items, ratings, n=10, lam=lam)
    sync()
    launches = read_launches()
    log(f"fold-in kernel launches: {launches}")
    check(launches["row_gather"] > 0, "row_gather launched on fold-in")
    check(launches["spd_solve"] > 0, "K1 launched on fold-in")

    idx, r = _pad_lists(items, ratings, state.n_items, np.float64)
    V = state.V.double()
    it = torch.as_tensor(idx, device=V.device).long()
    rt = torch.as_tensor(r, device=V.device)
    Vr = V[it]
    n_r = (it < state.n_items).sum(1).double()
    eye = torch.eye(V.shape[1], dtype=torch.float64, device=V.device)
    A = (torch.einsum("mlk,mle->mke", Vr, Vr)
         + (lam * n_r + (n_r == 0))[:, None, None] * eye)
    ref = torch.linalg.solve(A, torch.einsum("mlk,ml->mk", Vr, rt))
    ref = ref.cpu().numpy()
    rel = (np.abs(rows - ref).max(1)
           / np.maximum(np.abs(ref).max(1), 1e-300))
    served_rated = sum(len(set(t.tolist()) & set(i.tolist()))
                       for t, i in zip(top_i, items))
    log(f"fold-in of {FOLD_USERS} users (lists of {min(map(len, items))}"
        f"-{max(map(len, items))} ratings): max rel err vs float64 "
        f"{rel.max():.3e}; rated items served: {served_rated}")
    check(rel.max() <= FOLD_RTOL, f"fold-in rows within {FOLD_RTOL} of "
          f"float64")
    check(served_rated == 0, "fold-in serves no rated item")
    check(top_i.shape == (FOLD_USERS, 10), "fold-in top-10 shape")
    return launches


# held-out RMSE of a wide train() against the same run with the plain
# solve in float64: K1's f32 rounding is all that differs. Between what
# K1 reads (4.2e-7 at rank 128, 1.2e-7 at 192) and what the control with
# A and b rounded to TF32 reads (tf32_solve: 1.0e-5 / 7.8e-6; PERF.md
# section 2)
WIDE_F64_RMSE_TOL = 2e-6
# ... and the factors after those epochs against the float64 run's, the
# largest |U - U64| over the largest |U64| (and V's). Held-out RMSE alone
# does not always tell the TF32 control from the float64 run: the same
# rounding moved it by 1.6e-6 to 1.0e-5 at rank 128 and by 3.6e-7 to
# 7.7e-6 at rank 192, by route (fused_gram or the einsum), while the
# factors read 2.3e-3 to 4.0e-3 for K1 and 2.5e-2 to 4.4e-2 for the
# control in all four (NVIDIA H100 80GB HBM3, 700 W). The control must
# fail the two together.
WIDE_F64_FACTOR_TOL = 1e-2
# rank 192 through fused_gram's wide body against the same run from the
# same start with the route patched back to row gather -> einsum -> K1:
# the same exact bf16 products, summed in another order
ROUTE_RMSE_TOL = 1e-4
# the rank-192 epoch on the einsum route, before fused_gram took w 192
# (NVIDIA H100 80GB HBM3, 700.00 W): device ms by the profiler, s/epoch
EINSUM_RANK192_DEV_MS = 353.58
EINSUM_RANK192_S_EPOCH = (0.3584, 0.3753)
# the same epoch with the mma.sync wide body, device ms by kernel and
# s/epoch (NVIDIA H100 80GB HBM3, 700 W)
MMA_SYNC_RANK192 = dict(dev_ms=114.58, fused_gram_ms=67.85, k1_ms=40.65,
                    s_epoch=(0.1162, 0.1184))


def float64_solve(A, b):
    """K1's plain version in float64, returned in A's dtype: the solve of
    the comparison runs."""
    from ycnr_tpu_torch.ops.spd_solve import spd_solve_reference

    return spd_solve_reference(A.double(), b.double()).to(A.dtype)


def to_tf32(t):
    """f32 rounded to TF32's 10-bit mantissa (to nearest, ties away)."""
    i = t.contiguous().view(torch.int32)
    return ((i + 0x1000) & ~0x1FFF).view(torch.float32)


def tf32_solve(A, b):
    """The control: ``float64_solve`` of A and b rounded to TF32, the
    inputs a TF32 tensor-core solve would multiply. WIDE_F64_RMSE_TOL must
    tell its run from the float64 run."""
    return float64_solve(to_tf32(A.float()), to_tf32(b.float())).to(A.dtype)


@contextlib.contextmanager
def patched_solve(solve):
    """While open, the bucketed phase's two solve calls (the fused
    branch's ``bucketed_phase.spd_solve`` and ``gram.guarded_batched_
    solve``'s ``gram.spd_solve``) go to ``solve``: the same epochs with
    another solve, and no K1."""
    from unittest import mock

    from ycnr_tpu_torch.models import bucketed_phase
    from ycnr_tpu_torch.ops import gram

    with mock.patch.object(bucketed_phase, "spd_solve", solve), \
            mock.patch.object(gram, "spd_solve", solve):
        yield


@contextlib.contextmanager
def patched_route():
    """While open, ``uses_fused`` answers False where train() and the
    bucketed phase ask it: bf16 ALS-WR takes row gather -> einsum -> K1
    (``guarded_batched_solve``) at every width, with f32 ratings in its
    layouts, as the JAX package's route does."""
    from unittest import mock

    from ycnr_tpu_torch.models import bucketed_phase
    from ycnr_tpu_torch.train import loop

    def never(*a, **kw):
        return False

    with mock.patch.object(bucketed_phase, "uses_fused", never), \
            mock.patch.object(loop, "uses_fused", never):
        yield


def wide_train(dev, rank: int, tu, ti, tr, su, si, sr, tmp: str,
               smi: str, wide_checks: bool = False) -> dict:
    """ALS-WR at ``rank`` with bf16 gathers through train() on the
    ML-20M-shaped set, 2 epochs (lam 0.05, 8 groups), then the same run
    from the same start with ``float64_solve`` patched in: held-out RMSE
    within WIDE_F64_RMSE_TOL at each epoch, RMSE falling, trash and cold
    rows 0, and the factors within WIDE_F64_FACTOR_TOL; the control run
    with ``tf32_solve`` must differ from the float64 run by more than
    WIDE_F64_RMSE_TOL in RMSE or WIDE_F64_FACTOR_TOL in the factors. With
    ``wide_checks`` (the
    rank above fused_gram's 4-warp body) also the same run with the route
    patched back to row gather -> einsum -> K1 (``patched_route``), within
    ROUTE_RMSE_TOL at each epoch, and train(ooc=True) with the wire
    pinned, bit-equal in RMSE and factors. Then one more epoch on train()'s
    own layouts profiled by kernel; the layouts are returned ("lays")."""
    from ycnr_tpu_torch.config import ALSConfig, DataConfig, RunConfig
    from ycnr_tpu_torch.data.dataset import Dataset
    from ycnr_tpu_torch.models.bucketed_phase import (als_epoch_fn,
                                                      device_bucketed,
                                                      uses_fused)
    from ycnr_tpu_torch.train.loop import train

    n_users, n_items = MAIN["n_users"], MAIN["n_items"]
    what = f"rank {rank}"
    cfg = RunConfig(name=f"rank{rank}", algorithm="als",
                    data=DataConfig(chunk_len=32, max_groups=MAIN["groups"]),
                    als=ALSConfig(rank=rank, lam=MAIN["lam"], epochs=2,
                                  gather_dtype="bfloat16"),
                    out_dir="", checkpoint_every=0)
    ds = Dataset(n_users=n_users, n_items=n_items, train_u=tu, train_i=ti,
                 train_r=tr, test_u=su, test_i=si, test_r=sr,
                 mu=float(tr.mean()), chunk_len=32, rank_hint=rank)
    run_dir = os.path.join(tmp, f"rank{rank}")
    sync()
    reset_launches()
    t0 = time.time()
    with shared_bucketed_layouts({}) as built:
        res = train(cfg, dataset=ds, out_dir=run_dir, device=dev)
        sync()
        wall = time.time() - t0
        launches = read_launches()
        t0 = time.time()
        with patched_solve(float64_solve):
            ref = train(cfg, dataset=ds, device=dev)
        sync()
        wall64 = time.time() - t0
        with patched_solve(tf32_solve):
            ctl = train(cfg, dataset=ds, device=dev)
        if wide_checks:
            with patched_route():
                reset_launches()
                t0 = time.time()
                alt = train(cfg, dataset=ds, device=dev)
                sync()
                alt_wall = time.time() - t0
                alt_launches = read_launches()
                # the control's reading on this route too (logged)
                with patched_solve(float64_solve):
                    alt_ref = train(cfg, dataset=ds, device=dev)
                with patched_solve(tf32_solve):
                    alt_ctl = train(cfg, dataset=ds, device=dev)
            reset_launches()
            t0 = time.time()
            ooc_res = train(cfg.replace(ooc=True, ooc_residency="device"),
                            dataset=ds, device=dev)
            sync()
            ooc_wall = time.time() - t0
            ooc_launches = read_launches()
    s_epoch = [e["epoch_s"] for e in read_events(run_dir)
               if "rmse_test" in e]
    diff = [abs(a - b) for a, b in zip(res.rmse_history, ref.rmse_history)]
    diff_ctl = [abs(a - b) for a, b in zip(ctl.rmse_history,
                                           ref.rmse_history)]

    def fac(st, f64=None):  # the factors against the float64 run's
        f64 = f64 or ref.state
        return max(factor_diff(st.U[:-1], f64.U[:-1])["scale"],
                   factor_diff(st.V[:-1], f64.V[:-1])["scale"])

    fac_k1, fac_ctl = fac(res.state), fac(ctl.state)
    log(f"{what} train() (2 epochs, layouts built inside): {wall:.1f} s, "
        f"s/epoch {s_epoch}; held-out rmse "
        f"{[round(x, 6) for x in res.rmse_history]}; with the plain solve "
        f"in float64 {[round(x, 6) for x in ref.rmse_history]} ({wall64:.1f}"
        f" s), |diff| {[f'{d:.2e}' for d in diff]}; control (A, b rounded "
        f"to TF32) {[round(x, 6) for x in ctl.rmse_history]}, |diff| "
        f"{[f'{d:.2e}' for d in diff_ctl]}; factors against the float64 "
        f"run's (largest |diff| / largest |entry|): K1 {fac_k1:.3e}, "
        f"control {fac_ctl:.3e}; kernel launches {launches}")
    check(launches["spd_solve tiled"] > 0 and launches["spd_solve tiled"]
          == launches["spd_solve"], f"{what}: every K1 launch the tiled "
          f"body's")
    fused = uses_fused(dev, torch.float32, None, True, rank)
    check((launches["fused_gram"] > 0) == fused, f"{what}: fused_gram "
          f"launched exactly when it takes the width")
    check(len(res.rmse_history) == len(ref.rmse_history) == 2
          and max(diff) <= WIDE_F64_RMSE_TOL, f"{what}: held-out rmse within "
          f"{WIDE_F64_RMSE_TOL} of the run with the float64 plain solve")
    check(fac_k1 <= WIDE_F64_FACTOR_TOL, f"{what}: factors within "
          f"{WIDE_F64_FACTOR_TOL} of the run with the float64 plain solve")
    check(len(ctl.rmse_history) == 2 and (max(diff_ctl) > WIDE_F64_RMSE_TOL
                                          or fac_ctl > WIDE_F64_FACTOR_TOL),
          f"{what}: the TF32 control run differs from the float64 run by "
          f"more than {WIDE_F64_RMSE_TOL} in held-out rmse or "
          f"{WIDE_F64_FACTOR_TOL} in the factors")
    check(res.rmse_history[1] < res.rmse_history[0], f"{what}: held-out "
          f"rmse falls")
    check_trash_rows(res.state, what)
    cold_u = np.setdiff1d(np.arange(n_users), tu)
    cold_i = np.setdiff1d(np.arange(n_items), ti)
    check(not bool(res.state.U[torch.as_tensor(cold_u, device=dev)].any())
          and not bool(res.state.V[torch.as_tensor(cold_i,
                                                   device=dev)].any()),
          f"{what}: cold rows stay 0")
    out = {}
    if wide_checks:
        diff_alt = [abs(a - b) for a, b in zip(alt.rmse_history,
                                               res.rmse_history)]
        alt_d = [[abs(a - b) for a, b in zip(x.rmse_history,
                                             alt_ref.rmse_history)]
                 for x in (alt, alt_ctl)]
        log(f"{what} with the route patched to row gather -> einsum -> K1: "
            f"held-out rmse {[round(x, 6) for x in alt.rmse_history]}, "
            f"|diff| to the fused_gram run {[f'{d:.2e}' for d in diff_alt]}"
            f" ({alt_wall:.1f} s); kernel launches {alt_launches}; on this "
            f"route against its float64 run: K1 |diff| "
            f"{[f'{d:.2e}' for d in alt_d[0]]}, factors "
            f"{fac(alt.state, alt_ref.state):.3e}; TF32 control |diff| "
            f"{[f'{d:.2e}' for d in alt_d[1]]}, factors "
            f"{fac(alt_ctl.state, alt_ref.state):.3e}")
        check(alt_launches["fused_gram"] == 0
              and alt_launches["row_gather"] > 0
              and alt_launches["spd_solve tiled"] > 0,
              f"{what}, route patched: row gather and K1, no fused_gram")
        check(len(alt.rmse_history) == 2 and max(diff_alt) <= ROUTE_RMSE_TOL,
              f"{what}: held-out rmse of the route-patched run within "
              f"{ROUTE_RMSE_TOL} of the fused_gram run at each epoch")
        log(f"{what} train(ooc=True), wire pinned: held-out rmse "
            f"{[round(x, 6) for x in ooc_res.rmse_history]} ({ooc_wall:.1f}"
            f" s, wire built inside); kernel launches {ooc_launches}")
        check(ooc_res.rmse_history == res.rmse_history
              and torch.equal(ooc_res.state.U, res.state.U)
              and torch.equal(ooc_res.state.V, res.state.V),
              f"{what}: train(ooc=True) bit-equal to the resident train() "
              f"in rmse and factors")
        check(ooc_launches["fused_gram"] > 0
              and ooc_launches["spd_solve tiled"] > 0,
              f"{what} ooc: fused_gram and K1's tiled body launched")
        out["ooc_launches"] = ooc_launches
        del alt, alt_ref, alt_ctl, ooc_res
    state = res.state
    del res, ref, ctl
    # one more epoch on train()'s own layouts, profiled by kernel
    lays = [device_bucketed(g, torch.float32, dev, rating_dtype=(
        torch.bfloat16 if fused else None)) for g in built.values()]
    epoch = als_epoch_fn(*lays, MAIN["lam"], gather_bf16=True)
    by_kernel = {}
    state, dev_ms = profile_breakdown(lambda: epoch(state),
                                      f"a {what} epoch", by_kernel)
    k1_ms = sum(v for k, v in by_kernel.items() if "spd_solve" in k)
    fg_ms = sum(v for k, v in by_kernel.items() if "fused_gram" in k)
    old = MMA_SYNC_RANK192
    was = (f" (the mma.sync wide body: {old['dev_ms']} ms, fused_gram "
           f"{old['fused_gram_ms']}, K1 {old['k1_ms']}, "
           f"{old['s_epoch'][0]}-{old['s_epoch'][1]} s/epoch; the einsum "
           f"route: {EINSUM_RANK192_DEV_MS} ms, "
           f"{EINSUM_RANK192_S_EPOCH[0]}-{EINSUM_RANK192_S_EPOCH[1]} "
           f"s/epoch)"
           if rank == 192 else "")
    log(f"{what} epoch by kernel: K1 {k1_ms:.3f} ms = "
        f"{k1_ms / dev_ms:.3f} of {dev_ms:.3f} ms of device time, "
        f"fused_gram {fg_ms:.3f}{was}; on {smi}")
    del epoch, built
    torch.cuda.empty_cache()
    out.update(state=state, launches=launches, s_epoch=s_epoch,
               k1_ms=k1_ms, fg_ms=fg_ms, dev_ms=dev_ms, lays=lays)
    return out


def phase_rank128(dev, tu, ti, tr, su, si, sr, tmp: str, smi: str) -> dict:
    """ALS-WR at rank 128 (``bench.py --rank 128``): fused_gram at w 128,
    then K1's tiled body at n = 128 (``wide_train``)."""
    out = wide_train(dev, 128, tu, ti, tr, su, si, sr, tmp, smi)
    check(out["launches"]["fused_gram"] > 0, "rank 128: fused_gram "
          "launched")
    del out["state"], out["lays"]
    return out


def phase_rank192(dev, tu, ti, tr, su, si, sr, tmp: str, smi: str) -> dict:
    """ALS-WR at rank 192 through train() (``wide_train`` with its wide
    checks): the phase takes fused_gram's wide body -> K1 (the tiled body
    at n = 192), so fused_gram launches and row_gather does not; the
    route patched back to row gather -> einsum -> K1 agrees within
    ROUTE_RMSE_TOL and train(ooc=True) bit for bit. Then one rank-256
    epoch on the same layouts (the wide body at w 256, K1 at n = 256), and
    fold-in of 256 users at rank 192 (K1 at n = 192) and at rank 256 from
    a random start (K1 at n = 256), each against a float64 solve."""
    from ycnr_tpu_torch.models.base import init_state
    from ycnr_tpu_torch.models.bucketed_phase import als_epoch_fn

    out = wide_train(dev, 192, tu, ti, tr, su, si, sr, tmp, smi,
                     wide_checks=True)
    launches = out["launches"]
    check(launches["fused_gram"] > 0, "fused_gram launched at rank 192 "
          "(its wide body)")
    check(launches["row_gather"] == 0, "row_gather does not launch in the "
          "rank-192 bf16 ALS-WR epochs")
    # one epoch at rank 256 on the rank-192 run's layouts (they hold bf16
    # ratings, as the fused branch reads at every width up to 256)
    st = init_state(MAIN["n_users"], MAIN["n_items"], 256, seed=0,
                    device=dev)
    epoch = als_epoch_fn(*out.pop("lays"), MAIN["lam"], gather_bf16=True)
    sync()
    reset_launches()
    t0 = time.time()
    st = epoch(st)
    sync()
    wall256 = time.time() - t0
    l256 = read_launches()
    log(f"rank 256, one bf16 ALS-WR epoch (als_epoch_fn on the rank-192 "
        f"layouts): {wall256:.4f} s; kernel launches {l256}")
    check(l256["fused_gram"] > 0 and l256["spd_solve tiled"] > 0
          and l256["row_gather"] == 0, "rank 256: fused_gram's wide body "
          "and K1's tiled body launched, row_gather not")
    check(bool(torch.isfinite(st.U).all() and torch.isfinite(st.V).all()),
          "rank 256: finite factors")
    check_trash_rows(st, "rank 256")
    del st, epoch
    torch.cuda.empty_cache()
    f192 = phase_fold_in(out.pop("state"), tu, ti, tr)
    k1_192 = launches["spd_solve"] + f192["spd_solve"]
    st256 = init_state(MAIN["n_users"], MAIN["n_items"], 256, seed=0,
                       device=dev)
    f256 = phase_fold_in(st256, tu, ti, tr)
    del st256
    torch.cuda.empty_cache()
    log(f"K1 launches: n = 192 {k1_192} (train() and fold-in), n = 256 "
        f"{l256['spd_solve'] + f256['spd_solve']} (the rank-256 epoch and "
        f"fold-in); fused_gram's wide body: w 192 "
        f"{launches['fused_gram'] + out['ooc_launches']['fused_gram']} "
        f"(train() and train(ooc=True)), w 256 {l256['fused_gram']}; on "
        f"{smi}")
    out.update(k1_n192=k1_192, k1_n256=l256["spd_solve"] + f256["spd_solve"],
               fg_w192=launches["fused_gram"]
               + out["ooc_launches"]["fused_gram"],
               fg_w256=l256["fused_gram"])
    return out


@contextlib.contextmanager
def shared_bucketed_layouts(known: dict):
    """While open, train()'s host bucketed-layout builds are memoized by
    their arguments (the arrays by identity), starting from ``known``:
    the in-process train() runs that the command line is held to then
    build no layout that the main path already built. The layouts are a
    pure function of those arguments, so no device work changes."""
    import importlib

    loop = importlib.import_module("ycnr_tpu_torch.train.loop")
    real = loop.build_bucketed
    cache = dict(known)

    def build(a, b, r, na, nb, chunk, rank, max_groups):
        key = (id(a), id(b), id(r), na, nb, chunk, rank, max_groups)
        if key not in cache:
            cache[key] = real(a, b, r, na, nb, chunk, rank,
                              max_groups=max_groups)
        return cache[key]

    loop.build_bucketed = build
    try:
        yield cache
    finally:
        loop.build_bucketed = real


def phase_cli(dev, u, i, r, tu, ti, tr, su, si, sr, ul, il, smi: str,
              tmp: str, shm_name: str) -> dict:
    """The command line, in process (ycnr_tpu_torch.cli.main) on the card at
    full width: a RatingsStore written once from the ML-20M-shaped arrays;
    train --preset ml20m-als --publish-shm (rank 64, bf16: fused_gram + K1)
    with a config file that gives the main path's split (test_fraction
    0.05, seed 0) and groups, held to an in-process train() and the
    reference trajectory;
    validate --hit-rate; recommend --all --scorer fused (K2) against
    in-process recommend_all, --user, --rated (fold-in: K1); export; tune
    over three lams, each entry against a standalone train(). The
    in-process runs reuse the main path's host layouts ul, il (the same
    arguments), as shared_bucketed_layouts says."""
    import dataclasses
    import io

    from ycnr_tpu_torch.cli import main as cli
    from ycnr_tpu_torch.config import get_preset
    from ycnr_tpu_torch.data.dataset import Dataset
    from ycnr_tpu_torch.data.store import RatingsStore
    from ycnr_tpu_torch.eval.recommend import NEG_INF, recommend_all
    from ycnr_tpu_torch.ops.layout import build_blocked_csr
    from ycnr_tpu_torch.train.checkpoint import load_checkpoint
    from ycnr_tpu_torch.train.loop import train

    store = os.path.join(tmp, "store")
    t0 = time.time()
    RatingsStore(store).append(u, i, r)
    log(f"cli: RatingsStore of {len(r):,} rows written in "
        f"{time.time() - t0:.1f} s")
    cfg_file = os.path.join(tmp, "split.json")
    with open(cfg_file, "w") as f:
        json.dump({"data": {"test_fraction": 0.05, "seed": 0,
                            "max_groups": MAIN["groups"]}}, f)
    out = os.path.join(tmp, "runs")
    per_cmd = {}

    def run(name, *argv):
        """One command on the card (the default device); its JSON lines
        and the kernels it launched."""
        sync()
        reset_launches()
        buf = io.StringIO()
        t0 = time.time()
        with contextlib.redirect_stdout(buf):
            cli(list(argv))
        sync()
        launches = read_launches()
        per_cmd[name] = launches
        lines = [json.loads(x) for x in buf.getvalue().splitlines()
                 if x.startswith("{")]
        log(f"cli {name}: {time.time() - t0:.1f} s; launches "
            f"{ {k: v for k, v in launches.items() if v} }")
        return lines, launches

    lines, ln = run("train", "train", "--preset", "ml20m-als", "--config",
                    cfg_file, "--store", store, "--epochs", "4", "--out", out,
                    "--publish-shm", shm_name)
    check(ln["fused_gram"] > 0 and ln["spd_solve"] > 0,
          "cli train: fused_gram and K1 launched")
    run_dir = os.path.join(out, "ml20m-als")
    got = [e["rmse_test"] for e in read_events(run_dir) if "rmse_test" in e]
    check(len(got) == 4 and lines[-1]["epochs"] == 4, "cli train: 4 epochs")
    base = get_preset("ml20m-als")
    cfg = base.replace(
        data=dataclasses.replace(base.data, test_fraction=0.05, seed=0,
                                 max_groups=MAIN["groups"]),
        als=dataclasses.replace(base.als, epochs=4), out_dir="")
    ds = Dataset(n_users=MAIN["n_users"], n_items=MAIN["n_items"],
                 train_u=tu, train_i=ti, train_r=tr, test_u=su, test_i=si,
                 test_r=sr, mu=float(tr.mean()), chunk_len=32, rank_hint=64)
    g = MAIN["groups"]
    known = {(id(tu), id(ti), id(tr), ds.n_users, ds.n_items, 32, 64, g): ul,
             (id(ti), id(tu), id(tr), ds.n_items, ds.n_users, 32, 64, g): il}
    with shared_bucketed_layouts(known):
        solo = [round(x, 6) for x in train(cfg, dataset=ds,
                                           device=dev).rmse_history]
    log(f"cli train rmse {got}; in-process train() {solo}; reference "
        f"{list(ANCHOR_RMSE)}")
    check(all(abs(a - b) <= 1e-6 for a, b in zip(got, solo)),
          "cli train: per-epoch rmse equals in-process train()")
    for ep, (a, want) in enumerate(zip(got, ANCHOR_RMSE)):
        check(abs(a - want) <= RMSE_TOL, f"cli train epoch {ep + 1} rmse "
              f"{a} within {RMSE_TOL} of {want}")
    ckpt = os.path.join(run_dir, "ckpt")

    lines, _ = run("validate", "validate", "--ckpt", ckpt, "--store", store,
                   "--test-fraction", "0.05", "--hit-rate")
    log(f"cli validate: {lines[-1]}")
    check(abs(lines[-1]["rmse_test"] - got[-1]) <= 1e-6,
          "cli validate reproduces the last rmse")
    check(0.0 <= lines[-1]["hit_rate"] <= 1.0, "cli validate: hit rate")

    recs = os.path.join(tmp, "recs.jsonl")
    lines, ln = run("recommend --all --scorer fused", "recommend", "--ckpt",
                    ckpt, "--store", store, "--all", "-n", "10", "--scorer",
                    "fused", "--save", recs)
    check(ln["fused_scores"] > 0, "cli recommend --all --scorer fused: K2 "
          "launched")
    with open(recs) as f:
        rows = [json.loads(x) for x in f]
    check([x["user"] for x in rows] == np.unique(u).tolist(),
          "cli recommend --all: every rated user, in order")
    # in-process recommend_all on SAMPLE_USERS sampled users (their own
    # layout: K2 scores every user on its own)
    state, _ = load_checkpoint(ckpt, device=dev)
    rng = np.random.default_rng(2)
    pick = np.sort(rng.choice(len(rows), SAMPLE_USERS, replace=False))
    sample = [rows[j] for j in pick]
    keep = np.isin(u, [x["user"] for x in sample])
    slay = build_blocked_csr(u[keep], i[keep], r[keep], state.n_users,
                             state.n_items, rank_hint=state.rank)
    users, items, scores = recommend_all(state, slay, n=10, method="fused")
    check(users.tolist() == [x["user"] for x in sample],
          "in-process recommend_all serves the sampled users")
    # the command drops a list's NEG_INF-masked tail (fewer than n unrated)
    same = sum(x["items"] == want[sc > NEG_INF / 2].tolist()
               for x, want, sc in zip(sample, items, scores))
    order = np.argsort(u, kind="stable")
    us, is_ = u[order], i[order]
    # probe in the index's own dtype (a Python int would make NumPy
    # convert all 20M entries on every probe)
    probe = np.asarray([x["user"] for x in sample], us.dtype)
    lo, hi = np.searchsorted(us, probe), np.searchsorted(us, probe, "right")
    served_rated = sum(len(set(x["items"]) & set(is_[a:b].tolist()))
                       for x, a, b in zip(sample, lo, hi))
    log(f"cli recommend --all --scorer fused: {len(rows):,} users; of "
        f"{len(sample):,} sampled, lists equal to in-process "
        f"recommend_all's: {same:,}, rated items served: {served_rated}")
    check(same == len(sample), "cli recommend --all: ids of in-process "
          "recommend_all")
    check(served_rated == 0, "cli recommend --all: no rated item served")
    del rows, slay

    lines, _ = run("recommend --user", "recommend", "--ckpt", ckpt,
                   "--store", store, "--user", "1", "2", "3", "-n", "10")
    check(len(lines) == 3 and all(len(x["items"]) == 10 for x in lines),
          "cli recommend --user: three lists of 10")
    rated = ",".join(f"{int(a)}:{float(b)}" for a, b in
                     zip(is_[:20], np.asarray(r)[order][:20]))
    lines, ln = run("recommend --rated", "recommend", "--ckpt", ckpt,
                    "--store", store, "--rated", rated, "-n", "10")
    check(ln["spd_solve"] > 0, "cli recommend --rated: K1 launched")
    check(len(lines[-1]["items"]) == 10 and not set(lines[-1]["items"])
          & set(int(a) for a in is_[:20]),
          "cli recommend --rated: 10 unrated items")
    emb = os.path.join(tmp, "emb.npz")
    lines, _ = run("export", "export", "--ckpt", ckpt, "--out", emb)
    z = np.load(emb)
    check(z["U"].shape == (MAIN["n_users"], 64) and bool(
        np.isfinite(z["V"]).all()), "cli export: U and V")

    lines, ln = run("tune", "tune", "--preset", "ml20m-als", "--config",
                    cfg_file, "--store", store, "--lams", "0.03,0.05,0.08",
                    "--seeds", "0", "--epochs", "2", "--out", out)
    board, best = lines[:-1], lines[-1]
    check(len(board) == 3 and best["event"] == "best", "cli tune: three "
          "entries and the best")
    for e in board:
        if e["lam"] == MAIN["lam"]:
            want = solo[:2]  # the 4-epoch run above, at the same lam
        else:
            c = cfg.replace(als=dataclasses.replace(cfg.als, lam=e["lam"],
                                                    epochs=2))
            with shared_bucketed_layouts(known):
                want = [round(x, 6) for x in train(
                    c, dataset=ds, device=dev).rmse_history]
        log(f"cli tune lam {e['lam']}: {e['rmse']}; standalone train() "
            f"{want}")
        check(e["rmse"] == want or all(abs(a - b) <= 1e-6 for a, b in
                                       zip(e["rmse"], want)),
              f"cli tune lam {e['lam']}: equals a standalone train()")
    st, man = load_checkpoint(os.path.join(best["out_dir"], "ckpt"),
                              device=dev)
    check(man["config"]["als"]["lam"] == best["lam"] and bool(
        torch.isfinite(st.U).all()), "cli tune: best checkpoint loads")
    log(f"cli: kernel launches per command {per_cmd}; on {smi}")
    return {"per_cmd": per_cmd, "store": store, "ckpt": ckpt,
            "cfg_file": cfg_file}


SERVE_USERS = 512  # users whose lists are computed in process per state
SERVE_F64_USERS = 256  # of them, held to a float64 host scoring
SERVE_CLIENTS = 8
SERVE_LINES = 256  # single-user lines per client
SERVE_CACHE = 1 << 16  # ShmRecCache slots (the CLI's --shm-cache default)
PREDICT_TOL = 5e-5 + 1e-5  # the reply's rounding to 4 decimals, plus f32


def shm_free_bytes() -> int:
    st = os.statvfs("/dev/shm")
    return st.f_bavail * st.f_frsize


def factor_segment_bytes(n_users: int, n_items: int, rank: int) -> int:
    """The f32 payload of a factor segment (its header is a few bytes)."""
    return 4 * ((n_users + 1) * (rank + 1) + (n_items + 1) * (rank + 1))


class LineClient:
    """One TCP connection speaking the server's line protocol."""

    def __init__(self, addr):
        import socket

        self.sock = socket.create_connection(addr, timeout=120)
        self.f = self.sock.makefile("rw")

    def ask(self, line: str):
        t0 = time.perf_counter()
        self.f.write(line + "\n")
        self.f.flush()
        reply = json.loads(self.f.readline())
        return reply, time.perf_counter() - t0

    def close(self):
        self.f.close()
        self.sock.close()


def same_up_to_ties(got, want, row, tol: float) -> bool:
    """``ids_equal_up_to_ties`` for two id lists of one user, each ranked
    by its float64 scores ``row``."""
    got, want = np.asarray(got), np.asarray(want)
    if len(got) != len(want):
        return False
    a = got[np.argsort(-row[got], kind="stable")]
    b = want[np.argsort(-row[want], kind="stable")]
    return ids_equal_up_to_ties([a], row[a][None], [b], row[b][None], tol)


def phase_serve(dev, u, i, cli: dict, names: dict, smi: str,
                tmp: str) -> dict:
    """The serving processes on the card at the ML-20M shape, rank 64:
    the CLI's train --publish-shm segment against its checkpoint; publish;
    ShmRecommender + ShmRecCache + ServingApp + serve_tcp in process,
    precompute (K2), traffic of every request kind over TCP held to
    in-process and float64 scorings; three republishes under traffic
    (monotone epochs per connection); a second serving process on the same
    segment and cache. Returns the kernels' launches per part."""
    import io
    import select
    import threading

    from ycnr_tpu_torch.cli import main as cli_main
    from ycnr_tpu_torch.eval.recommend import NEG_INF, recommend_all, \
        top_popular
    from ycnr_tpu_torch.native import get_shm_lib
    from ycnr_tpu_torch.ops.layout import build_blocked_csr
    from ycnr_tpu_torch.serve.cache import RecCache, ShmRecCache
    from ycnr_tpu_torch.serve.engine import Recommender
    from ycnr_tpu_torch.serve.server import ServingApp, serve_tcp
    from ycnr_tpu_torch.serve.shm import (FactorShmReader, FactorShmWriter,
                                          ShmRecommender)
    from ycnr_tpu_torch.train.checkpoint import load_checkpoint

    nu, ni, k, n = MAIN["n_users"], MAIN["n_items"], MAIN["rank"], 10
    out = {}

    # ---- 1. the train --publish-shm segment against the checkpoint -------
    ckpt_state, man = load_checkpoint(cli["ckpt"], device=dev)
    with FactorShmReader(names["train"]) as reader:
        got, epoch = reader.read(device=dev)
    check(epoch == 4 == man["epoch"], f"train --publish-shm: epoch {epoch}")
    check(all(torch.equal(a, b) for a, b in zip(got, ckpt_state)),
          "train --publish-shm: factors bit-equal to the checkpoint's")
    ln = cli["per_cmd"]["train"]
    check(ln["fused_gram"] > 0 and ln["spd_solve"] > 0,
          "train --publish-shm: fused_gram and K1 launched")
    out["train"] = ln
    del got
    get_shm_lib().ycnr_shm_unlink(names["train"].encode())

    # ---- 2. publish ------------------------------------------------------
    need = factor_segment_bytes(nu, ni, k) + SERVE_CACHE * (
        24 + 4 * ShmRecCache.N_MAX)
    free = shm_free_bytes()
    log(f"serve: /dev/shm free {free:,} bytes; the segment and the cache "
        f"need {need:,}")
    check(free > need, "serve: /dev/shm has room for the factor segment "
          "and the cache")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli_main(["publish", "--ckpt", cli["ckpt"], "--shm", names["serve"]])
    pub = json.loads(buf.getvalue().splitlines()[-1])
    check(pub["epoch"] == 4, f"publish: epoch {pub['epoch']}")
    with FactorShmReader(names["serve"]) as reader:
        ms = []
        for _ in range(5):
            sync()
            t0 = time.perf_counter()
            reader.read(device=dev)
            sync()
            ms.append(1e3 * (time.perf_counter() - t0))
    out["read_ms"] = float(np.median(ms))
    log(f"serve: FactorShmReader.read + host-to-device of "
        f"{factor_segment_bytes(nu, ni, k) / 1e6:.1f} MB: median "
        f"{out['read_ms']:.2f} ms of {[round(x, 2) for x in ms]}")

    # ---- 3. the app in process --------------------------------------------
    t0 = time.time()
    cache = ShmRecCache(names["cache"], capacity=SERVE_CACHE)
    rec = ShmRecommender(names["serve"], u, i, cache=cache, device=dev)
    app = ServingApp(rec, n=n, fold_lam=MAIN["lam"], shm=True, source="shm",
                     store_meta={"n_users": nu, "n_items": ni})
    srv = serve_tcp(app, "127.0.0.1", 0)
    addr = srv.server_address[:2]
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    log(f"serve: app up in {time.time() - t0:.1f} s on {addr}")
    proc = None
    try:
        sync()
        reset_launches()
        by_kernel = {}
        t0 = time.time()
        n_pre, _ = profile_breakdown(
            lambda: rec.engine.precompute_all(n), "precompute_all (profiled)",
            by_kernel)
        sync()
        out["precompute_s"] = time.time() - t0
        out["precompute"] = read_launches()
        out["k2_ms"] = sum(v for key, v in by_kernel.items()
                           if "fused_scores" in key)
        check(out["precompute"]["fused_scores"] > 0,
              "serve precompute_all: K2 launched")
        n_rated = int(np.unique(u).size)
        check(n_pre == n_rated, f"precompute_all cached {n_pre} of {n_rated}")
        log(f"serve: precompute_all {n_pre:,} users in "
            f"{out['precompute_s']:.2f} s of wall (host layout build "
            f"included), K2 {out['k2_ms']:.3f} ms of device time; launches "
            f"{ {a: b for a, b in out['precompute'].items() if b} }")

        # what the in-process engine serves, per published state
        rng = np.random.default_rng(7)
        users_all = np.unique(u)
        sample = np.sort(rng.choice(users_all, SERVE_USERS, replace=False))
        state0 = rec.engine.state
        exp = Recommender(state0, u, i, cache=RecCache())
        keep = np.isin(u, sample)
        slay = build_blocked_csr(u[keep], i[keep], np.ones(int(keep.sum()),
                                                          np.float32),
                                 nu, ni, rank_hint=k)
        su_, k2_items, k2_scores = recommend_all(state0, slay, n=n,
                                                 method="fused")
        check(su_.tolist() == sample.tolist(), "K2 lists of the sample")
        k2 = {int(x): row[sc > NEG_INF / 2].tolist()
              for x, row, sc in zip(su_, k2_items, k2_scores)}
        sidx = torch.as_tensor(sample, device=dev)

        def host_scores(st):
            s = (st.U[sidx].double() @ st.V[:-1].double().T
                 + st.bi[:-1].double() + st.bu[sidx].double()[:, None]
                 + st.mu.double())
            return s.cpu().numpy()

        pos = {int(x): j for j, x in enumerate(sample)}
        states = [state0]
        for e in range(1, 4):  # three seeded further states: users permuted
            perm = torch.as_tensor(np.random.default_rng(100 + e)
                                   .permutation(nu), device=dev)
            U = state0.U.clone()
            U[:nu] = state0.U[perm]
            states.append(state0._replace(U=U))
        exact, rows64 = [], []
        for st in states:
            exp.update_state(st)
            exact.append({int(x): lst.tolist() for x, lst in
                          zip(sample, exp.recommend_batch(sample, n))})
            rows64.append(host_scores(st))
        exp.update_state(state0)
        order = np.argsort(u, kind="stable")
        us_, is_ = u[order], i[order]
        lo = np.searchsorted(us_, sample.astype(us_.dtype))
        hi = np.searchsorted(us_, sample.astype(us_.dtype), "right")
        rated = {int(x): set(is_[a:b].tolist())
                 for x, a, b in zip(sample, lo, hi)}

        def epochs_of(x, items):
            """The published states (0-3) whose in-process list this is."""
            x = int(x)
            j = pos[x]
            return {e for e in range(4)
                    if same_up_to_ties(items, exact[e][x], rows64[e][j],
                                       TIE_TOL)
                    or (e == 0 and items == k2[x])}

        # -- single-user lines, 8 clients, through the micro-batcher ------
        answers = [[] for _ in range(SERVE_CLIENTS)]

        def single_client(c):
            cl_ = LineClient(addr)
            crng = np.random.default_rng(200 + c)
            for x in crng.choice(sample, SERVE_LINES):
                reply, _ = cl_.ask(str(int(x)))
                answers[c].append((int(x), reply))
            cl_.close()

        t0 = time.perf_counter()
        threads = [threading.Thread(target=single_client, args=(c,))
                   for c in range(SERVE_CLIENTS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
            check(not t.is_alive(), "serve: a single-user client finished")
        single_s = time.perf_counter() - t0
        stats = json.loads(app.handle("stats"))
        n_lines = SERVE_CLIENTS * SERVE_LINES
        errors = [a for c in answers for a in c if "error" in a[1]]
        check(not errors, f"serve: single-user errors {errors[:3]}")
        bad = [(x, r["items"]) for c in answers for x, r in c
               if 0 not in epochs_of(x, r["items"])]
        check(not bad, f"serve: single-user lists equal the in-process "
              f"engine's up to ties ({len(bad)} not: {bad[:2]})")
        check(all(not set(r["items"]) & rated[x] for c in answers
                  for x, r in c), "serve: no rated item served")
        lat = stats["latency"]
        out["single"] = dict(rps=n_lines / single_s, **{
            p: lat[p] for p in ("p50_ms", "p90_ms", "p99_ms")},
            batches=stats["batches"],
            batched=stats["batched_requests"])
        log(f"serve: {n_lines} single-user lines from {SERVE_CLIENTS} "
            f"clients in {single_s:.2f} s = {out['single']['rps']:,.0f} "
            f"requests/s; p50 {lat['p50_ms']} p90 {lat['p90_ms']} p99 "
            f"{lat['p99_ms']} ms (stats); micro-batches "
            f"{stats['batches']} of {stats['batched_requests']} requests "
            f"(the rest were cache hits)")

        c0 = LineClient(addr)
        # float64 host scoring of 256 of them
        f64_bad = 0
        for x in sample[:SERVE_F64_USERS]:
            reply, _ = c0.ask(str(int(x)))
            row = rows64[0][pos[int(x)]].copy()
            row[list(rated[int(x)])] = -np.inf
            want = np.argsort(-row, kind="stable")[:n]
            got = reply["items"]
            ok = same_up_to_ties(got, want, row, TIE_TOL)
            if not ok and got == k2[int(x)]:
                nth = row[want[-1]]  # K2: within one bf16 step of the 10th
                ok = bool((row[got] >= nth - BF16_REL * abs(nth)
                           - TIE_TOL).all())
            f64_bad += not ok
        check(f64_bad == 0, f"serve: {SERVE_F64_USERS} users' lists equal a "
              f"float64 host scoring up to ties ({f64_bad} not)")

        # -- batch: lines of 1,024 users ----------------------------------
        batch_s = []
        others = rng.choice(users_all, 16 * 512)
        for b in range(16):
            ids = np.r_[rng.permutation(sample), others[b * 512:
                                                       (b + 1) * 512]]
            reply, dt = c0.ask("batch:" + ",".join(str(int(x)) for x in ids))
            batch_s.append(dt)
            check("error" not in reply and len(reply["items"]) == len(ids),
                  "serve: a batch line answered whole")
            for x, items in zip(ids, reply["items"]):
                if int(x) in pos:
                    check(0 in epochs_of(x, items), f"serve batch: user {x}")
                    check(not set(items) & rated[int(x)],
                          f"serve batch: user {x} no rated item")
        out["batch_ms"] = 1e3 * float(np.median(batch_s))
        log(f"serve: 16 batch lines of 1,024 users: median "
            f"{out['batch_ms']:.1f} ms a line (max "
            f"{1e3 * max(batch_s):.1f})")

        # -- cold: lines (fold-in: row_gather + K1) -----------------------
        crng = np.random.default_rng(9)
        colds = [(crng.choice(ni, 20, replace=False),
                  crng.integers(1, 11, 20) / 2.0) for _ in range(256)]
        sync()
        reset_launches()
        cold_replies, cold_s = [], []
        for items, ratings in colds:
            reply, dt = c0.ask("cold:" + ",".join(
                f"{a}:{b}" for a, b in zip(items, ratings)))
            cold_replies.append(reply)
            cold_s.append(dt)
        sync()
        out["cold"] = read_launches()
        check(out["cold"]["spd_solve"] > 0 and out["cold"]["row_gather"] > 0,
              "serve cold: K1 and row_gather launched")
        for (items, ratings), reply in zip(colds, cold_replies):
            want = exp.recommend_cold(items, ratings, n=n, lam=MAIN["lam"])
            check("error" not in reply and reply["items"] == want.tolist(),
                  "serve cold: equal to in-process recommend_cold")
            check(not set(reply["items"]) & set(items.tolist()),
                  "serve cold: no rated item served")
        out["cold_ms"] = (1e3 * float(np.percentile(cold_s, 50)),
                          1e3 * float(np.percentile(cold_s, 99)))
        log(f"serve: 256 cold lines of 20 ratings: p50 "
            f"{out['cold_ms'][0]:.2f} ms, p99 {out['cold_ms'][1]:.2f} ms "
            f"(client clock); launches "
            f"{ {a: b for a, b in out['cold'].items() if b} }")

        # -- predict:, exclude:, similar:, popular, stats ------------------
        live = np.flatnonzero((state0.V[:-1] != 0).any(1).cpu().numpy())
        for j in range(64):
            x = int(sample[j])
            items = crng.choice(ni, 5, replace=False)
            reply, _ = c0.ask(f"predict:{x}:" + ",".join(map(str, items)))
            want = rows64[0][pos[x]][items]
            check("error" not in reply and np.allclose(
                reply["scores"], want, rtol=0, atol=PREDICT_TOL),
                f"serve predict: user {x} within {PREDICT_TOL} of float64")
            ex = exact[0][x][:3]
            reply, _ = c0.ask(f"exclude:{x}:" + ",".join(map(str, ex)))
            check("error" not in reply and len(reply["items"]) == n
                  and not set(reply["items"]) & set(ex)
                  and not set(reply["items"]) & rated[x],
                  f"serve exclude: user {x}")
            q = int(crng.choice(live))
            reply, _ = c0.ask(f"similar:{q}")
            check("error" not in reply and len(reply["similar"]) == n
                  and q not in reply["similar"], f"serve similar: item {q}")
        reply, _ = c0.ask("popular")
        check(reply["popular"] == top_popular(i, ni, n).tolist(),
              "serve popular: the store's top counts")
        reply, _ = c0.ask("stats")
        check(reply["epoch"] == 4 and reply["source"] == "shm",
              f"serve stats: {reply}")
        c0.close()

        # ---- 4. hot reload under traffic ----------------------------------
        stop = threading.Event()
        seen = [[] for _ in range(SERVE_CLIENTS)]

        def reload_client(c):
            cl_ = LineClient(addr)
            crng_ = np.random.default_rng(300 + c)
            while not stop.is_set():
                x = int(crng_.choice(sample))
                reply, _ = cl_.ask(str(x))
                seen[c].append((time.perf_counter(), x, reply))
            cl_.close()

        threads = [threading.Thread(target=reload_client, args=(c,))
                   for c in range(SERVE_CLIENTS)]
        for t in threads:
            t.start()
        pub_t = {}
        with FactorShmWriter(names["serve"], nu, ni, k) as writer:
            for e in range(1, 4):
                time.sleep(1.0)
                writer.publish(states[e], 4 + e)
                pub_t[e] = time.perf_counter()
            time.sleep(1.0)
        stop.set()
        for t in threads:
            t.join(timeout=120)
            check(not t.is_alive(), "serve reload: a client finished")
        n_seen = sum(len(c) for c in seen)
        errors = [r for c in seen for _, _, r in c if "error" in r]
        check(not errors, f"serve reload: errors {errors[:3]}")
        first = {}
        for c in seen:
            floor_ = 0
            for t, x, r in c:
                cand = epochs_of(x, r["items"])
                check(bool(cand), f"serve reload: user {x}'s list is one "
                      f"published state's")
                up = [e for e in cand if e >= floor_]
                check(bool(up), f"serve reload: epochs go back on a "
                      f"connection (user {x}, {cand} after {floor_})")
                floor_ = min(up)
                if floor_ >= 1 and floor_ - 1 not in cand:
                    first[floor_] = min(first.get(floor_, t), t)
        out["reload_ms"] = [1e3 * (first[e] - pub_t[e]) if e in first
                            else None for e in (1, 2, 3)]
        log(f"serve reload: {n_seen} single-user answers over three "
            f"republishes, every one a published state's list, epochs "
            f"monotone on each of {SERVE_CLIENTS} connections; publish -> "
            f"first answer at the new epoch "
            f"{[None if x is None else round(x, 2) for x in out['reload_ms']]}"
            f" ms")
        check(all(x is not None for x in out["reload_ms"]),
              "serve reload: every new epoch was served")
        c1 = LineClient(addr)
        settled = {}
        for x in sample:
            reply, _ = c1.ask(str(int(x)))
            settled[int(x)] = reply["items"]
            check(3 in epochs_of(x, reply["items"]),
                  f"serve reload: user {x} at the last epoch")
        reply, _ = c1.ask("stats")
        check(reply["epoch"] == 7, f"serve reload: stats epoch {reply}")
        c1.close()

        # ---- 5. a second serving process on the same segment and cache ----
        here = os.path.dirname(os.path.abspath(__file__))
        err = open(os.path.join(tmp, "serve.err"), "w+")
        proc = subprocess.Popen(
            [sys.executable, "-m", "ycnr_tpu_torch", "serve", "--shm",
             names["serve"], "--shm-cache", names["cache"], "--store",
             cli["store"], "-n", str(n), "--listen", "127.0.0.1:0"],
            stdout=subprocess.PIPE, stderr=err, text=True, cwd=here,
            env=dict(os.environ, PYTHONPATH=here))
        t0 = time.time()
        ready_ok = select.select([proc.stdout], [], [], 300)[0]
        line = proc.stdout.readline() if ready_ok else ""
        if not line.startswith("{"):
            err.seek(0)
            log(f"serve subprocess: {err.read()[-3000:]}")
        check(line.startswith("{"), "serve subprocess: ready line")
        ready = json.loads(line)
        log(f"serve subprocess ready in {time.time() - t0:.1f} s: {ready}")
        host, _, port = ready["listen"].rpartition(":")
        c2 = LineClient((host, int(port)))
        diff = 0
        for x in sample:
            reply, _ = c2.ask(str(int(x)))
            diff += not same_up_to_ties(reply["items"], settled[int(x)],
                                        rows64[3][pos[int(x)]], TIE_TOL)
        reply, _ = c2.ask("stats")
        c2.close()
        hits = SERVE_USERS - reply["batched_requests"]
        log(f"serve subprocess: {SERVE_USERS} users, lists equal to the "
            f"in-process app's up to ties: {SERVE_USERS - diff}; stats "
            f"epoch {reply['epoch']}, {hits} answered from the shared cache "
            f"(requests not micro-batched)")
        check(diff == 0, "serve subprocess: the in-process app's lists")
        check(reply["epoch"] == 7, "serve subprocess: epoch 7")
        check(hits > 0, "serve subprocess: cache hits on the in-process "
              "app's entries")
        out["subprocess_hits"] = hits
    finally:
        if proc is not None:
            proc.terminate()
            try:
                proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
        srv.shutdown()
        srv.server_close()
        app.close()
        rec.close()
        cache.close()
    s = out["single"]
    log(f"serve numbers on {smi}: {s['rps']:,.0f} single-user requests/s "
        f"with {SERVE_CLIENTS} clients, p50 {s['p50_ms']} p90 "
        f"{s['p90_ms']} p99 {s['p99_ms']} ms; batch line of 1,024 "
        f"{out['batch_ms']:.1f} ms; cold p50 {out['cold_ms'][0]:.2f} p99 "
        f"{out['cold_ms'][1]:.2f} ms; reload {out['reload_ms']} ms; "
        f"read + host-to-device {out['read_ms']:.2f} ms; precompute "
        f"{out['precompute_s']:.2f} s, K2 {out['k2_ms']:.3f} ms")
    return out


@contextlib.contextmanager
def shared_wire_builds(known: dict):
    """While open, train()'s host wire builds (build_packed / build_rect)
    are memoized by their arguments (the arrays by identity), starting from
    ``known``, as shared_bucketed_layouts does for the resident layouts."""
    import importlib

    loop = importlib.import_module("ycnr_tpu_torch.train.loop")
    real = {"packed": loop.build_packed, "rect": loop.build_rect}
    cache = dict(known)

    def memo(kind):
        def build(a, b, r, na, nb, rank, max_groups):
            key = (kind, id(a), id(b), id(r), na, nb, rank, max_groups)
            if key not in cache:
                cache[key] = real[kind](a, b, r, na, nb, rank,
                                        max_groups=max_groups)
            return cache[key]
        return build

    loop.build_packed, loop.build_rect = memo("packed"), memo("rect")
    try:
        yield cache
    finally:
        loop.build_packed, loop.build_rect = real["packed"], real["rect"]


@contextlib.contextmanager
def profiled_call(module, name: str, nth: int, what: str, out: dict):
    """While open, the nth call of module.name runs under the profiler
    (profile_breakdown); its device ms and time by kernel go to ``out``."""
    real = getattr(module, name)
    calls = [0]

    def wrapped(*a, **kw):
        calls[0] += 1
        if calls[0] != nth:
            return real(*a, **kw)
        out["by_kernel"] = {}
        res, out["device_ms"] = profile_breakdown(
            lambda: real(*a, **kw), what, out["by_kernel"])
        return res

    setattr(module, name, wrapped)
    try:
        yield
    finally:
        setattr(module, name, real)


def kernel_shares(by_kernel: dict) -> dict:
    """Device ms by part of an epoch: the fused gather -> Gram, K1, the row
    gather, copies (memcpy / memset, host-to-device included), and the
    rest (the wire decode's torch ops, the row writes, split sums)."""
    out = dict.fromkeys(("fused_gram", "K1", "row_gather", "copies",
                         "rest"), 0.0)
    for key, ms in by_kernel.items():
        part = ("fused_gram" if "fused_gram" in key else
                "K1" if "spd_solve" in key else
                "row_gather" if "row_gather" in key else
                "copies" if "Memcpy" in key or "Memset" in key else "rest")
        out[part] += ms
    return out


def phase_ooc(dev, tu, ti, tr, su, si, sr, ul, il, main: dict, cli,
              smi: str, tmp: str, built: dict) -> dict:
    """Out-of-core training on the main path's arrays (ALS-WR rank 64, lam
    0.05, 8 groups, bf16 gathers): the packed wire of both views; 4 epochs
    through train(ooc=True) with the wire pinned ("device", RECT) and
    streamed ("host", packed), and 4 epochs of als_epoch_ooc with half of
    the wire pinned; each against the resident train() of the same config
    in this call (RMSE trajectory and factors bit for bit), the reference
    trajectory, zero trash and cold rows, s/epoch, bytes streamed, peak
    device memory, epoch 3 by kernel. Then one iALS epoch streamed against
    the resident bucketed iALS epoch; wire-order storage (2 epochs) against
    the classic OOC run from the same init; rmse_wire against rmse_padded;
    stream SGD (ml1m-sgd's hyperparameters, 2 epochs, one batch order) in
    its four forms; and python -m ycnr_tpu_torch train --ooc on the CLI
    phase's store against the resident train(). The host builds (the
    packed wires, the wire-order plans and wires, the stream-SGD data and
    its compact wire) come from the host lane (``built``, a pickle of
    ``host_lane``'s "ooc" step, with their seconds)."""
    import dataclasses
    import importlib

    from ycnr_tpu_torch.cli import main as cli_main
    from ycnr_tpu_torch.config import get_preset
    from ycnr_tpu_torch.data.dataset import Dataset
    from ycnr_tpu_torch.models import ooc
    from ycnr_tpu_torch.models.base import (init_state, rmse_padded,
                                            zero_cold_entities)
    from ycnr_tpu_torch.models.bucketed_phase import (device_bucketed,
                                                      ials_epoch_fn)
    from ycnr_tpu_torch.models.sgd_stream import StreamSGD
    from ycnr_tpu_torch.ops.layout import pad_coo
    from ycnr_tpu_torch.ops.packed import packed_stats, rect_from_packed
    from ycnr_tpu_torch.ops.sgd_wire import put_compact
    from ycnr_tpu_torch.train.loop import train

    loop = importlib.import_module("ycnr_tpu_torch.train.loop")
    n_users, n_items, rank, lam, g = (MAIN[k] for k in (
        "n_users", "n_items", "rank", "lam", "groups"))
    nnz = len(tr)
    out = {"launches": dict.fromkeys(("spd_solve", "spd_solve tiled",
                                      "fused_gram", "row_gather"), 0)}

    def count(launches):
        for k in out["launches"]:
            out["launches"][k] += launches[k]

    # ---- 1. the wire ------------------------------------------------------
    with open(built["path"], "rb") as f:
        b = pickle.load(f)
    upk, ipk, t_u, t_i = b["upk"], b["ipk"], b["t_u"], b["t_i"]
    t0 = time.time()
    rect = sum(ooc.wire_nbytes([rect_from_packed(x)]) for x in upk + ipk)
    t_rect = time.time() - t0
    su_, si_ = packed_stats(upk, nnz), packed_stats(ipk, nnz)
    wire = ooc.wire_nbytes(upk, ipk)
    log(f"ooc build: build_packed users {t_u:.1f} s, items {t_i:.1f} s "
        f"(host lane); wire {su_['wire_bytes']:,} + "
        f"{si_['wire_bytes']:,} bytes "
        f"= {su_['wire_bytes_per_rating']:.3f} + "
        f"{si_['wire_bytes_per_rating']:.3f} B/rating ({su_['rating_kind']}"
        f" ratings, fill {su_['fill']:.3f} / {si_['fill']:.3f}); RECT "
        f"after rect_from_packed {rect:,} bytes = {rect / nnz:.3f} B/rating "
        f"({t_rect:.1f} s)")
    check(su_["rating_kind"] == "half", "ooc: half-star ratings ride int8")
    # the host's copy rate into pinned memory: what the streamed tier's
    # staging threads do with every chunk
    src = max((x.lo for x in upk + ipk), key=lambda a: a.nbytes)
    src = src.reshape(-1).view(np.uint8)
    pin = torch.empty(src.nbytes, dtype=torch.uint8, pin_memory=True).numpy()
    walls = []
    for _ in range(5):
        t0 = time.perf_counter()
        np.copyto(pin, src)
        walls.append(time.perf_counter() - t0)
    copy_s = float(np.median(walls))
    log(f"ooc staging: np.copyto of {src.nbytes:,} bytes into pinned host "
        f"memory, median of 5: {1e3 * copy_s:.2f} ms = "
        f"{src.nbytes / copy_s / 1e9:.2f} GB/s (host clock)")
    out["copy_gb_s"] = src.nbytes / copy_s / 1e9
    del pin

    # ---- 2. ALS-WR through train(): resident, "device", "host" -------------
    base = get_preset("ml20m-als")
    cfg = base.replace(
        data=dataclasses.replace(base.data, test_fraction=0.05, seed=0,
                                 max_groups=g),
        als=dataclasses.replace(base.als, epochs=4), checkpoint_every=0,
        # the train RMSE's device COO (~230 MB) would sit in every run's
        # peak and hide what the residency moves
        log_train_rmse=False)
    ds = Dataset(n_users=n_users, n_items=n_items, train_u=tu, train_i=ti,
                 train_r=tr, test_u=su, test_i=si, test_r=sr,
                 mu=float(tr.mean()), chunk_len=32, rank_hint=rank)
    known = {(id(tu), id(ti), id(tr), n_users, n_items, 32, rank, g): ul,
             (id(ti), id(tu), id(tr), n_items, n_users, 32, rank, g): il}
    wire_known = {("packed", id(tu), id(ti), id(tr), n_users, n_items, rank,
                   g): upk,
                  ("packed", id(ti), id(tu), id(tr), n_items, n_users, rank,
                   g): ipk}
    test_coo = tuple(torch.as_tensor(x, device=dev)
                     for x in ds.padded_test()[:3]) + (len(sr),)
    cold_u = torch.as_tensor(np.setdiff1d(np.arange(n_users + 1),
                                          np.unique(tu)), device=dev)
    cold_i = torch.as_tensor(np.setdiff1d(np.arange(n_items + 1),
                                          np.unique(ti)), device=dev)

    def measured(fn):
        """fn() with the launch counts, ooc.staged_bytes and the peak
        device memory set to 0 just before it and read just after."""
        sync()
        ooc.staged_bytes = 0
        torch.cuda.reset_peak_memory_stats(dev)
        at_start = torch.cuda.memory_allocated(dev)
        reset_launches()
        res = fn()
        sync()
        launches = read_launches()
        count(launches)
        return res, {"launches": launches, "staged": ooc.staged_bytes,
                     "peak": torch.cuda.max_memory_allocated(dev) - at_start}

    runs = {}
    for name, c in (("resident", cfg),
                    ("device", cfg.replace(ooc=True,
                                           ooc_residency="device")),
                    ("host", cfg.replace(ooc=True, ooc_residency="host"))):
        run_dir = os.path.join(tmp, "ooc", name)
        prof = {}
        with shared_bucketed_layouts(known), shared_wire_builds(wire_known), \
                (profiled_call(loop, "als_epoch_ooc", 3,
                               f"OOC epoch 3 ({name})", prof)
                 if c.ooc else contextlib.nullcontext()):
            res, m = measured(lambda: train(c, dataset=ds,
                                                  out_dir=run_dir,
                                                  device=dev))
        ev = read_events(run_dir)
        m.update(res=res, prof=prof, events=ev, rmse=res.rmse_history,
                 s=[e["epoch_s"] for e in ev if "rmse_test" in e])
        runs[name] = m

    # ---- the partial pin: half of the wire on the card, the rest streamed
    du, di, pinned = ooc.wire_to_device(upk, ipk, budget_bytes=wire // 2,
                                        device=dev)
    n_pinned = sum(ooc.group_resident(x) for x in du + di)
    log(f"ooc partial pin: {pinned:,} of {wire:,} wire bytes under a budget "
        f"of {wire // 2:,}; {n_pinned} of {len(du) + len(di)} groups pinned")
    check(0 < n_pinned < len(du) + len(di), "ooc partial pin: some groups "
          "pinned, some streamed")

    def partial():
        st = zero_cold_entities(init_state(n_users, n_items, rank, seed=0,
                                           device=dev), tu, ti)
        rmse, s = [], []
        for ep in range(4):
            sync()
            t0 = time.time()
            if ep == 2:
                st, prof["device_ms"] = profile_breakdown(
                    lambda: ooc.als_epoch_ooc(st, du, di, lam,
                                              gather_bf16=True),
                    "OOC epoch 3 (partial)", prof["by_kernel"])
            else:
                st = ooc.als_epoch_ooc(st, du, di, lam, gather_bf16=True)
            sync()
            s.append(time.time() - t0)
            rmse.append(float(rmse_padded(st, *test_coo)))
        return st, rmse, s

    prof = {"by_kernel": {}}
    (st, rmse, s), m = measured(partial)
    m.update(res=None, state=st, prof=prof, rmse=rmse, s=s)
    runs["partial"] = m
    del du, di

    ref = runs["resident"]
    check(ref["launches"]["fused_gram"] > 0 and ref["launches"]["spd_solve"]
          > 0, "ooc: the resident train() ran fused_gram and K1")
    main_rest = kernel_shares(main["by_kernel"])["rest"]
    reserve = 80 * 10**9 - ooc.auto_wire_budget(
        n_users, n_items, rank, hbm_bytes=80 * 10**9, groups=(upk, ipk))
    for name in ("resident", "device", "host", "partial"):
        m = runs[name]
        state = m["state"] if name == "partial" else m["res"].state
        wall = (m["s"][1] + m["s"][3]) / 2
        line = (f"ooc {name}: rmse {[round(x, 6) for x in m['rmse']]}; "
                f"s/epoch 2-4 {[round(x, 4) for x in m['s'][1:]]} (3 "
                f"profiled), epochs 2 and 4 mean {wall:.4f}; peak device "
                f"memory {m['peak'] / 1e9:.3f} GB above the run's start")
        if name != "resident":
            check(m["rmse"] == ref["rmse"], f"ooc {name}: held-out rmse "
                  f"trajectory bit-equal to the resident train()'s")
            check(torch.equal(state.U, ref["res"].state.U) and torch.equal(
                state.V, ref["res"].state.V), f"ooc {name}: factors "
                f"bit-equal to the resident train()'s")
            check(m["launches"]["fused_gram"] > 0
                  and m["launches"]["spd_solve"] > 0,
                  f"ooc {name}: fused_gram and K1 launched")
            per_epoch = m["staged"] / 4
            sh = kernel_shares(m["prof"]["by_kernel"])
            dev_ms = m["prof"]["device_ms"]
            line += (f"; host-to-device {per_epoch / 1e6:.1f} MB/epoch = "
                     f"{per_epoch / wall / 1e9:.2f} GB/s of epoch wall; "
                     f"epoch 3: {dev_ms:.2f} ms of device time, fused_gram "
                     f"{sh['fused_gram']:.2f}, K1 {sh['K1']:.2f}, copies "
                     f"{sh['copies']:.2f}, rest {sh['rest']:.2f} (decode "
                     f"~{sh['rest'] - main_rest:.2f} ms = "
                     f"{(sh['rest'] - main_rest) / dev_ms:.3f} above the "
                     f"resident epoch's rest {main_rest:.2f}); device idle "
                     f"{1 - dev_ms / 1e3 / wall:.3f} of the unprofiled wall")
        log(line + f"; launches {m['launches']}")
        for what, v in zip(ANCHOR_RMSE, m["rmse"]):
            check(abs(v - what) <= RMSE_TOL, f"ooc {name}: rmse {v:.6f} "
                  f"within {RMSE_TOL} of {what}")
        check(bool((state.U[cold_u] == 0).all() and (state.V[cold_i]
                                                     == 0).all()),
              f"ooc {name}: trash and cold rows exactly 0")
    dev_ev = [e for e in runs["device"]["events"]
              if e.get("event") == "ooc_residency"]
    check(len(dev_ev) == 1 and dev_ev[0]["streamed_bytes"] == 0
          and dev_ev[0]["hbm_pinned_bytes"] > 0, "ooc device: everything "
          "pinned (the ooc_residency event)")
    check(runs["device"]["staged"] == 0 and runs["host"]["staged"] >= 4 * wire,
          "ooc: the pinned run streamed nothing, the host run its wire "
          "every epoch")
    log(f"ooc peaks: resident {ref['peak'] / 1e9:.3f} GB, device "
        f"{runs['device']['peak'] / 1e9:.3f}, host "
        f"{runs['host']['peak'] / 1e9:.3f}, partial "
        f"{runs['partial']['peak'] / 1e9:.3f}; auto_wire_budget's reserve "
        f"for this shape {reserve / 1e9:.3f} GB (1 GB of it margin)")
    check(runs["host"]["peak"] < ref["peak"], "ooc host: peak device memory "
          "below the resident run's")
    check(runs["host"]["peak"] <= reserve, "ooc host: peak within "
          "auto_wire_budget's reserve")
    out["runs"] = {k: {"rmse": v["rmse"], "s": v["s"], "peak": v["peak"],
                       "staged": v["staged"]} for k, v in runs.items()}
    resident_state = ref["res"].state
    del runs
    sync()

    # ---- 3. iALS, one epoch streamed, against the resident epoch -----------
    def start():
        return zero_cold_entities(init_state(n_users, n_items, rank, seed=0,
                                             device=dev), tu, ti)

    dul = device_bucketed(ul, torch.float32, dev)
    dil = device_bucketed(il, torch.float32, dev)
    t0 = time.time()
    want = ials_epoch_fn(dul, dil, IALS["lam"], IALS["alpha"], True)(start())
    sync()
    t_res = time.time() - t0
    del dul, dil
    t0 = time.time()
    got, m = measured(lambda: ooc.ials_epoch_ooc(
        start(), upk, ipk, IALS["lam"], IALS["alpha"], gather_bf16=True))
    t_ooc = time.time() - t0
    same = torch.equal(got.U, want.U) and torch.equal(got.V, want.V)
    log(f"ooc iALS epoch (host, bf16 gathers): bit-equal to the resident "
        f"bucketed iALS epoch: {same}; {t_ooc:.3f} s (resident "
        f"{t_res:.3f} s); launches {m['launches']}")
    check(same, "ooc iALS: bit-equal to the resident epoch")
    check(m["launches"]["row_gather"] > 0 and m["launches"]["spd_solve"] > 0,
          "ooc iALS: row_gather and K1 launched")
    del got, want

    # ---- 4. wire-order storage against the classic OOC run ------------------
    up, ip, wu, wi, t_ws = (b[k] for k in ("up", "ip", "wu", "wi", "t_ws"))

    def storage():
        U = ooc.wire_storage_init(up, rank, seed=0, device=dev)
        V = ooc.wire_storage_init(ip, rank, seed=0, entity_offset=n_users,
                                  device=dev)
        pu, pi = ooc.DeviceWirePlan(up), ooc.DeviceWirePlan(ip)
        for _ in range(2):
            U, V = ooc.als_epoch_wire(U, V, wu, wi, lam, pu, pi,
                                      gather_bf16=True)
        return U, V

    (U, V), m = measured(storage)
    classic = init_state(n_users, n_items, rank, seed=0, device=dev)
    for _ in range(2):
        classic = ooc.als_epoch_ooc(classic, upk, ipk, lam, gather_bf16=True)
    perm_u = torch.as_tensor(up.perm, device=dev).long()
    perm_i = torch.as_tensor(ip.perm, device=dev).long()
    du_max = float((U[perm_u] - classic.U[:n_users]).abs().max())
    dv_max = float((V[perm_i] - classic.V[:n_items]).abs().max())
    scale = float(classic.U.abs().max())
    ws_state = classic._replace(
        U=torch.cat([U[perm_u], classic.U[-1:]]),
        V=torch.cat([V[perm_i], classic.V[-1:]]))
    r_ws = float(rmse_padded(ws_state, *test_coo))
    r_cl = float(rmse_padded(classic, *test_coo))
    log(f"ooc wire-order storage: plans + builds {t_ws:.1f} s (host lane); 2 "
        f"epochs against the classic OOC run from the same init: max "
        f"|dU| {du_max:.3e}, |dV| {dv_max:.3e} (max |U| {scale:.3f}); "
        f"held-out rmse {r_ws:.6f} vs {r_cl:.6f}; launches {m['launches']}")
    check(m["launches"]["fused_gram"] > 0, "ooc wire storage: fused_gram "
          "launched")
    check(du_max <= 1e-2 * scale and dv_max <= 1e-2 * scale
          and abs(r_ws - r_cl) <= 1e-4, "ooc wire storage: rows match the "
          "classic run's (reduction order only)")
    del U, V, ws_state, wu, wi
    qu, qi, qr, _ = pad_coo(tu, ti, tr, n_users, n_items)
    train_coo = tuple(torch.as_tensor(x, device=dev) for x in (qu, qi, qr))
    want = float(rmse_padded(classic, *train_coo, nnz))
    got32 = ooc.rmse_wire(classic, upk, nnz, gather_bf16=False)
    got16 = ooc.rmse_wire(classic, upk, nnz)
    log(f"ooc rmse_wire on the training set: f32 {got32:.7f}, bf16 "
        f"{got16:.7f}; rmse_padded {want:.7f}")
    check(abs(got32 - want) <= 1e-5 and abs(got16 - want) <= 3e-3,
          "ooc rmse_wire agrees with rmse_padded")
    del train_coo, classic

    # ---- 5. stream SGD, four forms ------------------------------------------
    p = get_preset("ml1m-sgd").sgd
    host, comp, t_prep, t_comp = (b[k] for k in ("stream", "compact",
                                                 "t_prep", "t_comp"))
    del b
    flat = host._replace(**{
        k: torch.as_tensor(getattr(host, k), device=dev).long()
        if k in ("ul", "ib") else torch.as_tensor(getattr(host, k),
                                                  device=dev)
        for k in ("ul", "ib", "rb", "wu", "wi")})
    flat_b = sum(getattr(host, k).nbytes for k in ("ul", "ib", "rb", "wu",
                                                   "wi", "u_lo"))
    nb = host.ul.shape[0]
    orders = [np.random.default_rng(ep).permutation(nb) for ep in range(2)]
    trainer = StreamSGD(p.lam, p.lr, p.lr_decay, seed=0, grad_mode="capped")
    mu = float(tr.mean())
    forms = {}
    for name, data in (("flat resident", flat), ("flat streamed", host),
                       ("compact pinned", put_compact(comp, dev)),
                       ("compact streamed", comp)):
        def two():
            st = zero_cold_entities(init_state(
                n_users, n_items, p.rank, seed=0, mu=mu, device=dev), tu, ti)
            s = []
            for ep in range(2):
                sync()
                t0 = time.time()
                st = trainer.epoch(st, data, ep, order=orders[ep])
                sync()
                s.append(time.time() - t0)
            return st, s

        (st, s), m = measured(two)
        forms[name] = (st, s)
        log(f"ooc stream SGD {name}: s/epoch {[round(x, 3) for x in s]}; "
            f"launches {m['launches']}")
        check(m["launches"]["row_gather"] > 0,
              f"ooc stream SGD {name}: row_gather launched")
    first = forms["flat resident"][0]
    for name, (st, _) in forms.items():
        check(states_equal(st[:4], first[:4]), f"ooc stream SGD {name}: "
              f"bit-equal to the flat resident epochs")
    log(f"ooc stream SGD: {nb} batches of {p.batch_size} (rank {p.rank}, "
        f"capped); prepare_stream_sgd {t_prep:.1f} s, compact_from_stream "
        f"{t_comp:.1f} s (host lane); compact wire "
        f"{comp.nbytes / host.n_real:.2f}"
        f" B/rating against the flat stream's {flat_b / host.n_real:.2f}; "
        f"the four forms bit-equal after 2 epochs; on {smi}")
    out["sgd"] = {k: v[1] for k, v in forms.items()}
    del forms, flat, comp, host, first

    # ---- 6. the command line: train --ooc on the CLI phase's store ----------
    if cli is not None:
        import io

        run_dir = os.path.join(tmp, "ooc-cli")
        def run_cli():
            with contextlib.redirect_stdout(io.StringIO()):
                cli_main(["train", "--ooc", "--preset", "ml20m-als",
                          "--config", cli["cfg_file"], "--store",
                          cli["store"], "--epochs", "4", "--out", run_dir])

        t0 = time.time()
        _, m = measured(run_cli)
        got = [e["rmse_test"] for e in read_events(
            os.path.join(run_dir, "ml20m-als")) if "rmse_test" in e]
        want = [round(x, 6) for x in ref["rmse"]]
        log(f"ooc cli train --ooc: {time.time() - t0:.1f} s; rmse {got}; "
            f"in-process resident train() {want}; launches {m['launches']}")
        check(got == want, "ooc cli train --ooc: rmse equal to the resident "
              "train()'s")
    del resident_state
    log(f"ooc phase kernel launches {out['launches']}; on {smi}")
    return out


def ml1m_sgd_config(method: str, out_dir: str):
    """The ``ml1m-sgd`` preset on a synthetic set of the ML-1M shape."""
    import dataclasses

    from ycnr_tpu_torch.config import get_preset

    cfg = get_preset("ml1m-sgd")
    return cfg.replace(
        data=dataclasses.replace(cfg.data, source="synthetic", true_rank=8,
                                 noise=0.3, seed=0),
        sgd=dataclasses.replace(cfg.sgd, method=method),
        out_dir=out_dir, name=f"ml1m-sgd-{method}", checkpoint_every=10)


def read_events(out_dir: str) -> list:
    with open(os.path.join(out_dir, "metrics.jsonl")) as f:
        return [json.loads(x) for x in f if x.strip()]


def check_trash_rows(state, what: str):
    for name, x in zip(("U", "V", "bu", "bi"), state[:4]):
        check(bool((x[-1] == 0).all()), f"{what}: trash row of {name} is 0")
        check(bool(torch.isfinite(x).all()), f"{what}: {name} is finite")


def states_equal(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(a, b))


def epoch_profile(run_epoch, what: str, smi: str) -> dict:
    """One epoch under the profiler (device time by kernel) and three
    unprofiled epochs by the host clock: the idle share is what the device
    time leaves of their median wall. The wall is a host-clock reading and
    moves from call to call; a device time above it shows as a negative
    share."""
    walls = []
    for _ in range(3):
        sync()
        t0 = time.time()
        run_epoch()
        sync()
        walls.append(time.time() - t0)
    wall = float(np.median(walls))
    _, dev_ms = profile_breakdown(run_epoch, what)
    idle = 1 - dev_ms / 1e3 / wall
    log(f"{what}: unprofiled walls {[round(w, 4) for w in walls]} s, median "
        f"{wall:.4f}; {dev_ms:.2f} ms of device time; device idle "
        f"{idle:.3f} of the median wall; on {smi}")
    return {"s": wall, "device_ms": dev_ms, "idle": idle}


def phase_sgd(dev, ds, tmp: str, smi: str) -> dict:
    """Biased SGD, batched and stream, at the ``ml1m-sgd`` preset's width
    through ``train()``."""
    import dataclasses

    from ycnr_tpu_torch.models.base import (init_state, to_numpy,
                                            zero_cold_entities)
    from ycnr_tpu_torch.models.sgd import (BiasedSGD, prepare_sgd_data,
                                           sgd_epoch)
    from ycnr_tpu_torch.models.sgd_stream import (StreamSGD,
                                                  prepare_stream_sgd)
    from ycnr_tpu_torch.oracle import sgd_epoch_batched
    from ycnr_tpu_torch.train.loop import train

    cfg = ml1m_sgd_config("batched", tmp)
    p = cfg.sgd
    n_users, n_items = ds.n_users, ds.n_items

    def start():
        return zero_cold_entities(
            init_state(n_users, n_items, p.rank, seed=cfg.seed, mu=ds.mu,
                       device=dev), ds.train_u, ds.train_i)

    # ---- one batched epoch, explicit perm, against the float64 oracle ---
    data = prepare_sgd_data(ds.train_u, ds.train_i, ds.train_r, p.batch_size,
                            n_users, n_items, device=dev)
    n_pad = data.u.shape[0]
    perm = np.random.default_rng(3).permutation(n_pad)
    st0 = start()
    # copies: sgd_epoch updates the state in place
    U0, V0, bu0, bi0 = (x.copy() for x in to_numpy(st0)[:4])
    reset_launches()
    got = sgd_epoch(st0, data, perm, p.lam, p.lr, p.batch_size, "sum")
    sync()
    check(read_launches()["row_gather"] == 2 * (n_pad // p.batch_size),
          "row_gather launched twice a batch in sgd_epoch")
    # the oracle has no mask: it sees the padded COO and moves its trash
    # rows, which no real rating reads; the real rows are compared
    want = sgd_epoch_batched(U0, V0, bu0, bi0, ds.mu, data.u.cpu().numpy(),
                             data.i.cpu().numpy(), data.r.cpu().numpy(),
                             p.lam, p.lr, p.batch_size, perm)
    err = max(float(np.abs(g[:-1] - w[:-1]).max())
              for g, w in zip(to_numpy(got)[:4], want))
    log(f"sgd_epoch ({n_pad // p.batch_size} batches of {p.batch_size}, "
        f"rank {p.rank}) against the float64 oracle: max |diff| {err:.3e} "
        f"(limit {ORACLE_ATOL})")
    check(err <= ORACLE_ATOL, "sgd_epoch within ORACLE_ATOL of the oracle")
    check_trash_rows(got, "sgd_epoch")

    out = {}
    for method in ("batched", "stream"):
        cfg = ml1m_sgd_config(method, tmp)
        run_dir = os.path.join(tmp, cfg.name)
        sync()
        reset_launches()
        res = train(cfg, ds)  # device=None: the card
        launches = read_launches()
        check(res.state.U.is_cuda, f"SGD {method}: trained on the card")
        check(launches["row_gather"] > 0,
              f"row_gather launched on the SGD {method} path")
        hist = res.rmse_history
        ev = [e for e in read_events(run_dir) if "rmse_test" in e]
        s_epoch = float(np.median([e["epoch_s"] for e in ev[1:]]))
        log(f"SGD {method} through train(): {len(hist)} epochs, held-out "
            f"rmse {hist[0]:.6f} -> {hist[-1]:.6f} (train "
            f"{ev[0]['rmse_train']:.6f} -> {ev[-1]['rmse_train']:.6f}), "
            f"median s/epoch (epochs 2-20) {s_epoch:.4f}, first epoch "
            f"{ev[0]['epoch_s']:.4f}; row_gather launches "
            f"{launches['row_gather']}; on {smi}")
        check(len(hist) == p.epochs, f"SGD {method}: every epoch ran")
        check(hist[-1] < hist[0], f"SGD {method}: held-out rmse falls")
        check_trash_rows(res.state, f"SGD {method}")
        check(float(res.state.mu) == np.float32(ds.mu), "SGD: mu = ds.mu")
        # resume: 10 epochs, then the rest from the checkpoint
        half = cfg.replace(sgd=dataclasses.replace(cfg.sgd, epochs=10),
                           name=cfg.name + "-resumed")
        train(half, ds)
        back = train(cfg.replace(name=half.name), ds,
                     resume=os.path.join(tmp, half.name, "ckpt"))
        same = states_equal(back.state, res.state)
        log(f"SGD {method}: resumed from the epoch-10 checkpoint, final "
            f"factors bit-equal to the uninterrupted run (itself a second "
            f"run from the same seed): {same}; history equal: "
            f"{back.rmse_history[10:] == hist[10:]}")
        check(same, f"SGD {method}: resumed run bit-equal")
        check(len(back.rmse_history) == p.epochs,
              f"SGD {method}: the history crossed the checkpoint")
        out[method] = {"launches": launches["row_gather"], "rmse": hist,
                       "s_epoch": s_epoch, "state": res.state}

    band = abs(out["stream"]["rmse"][-1] - out["batched"]["rmse"][-1])
    log(f"SGD stream vs batched, final held-out rmse: |diff| {band:.4f} "
        f"(band {STREAM_BAND})")
    check(band <= STREAM_BAND, "stream SGD ends within the band of batched")

    # ---- one epoch twice from one state, and where its time goes --------
    sdata, _ = prepare_stream_sgd(ds.train_u, ds.train_i, ds.train_r,
                                  p.batch_size, n_users, n_items,
                                  seed=cfg.seed, grad_mode="capped",
                                  device=dev)
    trainers = {
        "batched": (BiasedSGD(p.lam, p.lr, p.lr_decay, p.batch_size,
                              seed=cfg.seed, grad_mode=p.grad_mode), data),
        "stream": (StreamSGD(p.lam, p.lr, p.lr_decay, seed=cfg.seed,
                             grad_mode="capped"), sdata)}
    for method, (trainer, d) in trainers.items():
        a = trainer.epoch(start(), d, 1)
        b = trainer.epoch(start(), d, 1)
        sync()
        check(states_equal(a, b), f"SGD {method}: one epoch twice bit-equal")
        st = start()
        out[method]["profile"] = epoch_profile(
            lambda: trainer.epoch(st, d, 2), f"one SGD {method} epoch", smi)
    log(f"SGD: one epoch of each trainer twice from one state: U, V, bu, bi "
        f"bit-equal; stream: {sdata.ul.shape[0]} batches, tile {sdata.tile}")
    out["stream_data"] = sdata
    out["batched_data"] = data
    return out


def phase_gather_narrow(dev, sgd: dict, bpr_data, bpr_rank: int,
                        smi: str) -> dict:
    """row_gather at the row widths the SGD and BPR epochs give it (64-,
    68- and 136-byte rows: its 16-, 4- and 8-byte paths), bit-equal to
    table[idx], beside table[idx] and the bound, three ways:

    * cold, on the trainers' own table shapes and first index batches: the
      calls rotate over enough copies of the inputs that each finds its own
      evicted from the L2, as the bound (every byte once at the
      device-memory rate) counts them. This is the figure of the kernels
      line;
    * warm, the same calls on one copy: the epochs find these tables (0.4
      to 19 MB, read every batch) in the L2. At m = 8,192 both are a
      launch's latency, not the path's bandwidth;
    * large and cold, 1,048,576 rows from a 480,189-row table of the same
      width: enough bytes that the time is the path's bandwidth."""
    from ycnr_tpu_torch.ops.row_gather import (row_gather_cuda,
                                               row_gather_reference)
    from ycnr_tpu_torch.tools.probe_gather import cold_sets, graph_ms

    rng = np.random.default_rng(21)
    sd, bd = sgd["stream_data"], sgd["batched_data"]
    st = sgd["batched"]["state"]
    k = st.rank
    B = sd.ul.shape[1]
    lo = int(sd.u_lo[1]) | 1  # an odd start: the tile's base is 4-byte aligned
    lo = min(lo, st.n_users + 1 - sd.tile)

    def table(rows, cols):
        return torch.as_tensor(rng.standard_normal((rows, cols),
                                                   dtype=np.float32),
                               device=dev)

    def timed(T, idx):
        """(bound, cold ms of kernel / plain / table[idx], warm kernel ms)"""
        row_b = T.shape[1] * T.element_size()
        nbytes = (idx.numel() * (idx.element_size() + row_b)
                  + int(torch.unique(idx).numel()) * row_b)
        bnd = bound_ms(nbytes, 0, PEAK_F32)
        sets = cold_sets((T, idx), nbytes, 512)
        iters = max(GATHER_ITERS, len(sets))

        def cold_ms(fn):
            return graph_ms(fn, iters, sets=sets)

        plain = cold_ms(row_gather_reference)
        ms = cold_ms(row_gather_cuda)
        lib = cold_ms(lambda t, i: t[i])
        ms = min(ms, cold_ms(row_gather_cuda))
        warm = graph_ms(lambda: row_gather_cuda(T, idx), GATHER_ITERS)
        return bnd, ms, plain, lib, warm, len(sets)

    Ue = table(st.n_users + 1, k + 1)
    n_bu, n_bi = bpr_data.wu.shape[0], bpr_data.wi.shape[0]
    Bb = 65_536
    big_n, big_m = GATHER_TABLES[1], 1 << 20
    big_idx = torch.as_tensor(rng.integers(0, big_n, big_m), device=dev)
    cases = [
        ("w64", "batched SGD U[ub]", table(st.n_users + 1, k), bd.u[:B]),
        ("w64", "batched SGD V[ib]", table(st.n_items + 1, k), bd.i[:B]),
        ("w68", f"stream SGD tile Ue[{lo}:{lo}+{sd.tile}][ulb]",
         Ue[lo:lo + sd.tile], sd.ul[1]),
        ("w68", "stream SGD Ve[ibb]", table(st.n_items + 1, k + 1),
         sd.ib[1]),
        ("w136", "BPR Uf[ub]", table(n_bu, bpr_rank + 2), bpr_data.u[:Bb]),
        ("w136", "BPR Vf[ib]", table(n_bi, bpr_rank + 2), bpr_data.i[:Bb]),
        ("w64-large", "large", table(big_n, k), big_idx),
        ("w68-large", "large, from an odd row",
         table(big_n + 1, k + 1)[1:], big_idx),
        ("w136-large", "large", table(big_n, bpr_rank + 2), big_idx),
    ]
    out = {}
    for key, what, T, idx in cases:
        idx = idx.contiguous()
        got = row_gather_cuda(T, idx)
        want = row_gather_reference(T, idx)
        sync()
        row_b = T.shape[1] * T.element_size()
        check(row_b == int(key.split("-")[0][1:]),
              f"{what}: rows of {row_b} bytes")
        check(torch.equal(got, want), f"row_gather {what}: bit-equal to "
              f"table[idx]")
        del got, want
        bnd, ms, plain_ms, lib_ms, warm_ms, n_sets = timed(T, idx)
        align = 16 if (T.data_ptr() | row_b) % 16 == 0 else (
            8 if (T.data_ptr() | row_b) % 8 == 0 else 4)
        log(f"gather {what}: [{T.shape[0]}, {T.shape[1]}] f32 rows of "
            f"{row_b} bytes ({align}-byte path), m={idx.numel()} int64: "
            f"bit-equal; cold L2 ({n_sets} copies in turn): kernel "
            f"{ms:.4f} ms, plain {plain_ms:.4f} ms, table[idx] "
            f"{lib_ms:.4f} ms, bound {bnd[0]:.4f} ms ({bnd[0] / ms:.3f} of "
            f"the bound); warm (one copy, in the L2 where it fits): kernel "
            f"{warm_ms:.4f} ms; on {smi}")
        # per width, the larger table (the user side) is the one reported
        out.setdefault(key, dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                                 bound_ms=bnd[0], bound_by=bnd[1],
                                 warm_ms=warm_ms, max_abs_err=0.0, what=what))
    return out


def phase_bpr(dev, ds1m, ds20m, tmp: str, smi: str) -> dict:
    """BPR at the ``ml20m-bpr`` preset's width through ``train()``, after
    one epoch of each shuffle mode against the oracle on the ML-1M-shaped
    set."""
    import dataclasses

    from ycnr_tpu_torch.config import get_preset
    from ycnr_tpu_torch.eval.ranking import hit_rate_at_n
    from ycnr_tpu_torch.models.base import (init_state, to_numpy,
                                            zero_cold_entities)
    from ycnr_tpu_torch.models.bpr import (BPRTrainer, bpr_epoch,
                                           bpr_epoch_batches,
                                           prepare_bpr_data)
    from ycnr_tpu_torch.oracle import bpr_epoch_batched
    from ycnr_tpu_torch.train.loop import train

    cfg = get_preset("ml20m-bpr")
    # measure_serving through the fused scorer: train() ends with one
    # timed top-10 pass for every user through K2
    cfg = cfg.replace(bpr=dataclasses.replace(cfg.bpr, epochs=2),
                      out_dir=tmp, checkpoint_every=0, measure_serving=True,
                      scorer="fused")
    p = cfg.bpr
    B = p.batch_size

    # ---- the oracle, ML-1M shape, whole batches (it knows no padding) ---
    n = (len(ds1m.train_u) // B) * B
    u, i = ds1m.train_u[:n], ds1m.train_i[:n]
    rng = np.random.default_rng(5)
    negs = rng.integers(0, ds1m.n_items, n).astype(np.int32)
    for shuffle in ("rows", "batches"):
        data = prepare_bpr_data(
            u, i, B, ds1m.n_users, ds1m.n_items, device=dev,
            shuffle_rows_seed=0 if shuffle == "batches" else None)
        st0 = init_state(ds1m.n_users, ds1m.n_items, p.rank, seed=0,
                         device=dev)
        U0, V0, bu0, bi0, _ = to_numpy(st0)
        reset_launches()
        if shuffle == "rows":
            perm = rng.permutation(n)
            got = bpr_epoch(st0, data, perm, negs, p.lam, p.lr, B,
                            p.grad_mode)
            pu, pi = u[perm], i[perm]
        else:
            border = rng.permutation(n // B)
            got = bpr_epoch_batches(st0, data, border, negs, p.lam, p.lr, B,
                                    p.grad_mode)
            rows = (border[:, None] * B + np.arange(B)[None, :]).reshape(-1)
            pu = data.u.cpu().numpy()[rows]
            pi = data.i.cpu().numpy()[rows]
        sync()
        check(read_launches()["row_gather"] == 3 * (n // B),
              "row_gather launched three times a batch in the BPR epoch")
        t0 = time.time()
        oU, oV, obi = bpr_epoch_batched(U0[:-1], V0[:-1], bi0[:-1], pu, pi,
                                        negs, p.lam, p.lr, B, p.grad_mode)
        gU, gV, gbu, gbi, _ = to_numpy(got)
        err = max(float(np.abs(gU[:-1] - oU).max()),
                  float(np.abs(gV[:-1] - oV).max()),
                  float(np.abs(gbi[:-1] - obi).max()))
        log(f"BPR epoch (shuffle={shuffle!r}, {p.grad_mode}, {n // B} "
            f"batches of {B}, rank {p.rank}) against the float64 oracle "
            f"({time.time() - t0:.1f} s on the host): max |diff| {err:.3e} "
            f"(limit {ORACLE_ATOL})")
        check(err <= ORACLE_ATOL, f"BPR {shuffle} epoch within ORACLE_ATOL")
        check(np.array_equal(gbu, bu0), "BPR leaves bu alone")
        check_trash_rows(got, f"BPR {shuffle} epoch")
        del data, got, st0

    # ---- ml20m-bpr through train() ---------------------------------------
    def start():
        return zero_cold_entities(
            init_state(ds20m.n_users, ds20m.n_items, p.rank, seed=cfg.seed,
                       device=dev), ds20m.train_u, ds20m.train_i)

    def hit(state):
        return hit_rate_at_n(state, ds20m.train_u, ds20m.train_i,
                             ds20m.test_u, ds20m.test_i, n=cfg.topn,
                             max_users=512)

    st0 = start()
    hr0 = hit(st0)
    sync()
    reset_launches()
    t0 = time.time()
    res = train(cfg, ds20m)
    wall = time.time() - t0
    launches = read_launches()
    check(res.state.U.is_cuda, "BPR: trained on the card")
    check(launches["row_gather"] > 0, "row_gather launched on the BPR path")
    events = read_events(os.path.join(tmp, cfg.name))
    ev = [e for e in events if e.get("algo") == "bpr"]
    ranking = [e for e in events if e.get("event") == "ranking"]
    hr = [e["hit_rate"] for e in ev]
    log(f"BPR through train(): {len(ev)} epochs in {wall:.1f} s wall (data "
        f"preparation, evaluation and the serving measurement included; "
        f"seconds into the run at each event: "
        f"{[(e.get('event', 'epoch'), e['t']) for e in events]}), epoch_s "
        f"{[e['epoch_s'] for e in ev]}, hit-rate@{cfg.topn} {hr0:.4f} at "
        f"the start -> {hr}; row_gather launches {launches['row_gather']}; "
        f"ranking {ranking[-1] if ranking else None}; on {smi}")
    check(len(ev) == p.epochs and len(res.rmse_history) == p.epochs,
          "BPR: every epoch ran")
    check(hr[-1] > hr0, "BPR: hit-rate after training above the start's")
    check(abs((1 - res.rmse_history[-1]) - hr[-1]) < 1e-4,
          "BPR: the history is 1 - hit rate")
    check(len(ranking) == 1 and all(
        np.isfinite(v) for k, v in ranking[0].items() if k != "event"),
        "BPR: one final ranking event with finite values")
    check(torch.equal(res.state.bu, st0.bu) and float(res.state.mu) == 0.0,
          "BPR leaves bu and mu alone")
    check_trash_rows(res.state, "BPR")
    serving = [e for e in events if e.get("event") == "serving"]
    log(f"train(measure_serving=True, scorer='fused'): {serving}; K2 "
        f"launches {launches['fused_scores']}; on {smi}")
    check(len(serving) == 1 and serving[0]["scorer"] == "fused"
          and serving[0]["users"] == int(np.unique(ds20m.train_u).size)
          and serving[0]["recs_per_s"] > 0,
          "train() timed its serving pass through the fused scorer")
    check(launches["fused_scores"] > 0,
          "K2 launched on train()'s serving measurement")

    data = prepare_bpr_data(ds20m.train_u, ds20m.train_i, B, ds20m.n_users,
                            ds20m.n_items, shuffle_rows_seed=0, device=dev)
    trainer = BPRTrainer(p.lam, p.lr, p.lr_decay, B, seed=cfg.seed,
                         grad_mode=p.grad_mode, shuffle=p.shuffle)
    a = trainer.epoch(start(), data, 1)
    b = trainer.epoch(start(), data, 1)
    sync()
    same = states_equal(a, b)
    log(f"BPR: one epoch twice from one state: U, V, bu, bi bit-equal: "
        f"{same}")
    check(same, "BPR: one epoch twice bit-equal")
    del a, b
    prof = epoch_profile(lambda: trainer.epoch(st0, data, 2),
                         "one BPR epoch", smi)
    return {"launches": launches["row_gather"],
            "k2_launches": launches["fused_scores"], "hit_rate": [hr0] + hr,
            "epoch_s": [e["epoch_s"] for e in ev], "profile": prof,
            "data": data, "rank": p.rank}


def phase_online(state, tu, ti, tr, smi: str) -> dict:
    """The in-process serving layer's online calls on the trained
    main-path state (a copy of U: add_ratings writes rows in place)."""
    from ycnr_tpu_torch.eval.recommend import top_popular
    from ycnr_tpu_torch.serve.engine import Recommender

    lam = MAIN["lam"]
    state = state._replace(U=state.U.clone())
    rec = Recommender(state, tu, ti, train_r=tr)
    rng = np.random.default_rng(9)
    users = rng.choice(np.unique(tu), 8, replace=False)
    V64 = state.V.double().cpu().numpy()
    bi64 = state.bi.double().cpu().numpy()
    worst = 0.0
    sync()
    reset_launches()
    t0 = time.time()
    for uid in users:
        uid = int(uid)
        new = rec.recommend(uid, 10)[:3]
        before = state.U[uid].clone()
        rec.add_ratings(uid, new, [5.0, 4.5, 4.0], lam=lam)
        items, ratings = rec._user_items_ratings(uid)
        F = V64[items]
        resid = ratings.astype(np.float64) - (float(state.mu) + bi64[items])
        A = F.T @ F + lam * len(items) * np.eye(F.shape[1])
        want = np.linalg.solve(A, F.T @ resid)
        row = state.U[uid].double().cpu().numpy()
        worst = max(worst, float(np.abs(row - want).max()
                                 / np.abs(want).max()))
        check(not torch.equal(before, state.U[uid]),
              f"add_ratings: user {uid}'s row was written in place")
        served = rec.recommend(uid, 10)
        check(len(served) == 10 and not set(new.tolist())
              & set(served.tolist()),
              f"add_ratings: user {uid} is served no newly rated item")
    sync()
    add_s = (time.time() - t0) / len(users)
    launches = read_launches()
    log(f"add_ratings for {len(users)} users ({1e3 * add_s:.1f} ms each, "
        f"the two recommend() calls included): rows within {worst:.3e} "
        f"relative of a float64 solve (limit {ONLINE_RTOL}); kernel "
        f"launches {launches}")
    check(worst <= ONLINE_RTOL, "add_ratings rows within ONLINE_RTOL")
    check(launches["spd_solve"] >= len(users), "K1 launched on add_ratings")
    check(launches["row_gather"] >= len(users),
          "row_gather launched on add_ratings")
    check(rec.pending_count() == 3 * len(users), "pending log holds them")
    t0 = time.time()
    rec.compact()
    log(f"compact(): {time.time() - t0:.2f} s on the host for "
        f"{len(rec.train_u):,} ratings")
    check(rec.pending_count() == 0 and len(rec.train_u) == len(tu)
          + 3 * len(users), "compact folded the pending log into the base")
    uid = int(users[0])
    check(len(set(rec.recommend(uid, 10).tolist())
              & set(rec._user_items(uid).tolist())) == 0,
          "after compact: no rated item served")
    pop = rec.popular(10)
    check(np.array_equal(pop, top_popular(rec.train_i, state.n_items, 10))
          and len(pop) == 10, "popular(10) is the top of the item counts")

    # similar / precompute_similar against a float64 cosine on the host
    reset_launches()
    t0 = time.time()
    n_sim = rec.precompute_similar(10, "cosine", chunk=1024)
    sync()
    sim_s = time.time() - t0
    live = np.flatnonzero((V64[:-1] != 0).any(1))
    check(n_sim == len(live), "precompute_similar cached every live item")
    check(read_launches()["row_gather"] == -(-len(live) // 1024),
          "row_gather launched once a chunk in precompute_similar")
    Vn = V64[:-1] / np.maximum(np.linalg.norm(V64[:-1], axis=1),
                               1e-12)[:, None]
    chunk = live[:1024]
    cos = Vn[chunk] @ Vn.T
    cos[:, np.setdiff1d(np.arange(state.n_items), live)] = -np.inf
    cos[np.arange(len(chunk)), chunk] = -np.inf
    tenth = -np.partition(-cos, 9, axis=1)[:, 9]
    bad = 0
    for j, iid in enumerate(chunk):
        got = rec.cache.get(("sim", int(iid), 10, "cosine"))
        ok = (got is not None and len(got) == 10 and int(iid) not in got
              and bool((cos[j, got] >= tenth[j] - SIM_TOL).all())
              and bool((np.diff(cos[j, got]) <= SIM_TOL).all()))
        bad += not ok
    one = rec.similar(int(chunk[0]), 10)
    log(f"precompute_similar: {n_sim:,} items in {sim_s:.2f} s; first "
        f"{len(chunk)} held to a float64 cosine on the host (every pick "
        f"within {SIM_TOL} of the true 10th, in order): {bad} wrong")
    check(bad == 0, "similar lists equal the float64 cosine's up to ties")
    check(np.array_equal(one, rec.cache.get(("sim", int(chunk[0]), 10,
                                             "cosine"))),
          "similar() serves the cached list")
    seven = rec.similar(int(chunk[1]), 7)  # not cached: computed here
    seventh = -np.partition(-cos[1], 6)[6]
    check(len(seven) == 7 and bool((cos[1, seven] >= seventh - SIM_TOL).all())
          and read_launches()["row_gather"] == -(-len(live) // 1024) + 1,
          "similar(): the float64 cosine's top 7, through row_gather")

    reset_launches()
    mine = rng.choice(live, 20, replace=False)
    cold = rec.recommend_cold(mine, rng.uniform(1, 5, 20), n=10, lam=lam)
    sync()
    cl = read_launches()
    check(len(cold) == 10 and not set(cold.tolist()) & set(mine.tolist()),
          "recommend_cold: 10 items, none of the user's own")
    check(cl["spd_solve"] > 0 and cl["row_gather"] > 0,
          "K1 and row_gather launched on recommend_cold")
    log(f"recommend_cold: 10 items from 20 ratings, none of them served; "
        f"launches {cl}; on {smi}")
    return {"add": launches, "cold": cl}


# ---- the mesh (parallel/): sharded ALS-WR on torch.distributed -------------
MESH_EPOCHS = 4
# the sharded run against the resident main path from the same start: the
# item Grams are summed in another order (all-reduce of per-rank partials)
MESH_RMSE_TOL = 1e-4
# a sharded run's factors against the resident blocked run's, as a share of
# the largest |entry|: the item Grams sum in another order, which a bf16
# gather can turn into a step of one bf16 ulp (2^-8) of a row; the
# wire-order storage check of the ooc phase holds the same kind of
# difference to the same bound
MESH_FACTOR_TOL = 1e-2
MESH_SAMPLE = 4096  # users whose sharded lists are held to recommend_users


def mesh_rank(mesh, tu, ti, tr, su, si, sr, ref_U, ref_V, epochs: int,
              host_data: str, serve: bool = False, dual: str = "",
              profile: bool = True) -> dict:
    """One rank process of the mesh phase (``spawn_ranks`` runs it):
    ALS-WR rank 64, lam 0.05, bf16 gathers, gram_psum, from the main path's
    start (``init_state(seed=0)``, cold rows zeroed as ``train()`` does),
    on the ML-20M arrays (memory-mapped .npy) and the sharded data that
    ``build_sharded_data`` made for this world on the host lane
    (``host_data``, a pickle; ``dual``: ``build_dual_sharded_data``'s).
    Per epoch: seconds (device
    synchronized), held-out RMSE, bytes through the collectives and their
    host time (``Mesh.timed``); with ``profile``, epoch 3 on rank 0 under
    ``torch.profiler`` (device time by kernel). With ``serve``: ``sharded_recommend_all``
    fused (K2 on every rank) and exact, held on rank 0 to the single-GPU
    ``recommend_users`` on the gathered state for MESH_SAMPLE users. With
    ``dual``: one item_sharded epoch from the same start. Every rank's
    kernel launches and peak device memory are gathered; rank 0 returns
    the lot. Rank 0 also holds the gathered factors to the resident
    blocked run's (``ref_U``, ``ref_V``, from ``mesh_reference``): the
    largest |difference| over the largest |entry|, and the largest over
    rows of |row difference| / |row|."""
    import ycnr_tpu_torch
    from ycnr_tpu_torch.eval.recommend import build_rated_bits, \
        recommend_users
    from ycnr_tpu_torch.models.base import init_state, zero_cold_entities
    from ycnr_tpu_torch.parallel import shard as sh
    from ycnr_tpu_torch.parallel.mesh import collective_check

    ycnr_tpu_torch.full_precision_matmul()
    dev = mesh.device
    out = {"collectives": collective_check(mesh), "world": mesh.world,
           "backend": mesh.backend}
    n_users, n_items, rank, lam = (MAIN[k] for k in ("n_users", "n_items",
                                                     "rank", "lam"))
    t0 = time.time()
    with open(host_data, "rb") as f:  # build_sharded_data's, made on the
        host, meta, out["build_s"] = pickle.load(f)  # host lane
    out["load_s"] = time.time() - t0
    data = sh.put_shard(host, mesh)
    del host

    def start():
        return zero_cold_entities(init_state(n_users, n_items, rank, seed=0,
                                             device=dev), tu, ti)

    st = sh.scatter_state(start(), meta, mesh)
    torch.cuda.reset_peak_memory_stats(dev)
    mesh.timed = True
    reset_launches()
    out.update(rmse=[], s=[], bytes=[], coll_s=[])
    for ep in range(epochs):
        b0, c0 = mesh.bytes_moved, mesh.collective_s
        sync()
        t0 = time.time()
        if ep == 2 and mesh.rank == 0 and profile:  # epoch 3, rank 0
            st, out["dev_ms_epoch3"] = profile_breakdown(
                lambda: sh.sharded_als_epoch(mesh, st, data, lam,
                                             gather_bf16=True),
                f"sharded epoch 3, rank 0 of {mesh.world}")
        else:
            st = sh.sharded_als_epoch(mesh, st, data, lam, gather_bf16=True)
        sync()
        out["s"].append(time.time() - t0)
        out["bytes"].append(mesh.bytes_moved - b0)
        out["coll_s"].append(mesh.collective_s - c0)
        out["rmse"].append(sh.sharded_rmse(mesh, st, data, meta.test_n))
    trash = bool((st.U[-1] == 0).all()) and bool((st.V[-1] == 0).all())
    train_ln = read_launches()
    g = sh.gather_state(st, meta, mesh)
    if mesh.rank == 0:
        out["factor_diff"] = {
            name: factor_diff(F[:-1], torch.as_tensor(np.array(ref),
                                                      device=dev))
            for name, F, ref in (("U", g.U, ref_U), ("V", g.V, ref_V))}
    if serve:
        bits = build_rated_bits(meta.user_layout_host, n_items)
        reset_launches()
        sync()
        t0 = time.time()
        uf, idf, _ = sh.sharded_recommend_all(mesh, st, data, meta, 10, bits,
                                              method="fused")
        sync()
        out["serve_fused_s"] = time.time() - t0
        serve_ln = read_launches()
        ue, ide, sce = sh.sharded_recommend_all(mesh, st, data, meta, 10,
                                                bits, method="exact")
        if mesh.rank == 0:
            out.update(mesh_serve_check(g, tu, ti, uf, idf, ue, ide, sce))
    if dual:
        from ycnr_tpu_torch.parallel import dual as du

        with open(dual, "rb") as f:  # build_dual_sharded_data's
            host, dmeta, out["dual_build_s"] = pickle.load(f)
        ddata = sh.put_shard(host, mesh)
        del host
        dst = du.dual_scatter_state(start(), dmeta, mesh)
        b0, c0 = mesh.bytes_moved, mesh.collective_s
        sync()
        t0 = time.time()
        dst = du.dual_als_epoch(mesh, dst, ddata, lam, gather_bf16=True)
        sync()
        out["dual"] = {"s": time.time() - t0,
                       "bytes": mesh.bytes_moved - b0,
                       "coll_s": mesh.collective_s - c0,
                       "rmse": du.dual_rmse(mesh, dst, ddata, dmeta.test_n),
                       "trash": bool((dst.U[-1] == 0).all())
                       and bool((dst.V[-1] == 0).all())}
    per = torch.tensor([train_ln["spd_solve"], train_ln["row_gather"],
                        serve_ln["fused_scores"] if serve else 0,
                        torch.cuda.max_memory_allocated(dev), float(trash),
                        train_ln["spd_solve tiled"]],
                       dtype=torch.float64, device=dev)
    out["per_rank"] = [x.tolist() for x in mesh.all_gather(per)]
    return out


def factor_diff(F, ref) -> dict:
    """F against ref (real rows only): the largest |F - ref| over the
    largest |ref|, and the largest over rows with a nonzero ref row of
    |F_row - ref_row| / |ref_row| (2-norms)."""
    d = (F - ref).double()
    ref = ref.double()
    norm = ref.norm(dim=1)
    live = norm > 0
    return {"scale": float(d.abs().max() / ref.abs().max()),
            "row": float((d.norm(dim=1)[live] / norm[live]).max())}


def mesh_reference(dev, tu, ti, su, si, sr, lays, tmp: str) -> dict:
    """The resident run the mesh is held to: ALS-WR on one device over the
    host blocked layouts ``lays`` (user, item: the layout kind the sharded
    path runs; the main path runs the bucketed one), bf16 gathers,
    ``solve_block`` a block as ``models/als.py`` walks it, MESH_EPOCHS
    epochs from the mesh ranks' start. Returns its held-out RMSE an epoch
    and the paths of its final U and V (real rows), written as .npy for
    the rank processes."""
    from ycnr_tpu_torch.models.base import (device_layout, init_state,
                                            rmse_padded, zero_cold_entities)
    from ycnr_tpu_torch.ops.gram import BlockData, solve_block
    from ycnr_tpu_torch.ops.layout import pad_coo

    n_users, n_items, rank, lam = (MAIN[k] for k in ("n_users", "n_items",
                                                     "rank", "lam"))
    lu, li = (device_layout(x, torch.float32, dev) for x in lays)
    test_coo = tuple(torch.as_tensor(x, device=dev) for x in
                     pad_coo(su, si, sr, n_users, n_items, 8192)[:3]) + (
        len(sr),)
    st = zero_cold_entities(init_state(n_users, n_items, rank, seed=0,
                                       device=dev), tu, ti)

    def phase(E, F, lay):
        for blk in zip(*lay):
            eid, rows = solve_block(F, BlockData(*blk), lam,
                                    gather_bf16=True)
            E[eid] = rows

    rmse, secs = [], []
    for _ in range(MESH_EPOCHS):
        sync()
        t0 = time.time()
        phase(st.U, st.V, lu)
        phase(st.V, st.U, li)
        sync()
        secs.append(time.time() - t0)
        rmse.append(float(rmse_padded(st, *test_coo)))
    paths = {}
    for name, F in (("ref_U", st.U), ("ref_V", st.V)):
        paths[name] = os.path.join(tmp, f"mesh_{name}.npy")
        np.save(paths[name], F[:-1].cpu().numpy())
    log(f"mesh: resident blocked reference (one device, bf16 gathers): "
        f"rmse {[round(x, 6) for x in rmse]}, "
        f"s/epoch {[round(x, 4) for x in secs]}")
    return {"rmse": rmse, "paths": paths}


def mesh_serve_check(g, tu, ti, uf, idf, ue, ide, sce) -> dict:
    """Rank 0: the sharded lists of MESH_SAMPLE users against the
    single-GPU recommend_users on the gathered state: exact ids equal up to
    f32 ties, fused picks within one bf16 step of the exact 10th score on
    the bf16-rounded factors (as the main path holds K2)."""
    from ycnr_tpu_torch.eval.recommend import recommend_users, \
        sort_ratings_by_user

    n_rated = int(np.unique(np.asarray(tu)).size)
    rng = np.random.default_rng(2)
    pick = np.sort(rng.choice(len(ue), MESH_SAMPLE, replace=False))
    users = ue[pick]
    pos_f = {int(x): j for j, x in enumerate(uf)}
    fpick = np.array([pos_f[int(x)] for x in users])
    index = sort_ratings_by_user(tu, ti)
    ids, vals = recommend_users(g, tu, ti, users, 10, sorted_index=index)
    exact_same = ids_equal_up_to_ties(ide[pick], sce[pick], ids, vals,
                                      tol=TIE_TOL)
    g16 = g._replace(U=g.U.bfloat16().float(), V=g.V.bfloat16().float())
    _, v16 = recommend_users(g16, tu, ti, users, 10, sorted_index=index)
    U16 = g16.U.double().cpu().numpy()
    V16 = g16.V.double().cpu().numpy()
    true_f = np.einsum("uk,unk->un", U16[users], V16[idf[fpick]])
    nth = v16[:, -1:].astype(np.float64)
    within = true_f >= nth - BF16_REL * np.abs(nth) - TIE_TOL
    return {"served": len(ue), "served_fused": len(uf), "n_rated": n_rated,
            "exact_same": bool(exact_same),
            "fused_within": float(within.mean())}


def phase_mesh(dev, tu, ti, tr, su, si, sr, lays, main_rmse, tmp: str,
               smi: str, built: dict) -> dict:
    """Sharded ALS-WR (parallel/) on the ML-20M arrays in real rank
    processes started by the port's launcher, the arrays written once as
    one .npy set: D = 1 over NCCL on cuda:0, D = 2 over gloo with both
    ranks on cuda:0 (then the serving pass with K2 on every rank and one
    item_sharded epoch), and NCCL asked for two ranks on one card, which
    must raise the port's error and run nothing. ``built``: the host
    lane's sharded data for each world (``host_lane``)."""
    from ycnr_tpu_torch.config import MeshConfig, get_preset
    from ycnr_tpu_torch.data.dataset import Dataset
    from ycnr_tpu_torch.parallel.mesh import spawn_ranks
    from ycnr_tpu_torch.train.loop import train

    paths = {}
    t0 = time.time()
    for k, a in dict(tu=tu, ti=ti, tr=tr, su=su, si=si, sr=sr).items():
        paths[k] = os.path.join(tmp, f"mesh_{k}.npy")
        np.save(paths[k], a)
    log(f"mesh: the arrays written as one .npy set in "
        f"{time.time() - t0:.1f} s")
    ref = mesh_reference(dev, tu, ti, su, si, sr, lays, tmp)
    paths.update(ref["paths"])

    cfg = get_preset("ml20m-als").replace(mesh=MeshConfig(n_shards=2),
                                          out_dir=None)
    ds = Dataset(n_users=MAIN["n_users"], n_items=MAIN["n_items"],
                 train_u=tu, train_i=ti, train_r=tr, test_u=su, test_i=si,
                 test_r=sr, mu=0.0)
    try:
        train(cfg, ds, device=dev, backend="nccl")
        refused = None
    except RuntimeError as e:
        refused = str(e)
    check(refused is not None and "--dist-backend gloo" in refused,
          "NCCL with two ranks on one card raises the port's error")
    log(f"mesh: check passed: NCCL with 2 ranks on {torch.cuda.device_count()}"
        f" card(s) raised ({refused!r}) and ran nothing")

    runs = {}
    for name, world, backend, kw in (
            ("D=1 nccl", 1, "nccl", {}),
            ("D=2 gloo", 2, "gloo", dict(serve=True, dual=built["dual"],
                                         profile=False))):
        t0 = time.time()
        res = spawn_ranks("chip_smoke:mesh_rank", world, backend=backend,
                          device="cuda", arrays=paths,
                          kwargs=dict(epochs=MESH_EPOCHS,
                                      host_data=built[str(world)], **kw))
        res["wall_s"] = time.time() - t0
        runs[name] = res
        check(res["collectives"]["ok"], f"mesh {name}: all-reduce, "
              f"all-gather and broadcast of CUDA tensors")
        log(f"mesh {name}: {world} rank process(es), {res['wall_s']:.1f} s "
            f"wall (host build {res['build_s']:.1f} s on the host lane, "
            f"loaded in {res['load_s']:.1f} s on each rank); collectives "
            f"on {res['collectives']['device']} over {res['backend']}")
        for ep, (r, want, m, b) in enumerate(zip(
                res["rmse"], ANCHOR_RMSE, main_rmse, ref["rmse"])):
            log(f"mesh {name} epoch {ep + 1}: {res['s'][ep]:.4f} s, "
                f"held-out rmse {r:.6f} (resident blocked {b:.6f}, |diff| "
                f"{abs(r - b):.2e}; resident main path {m:.6f}, |diff| "
                f"{abs(r - m):.2e}); {res['bytes'][ep]:,} bytes "
                f"through collectives, {1e3 * res['coll_s'][ep]:.1f} ms in "
                f"them (host clock, device synchronized around each)")
            check(abs(r - want) <= RMSE_TOL,
                  f"mesh {name} epoch {ep + 1}: rmse within {RMSE_TOL} of "
                  f"{want}")
            check(abs(r - b) <= MESH_RMSE_TOL,
                  f"mesh {name} epoch {ep + 1}: rmse within "
                  f"{MESH_RMSE_TOL} of the resident blocked run")
            check(abs(r - m) <= MESH_RMSE_TOL,
                  f"mesh {name} epoch {ep + 1}: rmse within "
                  f"{MESH_RMSE_TOL} of the resident main path")
        for side, fd in res["factor_diff"].items():
            log(f"mesh {name}: gathered {side} after {MESH_EPOCHS} epochs "
                f"against the resident blocked run's: largest |diff| "
                f"{fd['scale']:.3e} of the largest |entry|; largest row "
                f"|diff| / |row| {fd['row']:.3e}")
            check(fd["scale"] <= MESH_FACTOR_TOL,
                  f"mesh {name}: {side} within {MESH_FACTOR_TOL} of the "
                  f"largest |entry| of the resident blocked run's")
            check(fd["row"] <= MESH_FACTOR_TOL,
                  f"mesh {name}: every row of {side} within "
                  f"{MESH_FACTOR_TOL} of its norm in the resident blocked "
                  f"run")
        wall = (res["s"][1] + res["s"][3]) / 2
        dev = (f"epoch 3 profiled; rank 0's device time in epoch 3 "
               f"{res['dev_ms_epoch3']:.2f} ms = "
               f"{res['dev_ms_epoch3'] / 1e3 / wall:.3f} of that wall"
               if "dev_ms_epoch3" in res else "no epoch profiled")
        log(f"mesh {name}: s/epoch, epochs 2 and 4: {res['s'][1]:.4f} "
            f"{res['s'][3]:.4f} ({dev}); on {smi}")
        for r, (k1, rg, k2, peak, trash, _) in enumerate(res["per_rank"]):
            log(f"mesh {name} rank {r}: K1 {int(k1)}, row_gather {int(rg)}, "
                f"K2 {int(k2)} launches; peak device memory {int(peak):,} "
                f"bytes; trash rows 0: {bool(trash)}")
            check(k1 > 0 and rg > 0, f"mesh {name} rank {r}: K1 and "
                  f"row_gather launched")
            check(bool(trash), f"mesh {name} rank {r}: trash rows exactly 0")
    two = runs["D=2 gloo"]
    for r, row in enumerate(two["per_rank"]):
        check(row[2] > 0, f"mesh serving rank {r}: K2 launched")
    check(two["served"] == two["served_fused"] == two["n_rated"],
          "mesh serving: every rated user served")
    check(two["exact_same"], "mesh serving: exact lists equal "
          "recommend_users' on the gathered state up to f32 ties")
    check(two["fused_within"] == 1.0, "mesh serving: fused picks within "
          "one bf16 step of the exact 10th score")
    log(f"mesh serving (D=2): {two['served']:,} users, fused pass "
        f"{two['serve_fused_s']:.3f} s wall; {MESH_SAMPLE} sampled lists: "
        f"exact equal up to ties, fused within one bf16 step: "
        f"{two['fused_within']:.5f}")
    d = two["dual"]
    log(f"mesh item_sharded (D=2) epoch 1: {d['s']:.4f} s, rmse "
        f"{d['rmse']:.6f} (gram_psum {two['rmse'][0]:.6f}); "
        f"{d['bytes']:,} bytes through collectives, "
        f"{1e3 * d['coll_s']:.1f} ms in them; host build "
        f"{two['dual_build_s']:.1f} s on the host lane")
    check(abs(d["rmse"] - two["rmse"][0]) <= MESH_RMSE_TOL,
          "mesh item_sharded epoch 1 within the tolerance of gram_psum's")
    check(d["trash"], "mesh item_sharded: trash rows exactly 0")
    launches = {"spd_solve": 0, "spd_solve tiled": 0, "row_gather": 0,
                "fused_scores": 0}
    for res in runs.values():
        for k1, rg, k2, _, _, k1_tiled in res["per_rank"]:
            launches["spd_solve"] += int(k1)
            launches["spd_solve tiled"] += int(k1_tiled)
            launches["row_gather"] += int(rg)
            launches["fused_scores"] += int(k2)
    return {"launches": launches, "runs": runs, "paths": paths, "ref": ref}


def phase_mesh_cli(cli: dict, main_rmse, tmp: str, smi: str,
                   ooc_pinned) -> float:
    """python -m ycnr_tpu_torch train --preset ml20m-als --shards 2
    --dist-backend gloo --epochs 2 on the CLI phase's store and split, and
    the same with --ooc, as two command-line processes run at once (each
    starts two rank processes on cuda:0): metrics with shards=2, the
    trajectory of the resident main path; with --ooc also ooc=true on every
    line and one ``ooc_residency`` event with ``ooc_pinned`` (rank 0's
    pinned wire bytes in the ooc mesh phase). Returns the wall of the
    pair."""
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ)
    env["PYTHONPATH"] = here + (os.pathsep + env["PYTHONPATH"]
                                if env.get("PYTHONPATH") else "")
    runs = []
    t0 = time.time()
    for ooc in (False, True):
        flag = ["--ooc"] if ooc else []
        out = os.path.join(tmp, "ooc_mesh_runs" if ooc else "mesh_runs")
        stdout = open(os.path.join(tmp, f"cli_shards_ooc{int(ooc)}.out"),
                      "w+")
        proc = subprocess.Popen(
            [sys.executable, "-m", "ycnr_tpu_torch", "train", "--preset",
             "ml20m-als", "--config", cli["cfg_file"], "--store",
             cli["store"], "--epochs", "2", *flag, "--shards", "2",
             "--dist-backend", "gloo", "--out", out],
            cwd=here, env=env, stdout=stdout, stderr=subprocess.STDOUT)
        runs.append((ooc, flag, out, stdout, proc))
    try:
        for ooc, flag, out, stdout, proc in runs:
            rc = proc.wait(timeout=600)
            wall = time.time() - t0
            stdout.seek(0)
            text = stdout.read()
            what = "train " + " ".join(flag + ["--shards", "2"])
            check(rc == 0, f"cli {what}: exit code {rc}; its output ends "
                  f"{text[-2000:]!r}")
            # the command's summary: its last JSON line with "epochs" (rank
            # 0 writes to the same output)
            summary = [ln for ln in text.splitlines()
                       if ln.startswith("{") and '"epochs"' in ln]
            check(bool(summary), f"cli {what}: a summary line")
            last = json.loads(summary[-1])
            events = read_events(os.path.join(out, "ml20m-als"))
            ev = [e for e in events if "rmse_test" in e]
            check(last["epochs"] == 2 and [e["shards"] for e in ev] == [2, 2]
                  and all(e.get("ooc", False) == ooc for e in ev),
                  f"cli {what}: two epochs, shards=2 (ooc={ooc}) on every "
                  f"line")
            if ooc:
                rev = [e for e in events if e.get("event") == "ooc_residency"]
                check([(e["mesh_shards"], e["hbm_pinned_bytes"],
                        e["streamed_bytes"]) for e in rev]
                      == [(2, int(ooc_pinned), 0)],
                      f"cli {what}: one ooc_residency event with rank 0's "
                      f"pinned wire bytes")
            for e, m in zip(ev, main_rmse):
                check(abs(e["rmse_test"] - m) <= MESH_RMSE_TOL,
                      f"cli {what} epoch {e['epoch']}: rmse within "
                      f"{MESH_RMSE_TOL} of the resident run")
            log(f"cli {what} --dist-backend gloo (a process, beside the "
                f"other): {wall:.1f} s wall; rmse "
                f"{[e['rmse_test'] for e in ev]}, s/epoch "
                f"{[e['epoch_s'] for e in ev]}; on {smi}")
    finally:
        for _, _, _, stdout, proc in runs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            stdout.close()
    return time.time() - t0


# ---- out of core on the mesh (parallel/ooc_mesh.py) ------------------------
# ALS-WR's item phase all-reduces A [26,745, 64, 64] and b [26,745, 64] in
# f32 a rank an epoch at the ML-20M shape and rank 64 (iALS adds U^T U)
OOC_MESH_BYTES = (26_745 * 64 * 64 + 26_745 * 64) * 4


def ooc_mesh_rank(mesh, wire, epochs: int, ials: bool = False,
                  profile: bool = True, **arrays) -> dict:
    """One rank process of the "ooc mesh" phase (``spawn_ranks`` runs it)
    on the ML-20M arrays (memory-mapped .npy) and the launcher's wire
    (``wire``: ``split_wire``'s skeleton and the meta; its arrays arrive
    with the dataset's), through ``parallel/ooc_mesh.py`` as
    ``train(ooc=True)`` runs a rank:

    1. the rank's slice pinned on the card, ALS-WR rank 64, lam 0.05, bf16
       gathers, ``epochs`` epochs from the main path's start: per epoch the
       seconds (device synchronized), the held-out RMSE, bytes and host ms
       of the collectives (``Mesh.timed``); with ``profile``, epoch 3
       profiled by kernel on rank 0; launches and peak device memory over the run; the gathered
       factors against the resident blocked run's, trash and cold rows;
    2. two streamed epochs (``feed_sharded_wire``) from the same start,
       bit-equal to the pinned run after epoch 2, and the host bytes they
       staged;
    3. with ``ials``: one iALS epoch (lam 0.1, alpha 40) pinned, its
       launches, against the resident blocked iALS epoch's factors.

    Every rank's figures are all-gathered; rank 0 returns the lot."""
    import ycnr_tpu_torch
    from ycnr_tpu_torch.models import ooc
    from ycnr_tpu_torch.models.base import init_state, zero_cold_entities
    from ycnr_tpu_torch.parallel import ooc_mesh as om
    from ycnr_tpu_torch.parallel import shard as sh

    ycnr_tpu_torch.full_precision_matmul()
    dev = mesh.device
    tu, ti = arrays["tu"], arrays["ti"]
    n_users, n_items, rank, lam = (MAIN[k] for k in ("n_users", "n_items",
                                                     "rank", "lam"))
    out = {"world": mesh.world, "backend": mesh.backend}
    cold_u = torch.as_tensor(np.nonzero(np.bincount(
        tu, minlength=n_users) == 0)[0], device=dev)
    cold_i = torch.as_tensor(np.nonzero(np.bincount(
        ti, minlength=n_items) == 0)[0], device=dev)

    def zero_rows(g) -> bool:
        return (bool((g.U[-1] == 0).all()) and bool((g.V[-1] == 0).all())
                and bool((g.U[cold_u] == 0).all())
                and bool((g.V[cold_i] == 0).all()))

    def diffs(g, ref_u, ref_v):
        return {name: factor_diff(F[:-1], torch.as_tensor(
            np.array(arrays[ref]), device=dev))
            for name, F, ref in (("U", g.U, ref_u), ("V", g.V, ref_v))}

    sw, meta = om.join_wire(wire[0], arrays), wire[1]
    data = om.put_test_rows(meta, arrays["su"], arrays["si"], arrays["sr"],
                            mesh, torch.float32)

    def start():
        return sh.scatter_state(zero_cold_entities(init_state(
            n_users, n_items, rank, seed=0, device=dev), tu, ti), meta, mesh)

    # 1. pinned
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    pinned = om.put_sharded_wire(sw, mesh)
    pinned_bytes = ooc.wire_nbytes(pinned.ugroups, pinned.igroups)
    ep = om.make_sharded_ooc_epoch(mesh, pinned, lam, gather_bf16=True)
    st = start()
    mesh.timed = True
    reset_launches()
    out.update(rmse=[], s=[], bytes=[], coll_s=[])
    for e in range(epochs):
        b0, c0 = mesh.bytes_moved, mesh.collective_s
        sync()
        t0 = time.time()
        if e == 2 and mesh.rank == 0 and profile:  # epoch 3, rank 0
            st, out["dev_ms_epoch3"] = profile_breakdown(
                lambda: ep(st), f"ooc mesh epoch 3, rank 0 of {mesh.world}")
        else:
            st = ep(st)
        sync()
        out["s"].append(time.time() - t0)
        out["bytes"].append(mesh.bytes_moved - b0)
        out["coll_s"].append(mesh.collective_s - c0)
        out["rmse"].append(sh.sharded_rmse(mesh, st, data, meta.test_n))
        if e == 1:
            U2, V2 = st.U.clone(), st.V.clone()
    ln = read_launches()
    peak = torch.cuda.max_memory_allocated(dev) - base
    g = sh.gather_state(st, meta, mesh)
    zero = zero_rows(g) and bool((st.U[-1] == 0).all())
    if mesh.rank == 0:
        out["factor_diff"] = diffs(g, "ref_U", "ref_V")
    del st, g

    # 2. streamed, from the same start
    sep = om.make_sharded_ooc_epoch(mesh, None, lam, gather_bf16=True,
                                    wire_as_args=True)
    st = start()
    staged0 = ooc.staged_bytes
    out["streamed_s"] = []
    for _ in range(2):
        sync()
        t0 = time.time()
        st = sep(st, om.feed_sharded_wire(sw, mesh))
        sync()
        out["streamed_s"].append(time.time() - t0)
    staged = ooc.staged_bytes - staged0
    same = torch.equal(st.U, U2) and torch.equal(st.V, V2)
    del st, U2, V2

    # 3. one iALS epoch, pinned
    iln = dict.fromkeys(("spd_solve", "row_gather"), 0)
    if ials:
        iep = om.make_sharded_ooc_epoch(mesh, pinned, IALS["lam"],
                                        alpha=IALS["alpha"], gather_bf16=True)
        st = start()
        b0 = mesh.bytes_moved
        reset_launches()
        sync()
        t0 = time.time()
        st = iep(st)
        sync()
        iln = read_launches()
        out["ials"] = {"s": time.time() - t0, "bytes": mesh.bytes_moved - b0}
        g = sh.gather_state(st, meta, mesh)
        out["ials"]["zero"] = zero_rows(g) and bool((st.U[-1] == 0).all())
        if mesh.rank == 0:
            out["ials"]["factor_diff"] = diffs(g, "ref_iU", "ref_iV")
    per = torch.tensor(
        [ln["spd_solve"], ln["fused_gram"], ln["row_gather"],
         ln["spd_solve tiled"], peak, float(zero), float(same), pinned_bytes,
         staged, min(out["bytes"]), max(out["bytes"]), iln["spd_solve"],
         iln["row_gather"]], dtype=torch.float64, device=dev)
    out["per_rank"] = [x.tolist() for x in mesh.all_gather(per)]
    return out


def ials_reference(dev, tu, ti, lays, tmp: str) -> dict:
    """One resident iALS epoch (lam 0.1, alpha 40, bf16 gathers) over the
    host blocked layouts ``lays``, ``solve_block`` a block as
    ``models/ials.py`` walks it, from the main path's start: the paths of
    its U and V (real rows) as .npy for the rank processes."""
    from ycnr_tpu_torch.models.base import (device_layout, init_state,
                                            zero_cold_entities)
    from ycnr_tpu_torch.ops.gram import BlockData, solve_block

    n_users, n_items, rank = (MAIN[k] for k in ("n_users", "n_items",
                                                "rank"))
    lam, alpha = IALS["lam"], IALS["alpha"]
    lu, li = (device_layout(x, torch.float32, dev) for x in lays)
    st = zero_cold_entities(init_state(n_users, n_items, rank, seed=0,
                                       device=dev), tu, ti)
    for E, F, lay in ((st.U, st.V, lu), (st.V, st.U, li)):
        G = F.T @ F
        for blk in zip(*lay):
            eid, rows = solve_block(F, BlockData(*blk), lam,
                                    gram_weight_alpha=alpha, base_gram=G,
                                    base_reg=lam, gather_bf16=True)
            E[eid] = rows
    paths = {}
    for name, F in (("ref_iU", st.U), ("ref_iV", st.V)):
        paths[name] = os.path.join(tmp, f"mesh_{name}.npy")
        np.save(paths[name], F[:-1].cpu().numpy())
    return paths


def phase_ooc_mesh(dev, tu, ti, tr, lays, mesh: dict, main_rmse, cli: dict,
                   tmp: str, smi: str, wires: dict) -> dict:
    """Out of core on the mesh (``parallel/ooc_mesh.py``) on the main
    path's arrays, in real rank processes of the port's launcher (the mesh
    phase's .npy set; each wire is built once on the launcher's host lane,
    ``wires``, and its arrays added to the set): D = 1 over NCCL and D = 2
    over gloo on cuda:0
    (``ooc_mesh_rank``; the iALS epoch at D = 2), then ``train --ooc
    --shards 2 --dist-backend gloo --epochs 2`` from the CLI phase's
    store."""
    from ycnr_tpu_torch.parallel.mesh import spawn_ranks

    t0 = time.time()
    paths = dict(mesh["paths"], **ials_reference(dev, tu, ti, lays, tmp))
    log(f"ooc mesh: resident blocked iALS epoch for the reference in "
        f"{time.time() - t0:.1f} s")
    ref_rmse = mesh["ref"]["rmse"]
    runs = {}
    for name, world, backend, kw in (("D=1 nccl", 1, "nccl", {}),
                                     ("D=2 gloo", 2, "gloo",
                                      {"ials": True, "profile": False})):
        with open(wires[str(world)], "rb") as f:
            skel, meta, leaves, build_s = pickle.load(f)
        t0 = time.time()
        res = spawn_ranks(
            "chip_smoke:ooc_mesh_rank", world, backend=backend,
            device="cuda", arrays=dict(paths, **leaves),
            kwargs=dict(wire=(skel, meta), epochs=MESH_EPOCHS, **kw))
        res["wall_s"] = time.time() - t0
        runs[name] = res
        what = f"ooc mesh {name}"
        log(f"{what}: wire built once on the launcher's host lane in "
            f"{build_s:.1f} s; "
            f"{world} rank process(es), {res['wall_s']:.1f} s wall; "
            f"collectives over {res['backend']}")
        s = res["s"]
        for ep, (r, want, m, b) in enumerate(zip(
                res["rmse"], ANCHOR_RMSE, main_rmse, ref_rmse)):
            log(f"{what} epoch {ep + 1}: {s[ep]:.4f} s, held-out rmse "
                f"{r:.6f} (resident blocked {b:.6f}, |diff| {abs(r - b):.2e};"
                f" resident main path {m:.6f}, |diff| {abs(r - m):.2e}); "
                f"{res['bytes'][ep]:,} bytes through collectives, "
                f"{1e3 * res['coll_s'][ep]:.1f} ms in them (host clock, "
                f"device synchronized around each)")
            check(abs(r - want) <= RMSE_TOL,
                  f"{what} epoch {ep + 1}: rmse within {RMSE_TOL} of {want}")
            check(abs(r - b) <= MESH_RMSE_TOL,
                  f"{what} epoch {ep + 1}: rmse within {MESH_RMSE_TOL} of "
                  f"the resident blocked run")
            check(abs(r - m) <= MESH_RMSE_TOL,
                  f"{what} epoch {ep + 1}: rmse within {MESH_RMSE_TOL} of "
                  f"the resident main path")
        for side, fd in res["factor_diff"].items():
            log(f"{what}: gathered {side} after {MESH_EPOCHS} epochs against "
                f"the resident blocked run's: largest |diff| "
                f"{fd['scale']:.3e} of the largest |entry|; largest row "
                f"|diff| / |row| {fd['row']:.3e}")
            check(fd["scale"] <= MESH_FACTOR_TOL and fd["row"]
                  <= MESH_FACTOR_TOL, f"{what}: {side} and its every row "
                  f"within {MESH_FACTOR_TOL} of the resident blocked run's")
        wall = (s[1] + s[3]) / 2
        dev_ms = res.get("dev_ms_epoch3")
        dev = (f"epoch 3 profiled; rank 0's device time in epoch 3 "
               f"{dev_ms:.2f} ms = {dev_ms / 1e3 / wall:.3f} of that wall "
               f"(idle {1 - dev_ms / 1e3 / wall:.3f})"
               if dev_ms is not None else "no epoch profiled")
        log(f"{what}: s/epoch, epochs 2 and 4: {s[1]:.4f} {s[3]:.4f} "
            f"({dev}); streamed s/epoch "
            f"{[round(x, 4) for x in res['streamed_s']]}; on {smi}")
        for r, row in enumerate(res["per_rank"]):
            (k1, fg, rg, k1t, peak, zero, same, pinned, staged, bmin,
             bmax, ik1, irg) = row
            log(f"{what} rank {r}: K1 {int(k1)}, fused_gram {int(fg)}, "
                f"row_gather {int(rg)} launches (K1 tiled body "
                f"{int(k1t)}); peak device memory {int(peak):,} bytes above "
                f"the rank's start; pinned wire {int(pinned):,} bytes; the "
                f"streamed pair staged {int(staged):,} bytes; trash and "
                f"cold rows 0: {bool(zero)}; streamed = pinned: "
                f"{bool(same)}" + (f"; iALS epoch K1 {int(ik1)}, row_gather "
                                   f"{int(irg)}" if kw else ""))
            check(k1 > 0 and fg > 0, f"{what} rank {r}: K1 and fused_gram "
                  f"launched")
            check(bool(zero), f"{what} rank {r}: trash and cold rows 0")
            check(bool(same), f"{what} rank {r}: streamed epochs bit-equal "
                  f"to the pinned ones")
            check(bmin == bmax == OOC_MESH_BYTES, f"{what} rank {r}: "
                  f"{OOC_MESH_BYTES:,} bytes all-reduced every epoch")
            check(staged > 0, f"{what} rank {r}: the streamed pair staged "
                  f"its wire")
            if kw:
                check(ik1 > 0 and irg > 0, f"{what} rank {r}: K1 and "
                      f"row_gather launched by the iALS epoch")
    ia = runs["D=2 gloo"]["ials"]
    log(f"ooc mesh iALS (D=2) epoch 1: {ia['s']:.4f} s, {ia['bytes']:,} "
        f"bytes through collectives; against the resident blocked iALS "
        f"epoch: " + "; ".join(
            f"{k} {fd['scale']:.3e} of the largest |entry|, rows "
            f"{fd['row']:.3e}" for k, fd in ia["factor_diff"].items()))
    check(ia["bytes"] == OOC_MESH_BYTES + 64 * 64 * 4,
          "ooc mesh iALS: A, b and U^T U all-reduced")
    check(ia["zero"], "ooc mesh iALS: trash and cold rows 0")
    for side, fd in ia["factor_diff"].items():
        check(fd["scale"] <= MESH_FACTOR_TOL and fd["row"] <= MESH_FACTOR_TOL,
              f"ooc mesh iALS: {side} and its every row within "
              f"{MESH_FACTOR_TOL} of the resident blocked iALS epoch's")
    cli_s = phase_mesh_cli(cli, main_rmse, tmp, smi,
                           ooc_pinned=runs["D=2 gloo"]["per_rank"][0][7])
    launches = {"spd_solve": 0, "spd_solve tiled": 0, "row_gather": 0,
                "fused_gram": 0}
    for res in runs.values():
        for k1, fg, rg, k1t, *_, ik1, irg in res["per_rank"]:
            launches["spd_solve"] += int(k1 + ik1)
            launches["spd_solve tiled"] += int(k1t)
            launches["fused_gram"] += int(fg)
            launches["row_gather"] += int(rg + irg)
    log(f"ooc mesh: kernel launches over the 4-epoch runs and the iALS "
        f"epoch, every rank: {launches}; cli {cli_s:.1f} s")
    return {"launches": launches, "runs": runs}



# ---- "bench" and "tools": the measuring layer (ycnr_tpu_torch/tools/) ----

# The bench's 8-group run against the main path: the same cached arrays,
# the same start and the same kernels, so the same trajectory; the bench
# logs RMSE to 6 decimals (half of 1e-6 of rounding).
BENCH_TRAJ_TOL = 1e-6
# An out-of-core run's held-out RMSE after 3 epochs against the main
# path's epoch 3: the same factors, the RMSE summed over the held-out set
# without the main path's padding (another reduction shape).
OOC_MAIN_TOL = 1e-5
SOAK_S = 8  # the soak's duration (its default is 60)
TOOL_EPOCHS = 2  # epochs of the in-process runs and tools (one before the
#                  first timed epoch; RMSE can be seen to fall)
BENCH_KEYS = {"metric", "value", "unit", "vs_baseline", "steady_16g_s"}


# ---- the host lane: host-only builds beside the card's phases -----------

def host_lane(out: str):
    """The host builds that later phases read, made in a process of their
    own (``HostLane``) while the main process runs the card's phases: the
    main path's arrays (``main_data``: generated, split, written into the
    bench cache and read back bit-equal), the bucketed and then the blocked
    layouts of the bench cache, the out-of-core phase's packed wires,
    wire-order plans and wires and stream-SGD data (``phase_ooc``), the
    mesh ranks' sharded data (``build_sharded_data`` for D = 1 and D = 2,
    ``build_dual_sharded_data`` for D = 2, as each rank would build it),
    the out-of-core mesh's wires (``build_sharded_wire`` for D = 1 and
    D = 2) and ``quality_calibrated``'s dataset (``cached_dataset``, into
    the bench cache). Each step ends with a marker file in ``out``;
    nothing here touches the card. A failed check ends the process with
    an error, which ``HostLane.wait`` raises."""
    from ycnr_tpu_torch.config import get_preset
    from ycnr_tpu_torch.models.sgd_stream import prepare_stream_sgd
    from ycnr_tpu_torch.ops.packed import build_packed, wire_storage_plan
    from ycnr_tpu_torch.ops.sgd_wire import compact_from_stream
    from ycnr_tpu_torch.parallel import dual as du
    from ycnr_tpu_torch.parallel import shard as sh
    from ycnr_tpu_torch.parallel.ooc_mesh import (build_sharded_wire,
                                                  split_wire)
    from ycnr_tpu_torch.tools import bench as tbench
    from ycnr_tpu_torch.tools import quality_calibrated

    def done(step: str, info: dict):
        path = os.path.join(out, f"{step}.json")
        with open(path + ".tmp", "w") as f:
            json.dump(info, f)
        os.replace(path + ".tmp", path)

    def dump(name: str, obj) -> str:
        path = os.path.join(out, name)
        with open(path, "wb") as f:
            pickle.dump(obj, f, protocol=pickle.HIGHEST_PROTOCOL)
        return path

    n_users, n_items, rank = (MAIN[k] for k in ("n_users", "n_items",
                                                "rank"))
    (u, i, r), ((tu, ti, tr), (su, si, sr)) = main_data()
    for k, a in dict(u=u, i=i, r=r).items():
        np.save(os.path.join(out, f"{k}.npy"), a)
    done("data", {})
    del u, i, r
    data_tag = tbench.coo_tag(n_users, n_items, MAIN["n_ratings"], 0)
    for kind in ("bucketed", "blocked"):
        t0 = time.time()
        tbench.cached_layouts(tu, ti, tr, n_users, n_items, 32, rank, kind,
                              MAIN["groups"], data_tag)
        done(kind, {"s": time.time() - t0})
    # the out-of-core phase's host builds, timed as it would time them
    g = MAIN["groups"]
    b = {}
    t0 = time.time()
    b["upk"] = build_packed(tu, ti, tr, n_users, n_items, rank, max_groups=g)
    b["t_u"] = time.time() - t0
    t0 = time.time()
    b["ipk"] = build_packed(ti, tu, tr, n_items, n_users, rank, max_groups=g)
    b["t_i"] = time.time() - t0
    t0 = time.time()
    b["up"] = up = wire_storage_plan(np.bincount(tu, minlength=n_users),
                                     rank_hint=rank, max_groups=g)
    b["ip"] = ip = wire_storage_plan(np.bincount(ti, minlength=n_items),
                                     rank_hint=rank, max_groups=g)
    b["wu"] = build_packed(tu, ti, tr, n_users, n_items, rank, max_groups=g,
                           other_plan=ip)
    b["wi"] = build_packed(ti, tu, tr, n_items, n_users, rank, max_groups=g,
                           other_plan=up)
    b["t_ws"] = time.time() - t0
    t0 = time.time()
    b["stream"], _ = prepare_stream_sgd(
        tu, ti, tr, get_preset("ml1m-sgd").sgd.batch_size, n_users, n_items,
        seed=0, grad_mode="capped", device=False)
    b["t_prep"] = time.time() - t0
    t0 = time.time()
    b["compact"] = compact_from_stream(b["stream"], n_items)
    b["t_comp"] = time.time() - t0
    done("ooc", {"path": dump("ooc.pkl", b)})
    del b, up, ip
    mesh = {}
    for world, serve in ((1, False), (2, True)):
        t0 = time.time()
        host, meta = sh.build_sharded_data(
            tu, ti, tr, n_users, n_items, world, chunk_len=32,
            rank_hint=rank, test_u=su, test_i=si, test_r=sr,
            host_user_layout=serve, algo="als")
        mesh[world] = dump(f"mesh_d{world}.pkl",
                           (host, meta, time.time() - t0))
        del host, meta
    t0 = time.time()
    host, dmeta = du.build_dual_sharded_data(
        tu, ti, tr, n_users, n_items, 2, chunk_len=32, rank_hint=rank,
        test_u=su, test_i=si, test_r=sr)
    mesh["dual"] = dump("mesh_dual_d2.pkl", (host, dmeta, time.time() - t0))
    del host, dmeta
    done("mesh", mesh)
    wires = {}
    for world in (1, 2):
        t0 = time.time()
        # the main path's groups, as the CLI phase's config file gives
        # train()
        sw, meta = build_sharded_wire(tu, ti, tr, n_users, n_items, world,
                                      rank_hint=rank,
                                      max_groups=MAIN["groups"])
        skel, leaves = split_wire(sw)
        build_s = time.time() - t0
        paths = {}
        for k, a in leaves.items():
            paths[k] = os.path.join(out, f"wire_d{world}_{k}.npy")
            np.save(paths[k], np.ascontiguousarray(a))
        wires[world] = dump(f"wire_d{world}.pkl",
                            (skel, meta, paths, build_s))
        del sw, leaves
    done("ooc_mesh", wires)
    # quality_calibrated's dataset, into the bench cache its run reads
    t0 = time.time()
    tbench.cached_dataset(quality_calibrated.data_config(), 32)
    done("quality", {"s": time.time() - t0})


class HostLane:
    """``host_lane`` in a process started now (``python -c``, from this
    script's directory, the bench cache's environment inherited). ``wait``
    blocks until a step's marker is there and logs the lane's new lines;
    ``close`` ends the process if it still runs and removes its files."""

    def __init__(self):
        self.dir = tempfile.mkdtemp(prefix="ycnr_lane_")
        self.log_path = os.path.join(self.dir, "lane.log")
        self._log = open(self.log_path, "w")
        self._seen = 0
        here = os.path.dirname(os.path.abspath(__file__))
        self.proc = subprocess.Popen(
            [sys.executable, "-c",
             f"import chip_smoke; chip_smoke.host_lane({self.dir!r})"],
            cwd=here, stdout=self._log, stderr=subprocess.STDOUT)

    def _relay(self):
        with open(self.log_path) as f:
            lines = f.read().splitlines()
        for line in lines[self._seen:]:
            log(f"host lane: {line}")
        self._seen = len(lines)

    def wait(self, step: str) -> dict:
        path = os.path.join(self.dir, f"{step}.json")
        t0 = time.time()
        while not os.path.exists(path):
            if self.proc.poll() is not None:
                self._relay()
                raise RuntimeError(f"the host lane ended with code "
                                   f"{self.proc.returncode} before step "
                                   f"{step!r}")
            time.sleep(0.2)
        self._relay()
        with open(path) as f:
            info = json.load(f)
        log(f"host lane: step {step!r} ready (waited "
            f"{time.time() - t0:.1f} s)")
        return info

    def close(self):
        if self.proc.poll() is None:
            self.proc.kill()
        self.proc.wait()
        self._log.close()
        shutil.rmtree(self.dir, ignore_errors=True)


def main_data():
    """The main path's arrays, made once: the synthetic set
    (``synthetic_ratings``, rank 16, noise 0.3, seed 0) and its split
    (``train_test_split``, 5%, seed 0), written into the bench cache under
    the bench's own tag (``tools.bench.coo_tag``, ``_cache_path``) and read
    back through ``tools.bench.cached_coo``, as every bench and tool run of
    this script reads them; the read-back held to the split bit for bit."""
    from ycnr_tpu_torch.data.split import train_test_split
    from ycnr_tpu_torch.data.synthetic import synthetic_ratings
    from ycnr_tpu_torch.tools import bench as tbench

    nu, ni, nr = MAIN["n_users"], MAIN["n_items"], MAIN["n_ratings"]
    t0 = time.time()
    u, i, r = synthetic_ratings(nu, ni, nr, true_rank=16, noise=0.3, seed=0)
    split = train_test_split(u, i, r, 0.05, 0)
    (tu, ti, tr), (su, si, sr) = split
    tbench._save_npz(tbench._cache_path(tbench.coo_tag(nu, ni, nr, 0)), {
        "tu": tu, "ti": ti, "tr": tr, "su": su, "si": si, "sr": sr})
    got = tbench.cached_coo(nu, ni, nr, 0)
    same = all(a.dtype == b.dtype and np.array_equal(a, b)
               for a, b in zip(got[0] + got[1], split[0] + split[1]))
    check(same, "the bench cache gives back synthetic_ratings + "
          "train_test_split")
    log(f"data: {len(r):,} ratings generated, split and cached in "
        f"{time.time() - t0:.1f} s; the bench cache's split equals "
        f"train_test_split of them bit for bit")
    return (u, i, r), got


_EPOCH_LINE = re.compile(r"epoch \d+.*?: ([0-9.]+)s device ([0-9.]+) ms"
                         r"(?: rmse=([0-9.]+))?")
_LAUNCH_LINE = re.compile(r"kernel launches (over the epochs|of the top-10 "
                          r"passes): (\{.*\})")
_TOPN_LINE = re.compile(r"top-10 (on device|fused scorer).* = ([0-9,]+) "
                        r"recs/s.*rated items served: (\d+)")


def parse_bench_log(err: str) -> list:
    """The stderr of ``python -m ycnr_tpu_torch.tools.bench`` split into its
    runs (each starts with its ``device:`` line): the RMSE, wall and
    device ms of every epoch, the launches over the epochs and of the
    top-10 passes, recs/s and rated items served of each scorer."""
    import ast

    runs = []
    for line in err.splitlines():
        if line.startswith("device: "):
            runs.append({"rmse": [], "s": [], "device_ms": [], "recs": {},
                         "rated": {}})
        elif runs:
            run = runs[-1]
            if m := _EPOCH_LINE.match(line):
                run["s"].append(float(m[1]))
                run["device_ms"].append(float(m[2]))
                if m[3]:
                    run["rmse"].append(float(m[3]))
            elif m := _LAUNCH_LINE.match(line):
                run["epochs" if m[1].startswith("over") else "topn"] = \
                    ast.literal_eval(m[2])
            elif m := _TOPN_LINE.match(line):
                key = "exact" if m[1] == "on device" else "fused"
                run["recs"][key] = int(m[2].replace(",", ""))
                run["rated"][key] = int(m[3])
    return runs


def count_launches(total: dict, launches: dict):
    """Add a run's launches to ``total`` (K1's tiled body apart)."""
    for k in total:
        total[k] += launches[k]


def phase_bench(dev, main_rmse, smi: str) -> dict:
    """"bench": ``ycnr_tpu_torch/tools/bench.py`` at the ML-20M width on
    the cached arrays. Once as a process, as a user runs it (``--algo als
    --topn --groups both``): exactly one stdout line with bench.py's keys
    and ``vs_baseline`` null; the 8-group run's RMSE after epochs 1-4
    within BENCH_TRAJ_TOL of the main path's and both runs' within 1e-3 of
    the reference; K1 and ``fused_gram`` over the epochs, K2 in the top-10
    passes, no rated item served by either scorer. Then in process
    (``run_bench``, TOOL_EPOCHS epochs where the run is not the main
    path's): ``--layout blocked`` (4 epochs, within 1e-3 of the
    reference), ``--rank 128`` (RMSE falls, K1's tiled body launches),
    ``--algo ials``, ``--algo sgd`` batched and ``--sgd-method stream``
    (RMSE falls), ``--algo bpr``; their launches go to the kernels line."""
    from ycnr_tpu_torch.config import get_preset
    from ycnr_tpu_torch.tools import bench as tbench

    t0 = time.time()
    res = subprocess.run([sys.executable, "-m", "ycnr_tpu_torch.tools.bench",
                          "--algo", "als", "--topn", "--groups", "both"],
                         capture_output=True, text=True, timeout=900)
    wall = time.time() - t0
    check(res.returncode == 0, f"the bench process exits 0 (stderr ends "
          f"{res.stderr[-3000:]})")
    lines = res.stdout.strip().splitlines()
    check(len(lines) == 1, f"the bench process prints exactly one stdout "
          f"line, not {len(lines)}")
    out = json.loads(lines[0])
    log(f"bench process ({wall:.1f} s wall): {lines[0]}")
    check(set(out) == BENCH_KEYS and out["vs_baseline"] is None
          and out["unit"] == "s/epoch"
          and out["metric"] == "ml20m_als_epoch_s_rank64_1gpu",
          "the bench line has bench.py's keys, vs_baseline null")
    runs = parse_bench_log(res.stderr)
    check(len(runs) == 2, "the bench logged its 8-group and 16-group runs")
    for g, run in zip((8, 16), runs):
        log(f"bench {g} groups: s/epoch {run['s']}, device ms an epoch "
            f"(CUDA events) {run['device_ms']}, rmse {run['rmse']}; "
            f"launches {run.get('epochs')}, top-10 {run.get('topn')}; "
            f"top-10 exact {run['recs'].get('exact', 0):,} recs/s, fused "
            f"(K2) {run['recs'].get('fused', 0):,} recs/s; on {smi}")
        check(len(run["rmse"]) == 4, f"bench {g} groups: 4 epochs")
        for ep, (got, want) in enumerate(zip(run["rmse"], ANCHOR_RMSE)):
            check(abs(got - want) <= RMSE_TOL, f"bench {g} groups epoch "
                  f"{ep + 1} rmse {got} within {RMSE_TOL} of {want}")
        ep_l, top = run.get("epochs", {}), run.get("topn", {})
        check(ep_l.get("spd_solve", 0) > 0 and ep_l.get("fused_gram", 0) > 0
              and ep_l.get("spd_solve tiled", 1) == 0,
              f"bench {g} groups: K1's warp body and fused_gram launched")
        check(top.get("fused_scores", 0) > 0 and "fused" in run["recs"],
              f"bench {g} groups: --topn ran K2 (the fused leg)")
        check(run["rated"] == {"exact": 0, "fused": 0},
              f"bench {g} groups: no rated item served")
    for ep, (got, want) in enumerate(zip(runs[0]["rmse"], main_rmse)):
        check(abs(got - want) <= BENCH_TRAJ_TOL, f"bench 8 groups epoch "
              f"{ep + 1} rmse {got} within {BENCH_TRAJ_TOL} of the main "
              f"path's {want:.7f}")
    log(f"bench process: 8-group RMSE equal to the main path's within "
        f"{BENCH_TRAJ_TOL}; 16 groups {out['steady_16g_s']} s/epoch")

    launches = dict.fromkeys(("spd_solve", "spd_solve tiled",
                              "fused_scores", "row_gather", "fused_gram"), 0)
    shape = (MAIN["n_users"], MAIN["n_items"], MAIN["n_ratings"])
    inproc = {}

    def run_in(name, rank, epochs, **kw):
        sync()
        reset_launches()
        rep = {}
        s = tbench.run_bench(*shape, rank, epochs, 32, bf16=True, groups=8,
                             device=dev, report=rep, **kw)
        sync()
        ln = read_launches()
        count_launches(launches, ln)
        rep["all_launches"] = ln
        inproc[name] = rep
        log(f"bench in process, {name}: {s:.4f} s/epoch; walls "
            f"{[round(x, 4) for x in rep['epoch_s']]} s, device ms "
            f"{[round(x, 3) for x in rep['device_ms']]}, rmse "
            f"{[None if x is None else round(x, 6) for x in rep['rmse']]}; "
            f"launches { {k: v for k, v in ln.items() if v} }; on {smi}")
        return rep

    rep = run_in("--layout blocked", 64, 3, layout="blocked")
    for ep, (got, want) in enumerate(zip(rep["rmse"], ANCHOR_RMSE)):
        check(abs(got - want) <= RMSE_TOL, f"bench --layout blocked epoch "
              f"{ep + 1} rmse {got:.6f} within {RMSE_TOL} of {want}")
    check(rep["all_launches"]["row_gather"] > 0, "blocked: row_gather ran")
    rep = run_in("--rank 128", 128, TOOL_EPOCHS - 1)
    check(rep["rmse"][-1] < rep["rmse"][0], "bench --rank 128: RMSE falls")
    check(rep["all_launches"]["spd_solve tiled"] > 0
          and rep["all_launches"]["fused_gram"] > 0,
          "bench --rank 128: fused_gram and K1's tiled body launched")
    rep = run_in("--algo ials", get_preset("ml20m-ials").ials.rank,
                 TOOL_EPOCHS - 1, algo="ials")
    check(rep["all_launches"]["spd_solve"] > 0
          and rep["all_launches"]["row_gather"] > 0,
          "bench --algo ials: row_gather and K1 launched")
    for method in ("batched", "stream"):
        rep = run_in(f"--algo sgd --sgd-method {method}", 64,
                     TOOL_EPOCHS - 1, algo="sgd", sgd_method=method)
        check(rep["rmse"][-1] < rep["rmse"][0],
              f"bench --algo sgd ({method}): RMSE falls")
        check(rep["all_launches"]["row_gather"] > 0,
              f"bench --algo sgd ({method}): row_gather launched")
    rep = run_in("--algo bpr", get_preset("ml20m-bpr").bpr.rank,
                 TOOL_EPOCHS - 1, algo="bpr")
    check(rep["all_launches"]["row_gather"] > 0,
          "bench --algo bpr: row_gather launched")
    log(f"bench phase kernel launches (in process): {launches}")
    return {"launches": launches, "process": runs, "line": out,
            "inproc": inproc}


def phase_tools(dev, main_rmse, cli: dict, smi: str, tmp: str,
                lane: "HostLane") -> dict:
    """"tools": the measuring tools of ``ycnr_tpu_torch/tools/`` in
    process at the ML-20M width (their JSON lines into this log, their
    launches into the kernels line): ``bench_ooc --scale ml20m --compare``
    with ``--residency device`` and ``host`` (factors bit-equal to the
    resident run's, held-out RMSE equal, and within OOC_MAIN_TOL of the
    main path's epoch 3), ``--probe`` (host-to-device GB/s), ``--algo sgd``
    on the compact wire with ``--rmse`` (held-out RMSE falls);
    ``bench_bpr_batch --batches 65536 262144``; ``soak`` at its defaults
    for SOAK_S seconds (no error, no epoch going back on a connection);
    ``loadgen`` against the CLI phase's store and checkpoint, its server a
    process of its own (no error); ``quality_calibrated --scale ml20m``
    (its dataset from the bench cache, made on the host ``lane``)
    (hit@10 rises for BPR and iALS). Depth cut to TOOL_EPOCHS epochs."""
    import io

    from ycnr_tpu_torch.tools import (bench_bpr_batch, bench_ooc, loadgen,
                                      quality_calibrated, soak)

    free = subprocess.run(["free", "-g"], capture_output=True, text=True,
                          timeout=60).stdout.strip()
    log("free -g on this machine:\n" + free)
    launches = dict.fromkeys(("spd_solve", "spd_solve tiled",
                              "fused_scores", "row_gather", "fused_gram"), 0)
    out = {"free": free}

    def tool(name, module, argv):
        sync()
        reset_launches()
        buf = io.StringIO()
        t0 = time.time()
        with contextlib.redirect_stdout(buf):
            ret = module.main(argv)
        sync()
        ln = read_launches()
        count_launches(launches, ln)
        log(f"{name}: {time.time() - t0:.1f} s; launches "
            f"{ {k: v for k, v in ln.items() if v} }; on {smi}")
        for line in buf.getvalue().splitlines():
            log(f"{name}: {line}")
        out[name] = ret
        return ret, ln

    for residency in ("device", "host"):
        r, ln = tool(f"bench_ooc --compare --residency {residency}",
                     bench_ooc, ["--scale", "ml20m", "--compare",
                                 "--residency", residency])
        cmp = r["compare"]
        check(cmp["factors_equal"] is True, f"bench_ooc {residency}: the "
              f"out-of-core factors equal the resident run's bit for bit")
        check(cmp["heldout_rmse_ooc"] == cmp["heldout_rmse_resident"],
              f"bench_ooc {residency}: the same held-out RMSE")
        check(abs(cmp["heldout_rmse_ooc"] - main_rmse[2]) <= OOC_MAIN_TOL,
              f"bench_ooc {residency}: held-out RMSE after 3 epochs "
              f"{cmp['heldout_rmse_ooc']:.7f} within {OOC_MAIN_TOL} of the "
              f"main path's epoch 3 {main_rmse[2]:.7f}")
        check(ln["spd_solve"] > 0 and ln["fused_gram"] > 0,
              f"bench_ooc {residency}: K1 and fused_gram launched")
        if residency == "device":
            check(r["residency"]["streamed_mb"] == 0, "bench_ooc device: "
                  "the whole wire pinned")
    r, _ = tool("bench_ooc --probe", bench_ooc, ["--scale", "ml20m",
                                                 "--probe"])
    check(all(v > 0 for v in r["wire_MBps"].values()), "the probe's rates")
    gb_s = {k: round(v * 2**20 / 1e9, 2) for k, v in r["wire_MBps"].items()}
    log(f"bench_ooc probe: host-to-device from pinned memory {gb_s} GB/s "
        f"(CUDA events); on {smi}")
    r, ln = tool("bench_ooc --algo sgd", bench_ooc,
                 ["--scale", "ml20m", "--algo", "sgd", "--epochs",
                  str(TOOL_EPOCHS), "--rmse"])
    check(r["heldout_rmse"][-1] < r["heldout_rmse"][0] and ln["row_gather"]
          > 0, "bench_ooc --algo sgd: held-out RMSE falls, row_gather ran")
    rows, ln = tool("bench_bpr_batch", bench_bpr_batch,
                    ["--batches", "65536", "262144", "--epochs",
                     str(TOOL_EPOCHS)])
    check(len(rows) == 2 and all(np.isfinite(h) for x in rows
                                 for h in x["hit10"])
          and ln["row_gather"] > 0, "bench_bpr_batch: a line a batch "
          "size, hit@10 finite, row_gather ran")
    r, _ = tool("soak", soak, ["--duration", str(SOAK_S)])
    check(r["errors"] == 0 and r["epoch_regressions"] == 0
          and r["republishes"] >= SOAK_S // 2 - 1,
          "soak: no error response, no epoch going back on a connection")
    r, _ = tool("loadgen", loadgen, ["--store", cli["store"], "--ckpt",
                                     cli["ckpt"], "--serve-arg=--precompute"])
    check(r["errors"] == 0 and r["requests"] == 12_800,
          "loadgen: every request answered, no error")
    lane.wait("quality")  # its dataset, in the bench cache
    r, _ = tool("quality_calibrated", quality_calibrated,
                ["--scale", "ml20m", "--epochs", str(TOOL_EPOCHS), "--out",
                 os.path.join(tmp, "quality")])
    for x in r["results"]:
        check(x["hit_at_n"][-1] > x["hit_at_n"][0],
              f"quality_calibrated {x['algo']}: hit@10 rises")
    log(f"tools phase kernel launches: {launches}")
    out["launches"] = launches
    return out


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs the port on a GPU only", file=sys.stderr)
        sys.exit(1)
    with tempfile.TemporaryDirectory(prefix="ycnr_smoke_cache_") as cache:
        # the bench cache of every bench and tool run of this script, the
        # subprocesses' too (they inherit the environment)
        os.environ["YCNR_BENCH_CACHE"] = cache
        run(torch.device("cuda", 0))


def run(dev):
    import ycnr_tpu_torch

    ycnr_tpu_torch.full_precision_matmul()
    name = torch.cuda.get_device_name(dev)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60).stdout.strip()
    log(f"device: {name} x {torch.cuda.device_count()}; torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}")
    log(f"nvidia-smi: {smi}")
    # the host lane makes the main path's data and the later phases' host
    # builds in a process of its own while the kernels build (nvcc) and the
    # kernel phases that need no data run
    lane = HostLane()
    try:
        run_phases(dev, name, smi, lane)
    finally:
        lane.close()


def run_phases(dev, name: str, smi: str, lane: "HostLane"):
    from ycnr_tpu_torch.eval.recommend import (_topn_blocks, bits_tensor,
                                               build_rated_bits,
                                               recommend_all)
    from ycnr_tpu_torch.models.base import (device_layout, init_state,
                                            rmse_padded)
    from ycnr_tpu_torch.models.bucketed_phase import (als_epoch_fn,
                                                      device_bucketed)
    from ycnr_tpu_torch.ops import _build, fused_topn
    from ycnr_tpu_torch.serve.cache import RecCache
    from ycnr_tpu_torch.serve.engine import Recommender
    from ycnr_tpu_torch.ops.layout import build_blocked_csr, pad_coo
    from ycnr_tpu_torch.tools import bench as tbench

    t0 = time.time()
    _build.load_library()
    log(f"build: kernels compiled and loaded in {time.time() - t0:.1f} s "
        f"(beside the host lane)")
    phase_ingest()
    k1 = phase_k1(dev)
    sync()
    k1_wide = phase_k1_wide(dev)
    sync()
    k2 = phase_k2(dev)
    sync()
    gather = phase_gather(dev)
    sync()
    # the gather probes, reduced (no data: they run while the host lane
    # makes the main path's)
    from ycnr_tpu_torch.tools import bench_gather, probe_gather

    reset_launches()
    probe_gather.main(["--m", "20", "--iters", "3", "--gram"])
    bench_gather.main(["--steps", "5", "--gram"])
    bench_gather.main(["--steps", "5", "--dtype", "f32"])
    sync()
    probe_launches = read_launches()
    log(f"gather probes kernel launches: {probe_launches}")
    check(probe_launches["take_along_rows"] > 0,
          "take_along_rows launched on the probes")

    # ---- main path, exactly as bench.py runs it -------------------------
    # on the arrays in the port's bench cache (the script's own directory),
    # which every later bench and tool run reads; layouts cached there too
    n_users, n_items, rank, lam = (MAIN[k] for k in ("n_users", "n_items",
                                                     "rank", "lam"))
    lane.wait("data")
    (tu, ti, tr), (su, si, sr) = tbench.cached_coo(
        n_users, n_items, MAIN["n_ratings"], 0)
    u, i, r = (np.load(os.path.join(lane.dir, f"{k}.npy"))
               for k in ("u", "i", "r"))
    lane.wait("bucketed")
    data_tag = tbench.coo_tag(n_users, n_items, MAIN["n_ratings"], 0)
    ul, il = tbench.cached_layouts(tu, ti, tr, n_users, n_items, 32, rank,
                                   "bucketed", MAIN["groups"], data_tag)
    log(f"layouts (from the bench cache): user rows per group "
        f"{[g.rows for g in ul]}, item rows per group {[g.rows for g in il]}")
    dul = device_bucketed(ul, torch.float32, dev,
                          rating_dtype=torch.bfloat16)
    dil = device_bucketed(il, torch.float32, dev,
                          rating_dtype=torch.bfloat16)
    state = init_state(n_users, n_items, rank, seed=0, device=dev)
    test_coo = tuple(torch.as_tensor(x, device=dev) for x in
                     pad_coo(su, si, sr, n_users, n_items, 8192)[:3]) + (
        len(sr),)
    gram = phase_fused_gram(state, dul, dil)
    gram_w = phase_fused_gram_widths(dul, n_items, smi)
    epoch = als_epoch_fn(dul, dil, lam, gather_bf16=True)
    sync()

    reset_launches()
    rmse, times, main_by_kernel = [], [], {}
    for ep in range(4):
        t0 = time.time()
        if ep == 2:  # epoch 3: where the time goes, by kernel
            state, dev_ms = profile_breakdown(lambda: epoch(state),
                                              "epoch 3", main_by_kernel)
        else:
            state = epoch(state)
        sync()
        times.append(time.time() - t0)
        rmse.append(float(rmse_padded(state, *test_coo)))
        log(f"epoch {ep + 1}: {times[-1]:.4f} s, held-out rmse "
            f"{rmse[-1]:.6f} (reference {ANCHOR_RMSE[ep]})")
    rec = Recommender(state, tu, ti, cache=RecCache(capacity=2 * n_users))
    t0 = time.time()
    n_cached = rec.precompute_all(n=10, method="fused")
    sync()
    precompute_s = time.time() - t0
    launches = read_launches()
    log(f"main path kernel launches: {launches}")
    check(launches["spd_solve"] > 0, "K1 launched on the main path")
    check(launches["fused_gram"] > 0,
          "fused_gram launched on the main path")
    check(launches["guarded_batched_solve (calls)"] == 0,
          "the fused branch runs no ridge or symmetrize pass "
          "(no guarded_batched_solve)")
    check(launches["fused_scores"] > 0, "K2 launched on the main path")
    for ep, (got, want, pr2) in enumerate(zip(rmse, ANCHOR_RMSE, PR2_RMSE)):
        check(abs(got - want) <= RMSE_TOL,
              f"epoch {ep + 1} rmse {got:.6f} within {RMSE_TOL} of {want}")
        check(abs(got - pr2) <= PR2_RMSE_TOL,
              f"epoch {ep + 1} rmse {got:.6f} within {PR2_RMSE_TOL} of "
              f"PR 2's {pr2} (only the summation order changed)")
    wall = (times[1] + times[3]) / 2
    log(f"s/epoch, epochs 2-4: {times[1]:.4f} {times[2]:.4f} (profiled) "
        f"{times[3]:.4f}; epochs 2 and 4 mean {wall:.4f} (PR 3: "
        f"{PR3_S_EPOCH}, PR 2: {PR2_S_EPOCH}, PR 1: {PR1_S_EPOCH} on the "
        f"same card type) on "
        f"{smi}; epoch 3's device time is {dev_ms / 1e3 / wall:.3f} of that "
        f"wall (device idle {1 - dev_ms / 1e3 / wall:.3f})")
    for ep, (got, want) in enumerate(zip(rmse, PR2_RMSE)):
        log(f"epoch {ep + 1} rmse {got:.6f}: |diff| to PR 2's trajectory "
            f"{abs(got - want):.2e}")
    n_rated = int(np.unique(tu).size)
    check(n_cached == n_rated, f"precompute_all cached {n_cached} of "
          f"{n_rated} rated users")
    log(f"precompute_all(fused): {n_cached:,} users in {precompute_s:.2f} s "
        f"wall, host layout build included")
    sync()

    # ---- serving checks -------------------------------------------------
    rng = np.random.default_rng(1)
    sample = np.sort(rng.choice(np.unique(tu), SAMPLE_USERS, replace=False))
    keep = np.isin(tu, sample)
    slay = build_blocked_csr(tu[keep], ti[keep], tr[keep], n_users, n_items,
                             32, rank_hint=rank)
    sbits = build_rated_bits(slay, n_items)
    st16 = state._replace(U=state.U.bfloat16().float(),
                          V=state.V.bfloat16().float())
    ue, ie, ve = recommend_all(st16, slay, 10, sbits, method="exact")
    uf, if32, vf32 = recommend_all(state, slay, 10, sbits, method="fused32")
    check(np.array_equal(ue, uf) and len(ue) == SAMPLE_USERS,
          "sample users served")
    same = ids_equal_up_to_ties(if32, vf32, ie, ve, tol=TIE_TOL)
    log(f"fused32 vs exact on bf16-rounded factors ({len(ue)} users): ids "
        f"equal up to ties: {same}; rows with identical id sets "
        f"{np.mean([set(a) == set(b) for a, b in zip(if32, ie)]):.4f}")
    check(same, "fused32 ids equal the exact scorer's up to ties")
    _, ib, _ = recommend_all(state, slay, 10, sbits, method="fused")
    _, ix, _ = recommend_all(state, slay, 10, sbits, method="exact")
    overlap = np.mean([len(set(a) & set(b)) / 10 for a, b in zip(ib, ie)])
    overlap32 = np.mean([len(set(a) & set(b)) / 10 for a, b in zip(ib, ix)])
    U16 = st16.U.double().cpu().numpy()
    V16 = st16.V.double().cpu().numpy()
    true_b = np.einsum("uk,unk->un", U16[ue], V16[ib])
    nth = ve[:, -1:].astype(np.float64)
    within = true_b >= nth - BF16_REL * np.abs(nth) - TIE_TOL
    log(f"fused (bf16 scores) top-10 overlap: {overlap:.5f} with the exact "
        f"scorer on the same bf16-rounded factors, {overlap32:.5f} with the "
        f"exact scorer on the f32 factors; picks within one bf16 step of "
        f"the exact 10th score: {within.mean():.5f}")
    check(bool(within.all()), "fused bf16 ids equal the exact scorer's up "
          "to ties at bf16 resolution")

    order = np.argsort(tu, kind="stable")
    tus, tis = tu[order], ti[order]
    rated = {int(x): set(tis[np.searchsorted(tus, x):
                             np.searchsorted(tus, x, "right")].tolist())
             for x in sample[:1024]}
    cached = [rec.cache.get((int(x), 10)) for x in sample[:1024]]
    rec.cache.invalidate()
    t0 = time.time()
    singles = [rec.recommend(int(x), 10) for x in sample[:64]]
    sync()
    single_s = (time.time() - t0) / 64
    t0 = time.time()
    batch = rec.recommend_batch(sample[:1024], 10)
    sync()
    batch_s = time.time() - t0
    for x, got in zip(list(sample[:1024]) * 2 + list(sample[:64]),
                      cached + batch + singles):
        check(len(got) == 10, f"user {x}: 10 items")
        check(not (set(got.tolist()) & rated[int(x)]),
              f"user {x}: no rated item served")
    log(f"requests: recommend() {1e3 * single_s:.2f} ms each (exact "
        f"scorer, cache cold); recommend_batch(1024) {batch_s:.3f} s = "
        f"{1024 / batch_s:,.0f} recs/s; no rated item served by the cache "
        f"(K2) or the requests")

    # both blocked views, from the bench cache (the user view serves; both
    # are kept for the mesh phase's resident run)
    lane.wait("blocked")
    lay, item_lay = tbench.cached_layouts(tu, ti, tr, n_users, n_items, 32,
                                          rank, "blocked", MAIN["groups"],
                                          data_tag)
    bits = bits_tensor(build_rated_bits(lay, n_items), dev)
    eids = torch.as_tensor(lay.entity_ids, device=dev)
    dlay = device_layout(lay, torch.float32, dev)
    served = int((lay.entity_ids < n_users).sum())
    fused_ms = cuda_ms(lambda: fused_topn.fused_topn_blocks(
        state, eids, bits, 10), iters=3, warmup=1)
    exact_ms = cuda_ms(lambda: _topn_blocks(state, dlay, 10, bits),
                       iters=3, warmup=1)
    profile_breakdown(lambda: fused_topn.fused_topn_blocks(
        state, eids, bits, 10), "one fused serving pass")
    log(f"serving pass, {served:,} users top-10: fused {fused_ms:.1f} ms = "
        f"{served / fused_ms * 1e3:,.0f} recs/s; exact {exact_ms:.1f} ms = "
        f"{served / exact_ms * 1e3:,.0f} recs/s; on {smi}")
    sync()

    # ---- blocked-layout path vs the bucketed path (f32 gathers) --------
    del dul, dil, epoch
    blocked_launches = phase_blocked(dev, lay, item_lay, ul, il, test_coo)
    del dlay, bits, eids
    sync()

    # ---- fold-in ---------------------------------------------------------
    fold_launches = phase_fold_in(state, tu, ti, tr)
    sync()

    # ---- online serving on the trained state -----------------------------
    online = phase_online(state, tu, ti, tr, smi)
    del rec
    sync()

    # ---- ranks 128 and 192 through train(), fold-in at 192 and 256 -------
    with tempfile.TemporaryDirectory() as tmp:
        r128 = phase_rank128(dev, tu, ti, tr, su, si, sr, tmp, smi)
        sync()
        wide = phase_rank192(dev, tu, ti, tr, su, si, sr, tmp, smi)
    sync()

    # ---- the command line, in process, at full width, then serving -------
    from ycnr_tpu_torch.native import get_cache_lib, get_shm_lib

    names = {tag: f"/ycnr_smoke_{os.getpid()}_{tag}"
             for tag in ("train", "serve", "cache")}
    free = shm_free_bytes()
    log(f"/dev/shm: {free:,} bytes free before any segment; the train "
        f"segment needs {factor_segment_bytes(n_users, n_items, rank):,}")
    check(free > factor_segment_bytes(n_users, n_items, rank),
          "/dev/shm has room for the train --publish-shm segment")
    try:
        with tempfile.TemporaryDirectory() as tmp:
            cli = phase_cli(dev, u, i, r, tu, ti, tr, su, si, sr, ul, il,
                            smi, tmp, names["train"])
            sync()
            serve = phase_serve(dev, u, i, cli, names, smi, tmp)
            sync()
            ooc = phase_ooc(dev, tu, ti, tr, su, si, sr, ul, il,
                            {"by_kernel": main_by_kernel}, cli, smi, tmp,
                            lane.wait("ooc"))
            sync()
            mesh = phase_mesh(dev, tu, ti, tr, su, si, sr, (lay, item_lay),
                              rmse, tmp, smi, lane.wait("mesh"))
            sync()
            ooc_mesh = phase_ooc_mesh(dev, tu, ti, tr, (lay, item_lay),
                                      mesh, rmse, cli, tmp, smi,
                                      lane.wait("ooc_mesh"))
            del lay, item_lay
            sync()
            # ---- the measuring layer: the bench, then the tools ---------
            bench_ph = phase_bench(dev, rmse, smi)
            sync()
            tools_ph = phase_tools(dev, rmse, cli, smi, tmp, lane)
    finally:  # a name already unlinked is a no-op
        get_shm_lib().ycnr_shm_unlink(names["train"].encode())
        get_shm_lib().ycnr_shm_unlink(names["serve"].encode())
        get_cache_lib().ycnr_cache_unlink(names["cache"].encode())
    sync()

    # ---- SGD (ml1m-sgd) and BPR (ml20m-bpr) through train() --------------
    from ycnr_tpu_torch.data.dataset import Dataset, load_dataset

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.time()
        ds1m = load_dataset(ml1m_sgd_config("batched", tmp).data,
                            rank_hint=16)
        log(f"data: ML-1M shape, {ds1m.n_users} x {ds1m.n_items}, "
            f"{len(ds1m.train_r):,} train / {len(ds1m.test_r):,} held-out "
            f"ratings in {time.time() - t0:.1f} s")
        sgd = phase_sgd(dev, ds1m, tmp, smi)
        sync()
        ds20m = Dataset(n_users=n_users, n_items=n_items, train_u=tu,
                        train_i=ti, train_r=tr, test_u=su, test_i=si,
                        test_r=sr, mu=float(tr.mean()), chunk_len=32,
                        rank_hint=32)
        bpr = phase_bpr(dev, ds1m, ds20m, tmp, smi)
        sync()
    narrow = phase_gather_narrow(dev, sgd, bpr["data"], bpr["rank"], smi)
    sync()

    # every rank-64 path runs K1's warp body only
    for what, ln in (("main path", launches), ("blocked", blocked_launches),
                     ("fold-in", fold_launches), ("add_ratings", online["add"]),
                     ("recommend_cold", online["cold"]),
                     ("train --publish-shm", serve["train"]),
                     ("serve cold:", serve["cold"]), ("ooc", ooc["launches"]),
                     ("mesh", mesh["launches"]),
                     ("ooc mesh", ooc_mesh["launches"]),
                     ("tools", tools_ph["launches"])):
        check(ln["spd_solve tiled"] == 0, f"{what}: K1's tiled body never "
              f"launched at rank 64")
    log(f"K1's tiled body: 0 launches on every rank-64 path; "
        f"{r128['launches']['spd_solve tiled']} in the rank-128 train(), "
        f"{wide['k1_n192']} at n = 192, {wide['k1_n256']} at n = 256")

    def measuring(key):
        """Launches of the bench's and the tools' in-process runs."""
        return bench_ph["launches"][key] + tools_ph["launches"][key]

    row, take = gather["row_gather"], gather["take_along_rows"]
    kernels = [
        {"name": "spd_solve", "route": "cuda",
         "source": "ycnr_tpu_torch/csrc/spd_solve.cu",
         "replaces": "ycnr_tpu/ops/pallas_solve.py:355",
         "launches": launches["spd_solve"] + serve["train"]["spd_solve"]
         + serve["cold"]["spd_solve"] + ooc["launches"]["spd_solve"]
         + mesh["launches"]["spd_solve"]
         + ooc_mesh["launches"]["spd_solve"] + measuring("spd_solve")
         - measuring("spd_solve tiled"),
         "max_abs_err": k1["max_abs_err"], "ms": k1["ms"],
         "plain_ms": k1["plain_ms"], "bound_ms": k1["bound_ms"],
         "bound_by": k1["bound_by"], "library_ms": k1["library_ms"]},
        {"name": "fused_scores", "route": "cuda",
         "source": "ycnr_tpu_torch/csrc/fused_topn.cu",
         "replaces": "ycnr_tpu/ops/pallas_topn.py:100",
         "launches": launches["fused_scores"] + bpr["k2_launches"]
         + serve["precompute"]["fused_scores"]
         + mesh["launches"]["fused_scores"] + measuring("fused_scores"),
         "max_abs_err": max(k2["bf16"]["max_abs_err"],
                            k2["f32"]["max_abs_err"]),
         "ms": k2["bf16"]["ms"], "plain_ms": k2["bf16"]["plain_ms"],
         "bound_ms": k2["bf16"]["bound_ms"],
         "bound_by": k2["bf16"]["bound_by"], "library_ms": None},
        {"name": "row_gather", "route": "cuda",
         "source": "ycnr_tpu_torch/csrc/row_gather.cu",
         "replaces": "tools/probe_gather.py:94, tools/probe_gather.py:136, "
                     "tools/bench_pallas_gather.py:106, "
                     "tools/bench_pallas_gather.py:184",
         "launches": blocked_launches["row_gather"]
         + fold_launches["row_gather"] + online["add"]["row_gather"]
         + online["cold"]["row_gather"] + serve["cold"]["row_gather"]
         + ooc["launches"]["row_gather"] + mesh["launches"]["row_gather"]
         + ooc_mesh["launches"]["row_gather"] + measuring("row_gather"),
         "max_abs_err": row["max_abs_err"], "ms": row["ms"],
         "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
         "bound_by": row["bound_by"], "library_ms": row["library_ms"]},
    ] + [
        # the same kernel at the row widths of the SGD and BPR epochs, with
        # the launches of that trainer's run through train()
        {"name": f"row_gather ({what})", "route": "cuda",
         "source": "ycnr_tpu_torch/csrc/row_gather.cu",
         "replaces": "tools/probe_gather.py:94",
         "launches": n_launch, "max_abs_err": narrow[key]["max_abs_err"],
         "ms": narrow[key]["ms"], "plain_ms": narrow[key]["plain_ms"],
         "bound_ms": narrow[key]["bound_ms"],
         "bound_by": narrow[key]["bound_by"],
         "library_ms": narrow[key]["library_ms"]}
        for key, what, n_launch in (
            ("w64", "64-byte rows, batched SGD", sgd["batched"]["launches"]),
            ("w68", "68-byte rows, stream SGD", sgd["stream"]["launches"]),
            ("w136", "136-byte rows, BPR", bpr["launches"]))
    ] + [
        {"name": "take_along_rows", "route": "cuda",
         "source": "ycnr_tpu_torch/csrc/row_gather.cu",
         "replaces": "tools/probe_gather.py:170",
         "launches": probe_launches["take_along_rows"],
         "max_abs_err": take["max_abs_err"], "ms": take["ms"],
         "plain_ms": take["plain_ms"], "bound_ms": take["bound_ms"],
         "bound_by": take["bound_by"], "library_ms": take["library_ms"]},
        {"name": "fused_gram", "route": "cuda",
         "source": "ycnr_tpu_torch/csrc/fused_gram.cu",
         "replaces": "tools/probe_gather.py:207",
         "launches": launches["fused_gram"] + serve["train"]["fused_gram"]
         + ooc["launches"]["fused_gram"]
         + ooc_mesh["launches"]["fused_gram"] + measuring("fused_gram"),
         "max_abs_err": gram["max_abs_err"], "ms": gram["ms"],
         "plain_ms": gram["plain_ms"], "bound_ms": gram["bound_ms"],
         "bound_by": gram["bound_by"], "library_ms": None},
    ] + [
        # fused_gram's wide body, timed on one user phase at w 192 / 256,
        # with the launches of the rank-192 train() runs (resident and out
        # of core) and of the rank-256 epoch
        {"name": f"fused_gram w{w} (wide body)", "route": "cuda",
         "source": "ycnr_tpu_torch/csrc/fused_gram.cu",
         "replaces": "tools/probe_gather.py:207", "launches": n_launch,
         "max_abs_err": gram_w[w]["max_abs_err"], "ms": gram_w[w]["ms"],
         "plain_ms": gram_w[w]["plain_ms"],
         "bound_ms": gram_w[w]["bound_ms"],
         "bound_by": gram_w[w]["bound_by"], "library_ms": None}
        for w, n_launch in ((192, wide["fg_w192"]), (256, wide["fg_w256"]))
    ] + [
        # K1's tiled body, with the launches of the rank-128 train() at n
        # 128, of the rank-192 path (train() and fold-in) at 192 and of
        # fold-in at rank 256
        {"name": f"K1 n{n}", "route": "cuda",
         "source": "ycnr_tpu_torch/csrc/spd_solve.cu",
         "replaces": "ycnr_tpu/ops/pallas_solve.py:355",
         "launches": n_launch, "max_abs_err": k1_wide[n]["max_abs_err"],
         "ms": k1_wide[n]["ms"], "plain_ms": k1_wide[n]["plain_ms"],
         "bound_ms": k1_wide[n]["bound_ms"],
         "bound_by": k1_wide[n]["bound_by"],
         "library_ms": k1_wide[n]["library_ms"]}
        for n, n_launch in ((128, r128["launches"]["spd_solve tiled"]
                             + measuring("spd_solve tiled")),
                            (192, wide["k1_n192"]), (256, wide["k1_n256"]))
    ]
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
