"""Smoke run of the PyTorch/CUDA port (``ycnr_tpu_torch``) on one GPU.

Run from the repository root:  python3 chip_smoke.py

1. device: needs CUDA (exits 1 without it; there is no CPU path);
2. build: compiles the CUDA kernels (nvcc) and the native MovieLens parser
   (g++) from ``ycnr_tpu_torch/csrc``; the parser is held to the Python
   parser on a 200,000-row file;
3. K1 (batched SPD solve) against its plain version in float64, n = 10,
   32, 64, 128, with padding and ill-conditioned (guarded) systems; timed
   beside the plain solve and ``torch.linalg.solve`` at B = 20,000, and
   alone at B = 8 and B = 256;
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
   ML-20M-shaped synthetic set, bucketed layout (8 groups), bf16 gathers
   through the fused gather -> Gram kernel with the ridge in its epilogue
   (first held to its bound on the smallest-R and largest-R blocks of both
   layouts), then K1; 4 epochs with held-out RMSE, held to the reference
   trajectory and to PR 2's; epoch 3 profiled by kernel;
7. serving: ``Recommender.precompute_all`` through K2 for every user,
   checked against the exact scorer on a sample, plus single and batch
   requests; one serving pass profiled by kernel;
8. the blocked-layout path (``ALSWR``, ``ImplicitALS``: row gather,
   sorted-segment sums, K1) at full width: every block's gather bit-equal
   to plain indexing, then the path against the bucketed path with f32
   gathers from the same start, held-out RMSE to 1e-4;
9. fold-in of 256 users against a float64 solve, no rated item served;
10. the two gather probes at a reduced size (``take_along_rows``);
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
    ``recommend_cold``.

Every path runs with the kernels' launch counts set to 0 just before it,
and each kernel must have launched on the paths that use it. Every failed
check raises, so the exit code is nonzero. Stdout ends with the card's
name and power limit (``nvidia-smi``), a JSON line of per-kernel results
(time, plain time, one PyTorch call's time, bound) and, last,
``{"ok": true, "device": ...}``.
"""

from __future__ import annotations

import json
import os
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


def log(*a):
    print(*a, flush=True)


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
    from ycnr_tpu_torch.ops.spd_solve import spd_solve_cuda, \
        spd_solve_reference

    worst_rel = worst_abs = 0.0
    for n in (10, 32, 64, 128):
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
    # in turns: plain, kernel, library, kernel, plain
    plain_ms = cuda_ms(lambda: spd_solve_reference(A, b))
    ms = cuda_ms(lambda: spd_solve_cuda(A, b))
    lib_ms = cuda_ms(lambda: torch.linalg.solve(A, b))
    ms = min(ms, cuda_ms(lambda: spd_solve_cuda(A, b)))
    plain_ms = min(plain_ms, cuda_ms(lambda: spd_solve_reference(A, b)))
    # read A and b, write x; Cholesky n^3/3 + two triangular solves n^2 FMA
    bnd = bound_ms(4 * B * (n * n + 2 * n),
                   2 * B * (n ** 3 / 3 + n * n), PEAK_F32)
    log(f"K1 n={n} B={B}: kernel {ms:.4f} ms, plain (torch.linalg."
        f"cholesky + cholesky_solve, f32) {plain_ms:.4f} ms, "
        f"torch.linalg.solve {lib_ms:.4f} ms, bound {bnd[0]:.4f} ms "
        f"({bnd[1]})")
    from ycnr_tpu_torch.tools.probe_gather import graph_ms

    # calls with few systems (the epoch's longest rating lists come 8 to a
    # call): device time over a CUDA graph, as a call is shorter than the
    # host's launch
    for small in (8, 256):
        As, bs = A[:small].contiguous(), b[:small].contiguous()
        log(f"K1 n={n} B={small}: kernel "
            f"{graph_ms(lambda: spd_solve_cuda(As, bs), 20):.4f} ms "
            f"(device time, CUDA graph of 20 calls)")
    return {"max_abs_err": worst_abs, "max_rel_err": worst_rel, "ms": ms,
            "plain_ms": plain_ms, "library_ms": lib_ms, "bound_ms": bnd[0],
            "bound_by": bnd[1]}


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


def phase_ingest():
    """The native parser, built here, against the Python parser on an
    ML-20M-format file with a header (host code; no kernel)."""
    from ycnr_tpu_torch.data import movielens, native
    from ycnr_tpu_torch.tools.bench_ingest import generate

    t0 = time.time()
    check(native.load_library() is not None, "the native parser built")
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
    row_gather.take_launches = 0
    gram.guarded_solves = 0


def read_launches() -> dict:
    from ycnr_tpu_torch.ops import fused_gram, fused_topn, gram, row_gather, \
        spd_solve

    return {"spd_solve": spd_solve.launches,
            "fused_scores": fused_topn.launches,
            "row_gather": row_gather.launches,
            "take_along_rows": row_gather.take_launches,
            "fused_gram": fused_gram.launches,
            "guarded_batched_solve (calls)": gram.guarded_solves}


def profile_breakdown(fn, what: str):
    """Run fn under torch.profiler and print the device time by kernel
    (kernel events only, so nothing is counted twice). Returns fn's result
    and the device milliseconds."""
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


def phase_blocked(dev, tu, ti, tr, user_lay, ul, il, test_coo) -> dict:
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
    from ycnr_tpu_torch.ops.layout import build_blocked_csr

    n_users, n_items, rank, lam = (MAIN[k] for k in ("n_users", "n_items",
                                                     "rank", "lam"))
    t0 = time.time()
    item_lay = build_blocked_csr(ti, tu, tr, n_items, n_users, 32,
                                 rank_hint=rank)
    log(f"blocked layouts: item layout built in {time.time() - t0:.1f} s; "
        f"user blocks {user_lay.other_idx.shape}, item blocks "
        f"{item_lay.other_idx.shape}")
    dlu = device_layout(user_lay, torch.float32, dev)
    dli = device_layout(item_lay, torch.float32, dev)
    del item_lay

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


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs the port on a GPU only", file=sys.stderr)
        sys.exit(1)
    run(torch.device("cuda", 0))


def run(dev):
    import ycnr_tpu_torch
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
    from ycnr_tpu_torch.data.split import train_test_split
    from ycnr_tpu_torch.data.synthetic import synthetic_ratings
    from ycnr_tpu_torch.ops.bucketed import build_bucketed
    from ycnr_tpu_torch.ops.layout import build_blocked_csr, pad_coo

    ycnr_tpu_torch.full_precision_matmul()
    name = torch.cuda.get_device_name(dev)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60).stdout.strip()
    log(f"device: {name} x {torch.cuda.device_count()}; torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}")
    log(f"nvidia-smi: {smi}")

    t0 = time.time()
    _build.load_library()
    log(f"build: kernels compiled and loaded in {time.time() - t0:.1f} s")

    phase_ingest()
    k1 = phase_k1(dev)
    sync()
    k2 = phase_k2(dev)
    sync()
    gather = phase_gather(dev)
    sync()

    # ---- main path, exactly as bench.py runs it -------------------------
    n_users, n_items, rank, lam = (MAIN[k] for k in ("n_users", "n_items",
                                                     "rank", "lam"))
    t0 = time.time()
    u, i, r = synthetic_ratings(n_users, n_items, MAIN["n_ratings"],
                                true_rank=16,
                                noise=0.3, seed=0)
    (tu, ti, tr), (su, si, sr) = train_test_split(u, i, r, 0.05, 0)
    log(f"data: {len(r):,} ratings in {time.time() - t0:.1f} s")
    t0 = time.time()
    ul = build_bucketed(tu, ti, tr, n_users, n_items, 32, rank,
                        max_groups=MAIN["groups"])
    il = build_bucketed(ti, tu, tr, n_items, n_users, 32, rank,
                        max_groups=MAIN["groups"])
    log(f"layouts: {time.time() - t0:.1f} s; user rows per group "
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
    epoch = als_epoch_fn(dul, dil, lam, gather_bf16=True)
    sync()

    reset_launches()
    rmse, times = [], []
    for ep in range(4):
        t0 = time.time()
        if ep == 2:  # epoch 3: where the time goes, by kernel
            state, dev_ms = profile_breakdown(lambda: epoch(state),
                                              "epoch 3")
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

    lay = build_blocked_csr(tu, ti, tr, n_users, n_items, 32, rank_hint=rank)
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
    blocked_launches = phase_blocked(dev, tu, ti, tr, lay, ul, il, test_coo)
    del lay, dlay, bits, eids
    sync()

    # ---- fold-in ---------------------------------------------------------
    fold_launches = phase_fold_in(state, tu, ti, tr)
    sync()

    # ---- online serving on the trained state -----------------------------
    online = phase_online(state, tu, ti, tr, smi)
    del rec
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

    # ---- the gather probes, reduced --------------------------------------
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

    row, take = gather["row_gather"], gather["take_along_rows"]
    kernels = [
        {"name": "spd_solve", "route": "cuda",
         "source": "ycnr_tpu_torch/csrc/spd_solve.cu",
         "replaces": "ycnr_tpu/ops/pallas_solve.py:355",
         "launches": launches["spd_solve"],
         "max_abs_err": k1["max_abs_err"], "ms": k1["ms"],
         "plain_ms": k1["plain_ms"], "bound_ms": k1["bound_ms"],
         "bound_by": k1["bound_by"], "library_ms": k1["library_ms"]},
        {"name": "fused_scores", "route": "cuda",
         "source": "ycnr_tpu_torch/csrc/fused_topn.cu",
         "replaces": "ycnr_tpu/ops/pallas_topn.py:100",
         "launches": launches["fused_scores"] + bpr["k2_launches"],
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
         + online["cold"]["row_gather"],
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
         "launches": launches["fused_gram"],
         "max_abs_err": gram["max_abs_err"], "ms": gram["ms"],
         "plain_ms": gram["plain_ms"], "bound_ms": gram["bound_ms"],
         "bound_by": gram["bound_by"], "library_ms": None},
    ]
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
