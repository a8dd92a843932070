"""Smoke run of the PyTorch/CUDA port (``ycnr_tpu_torch``) on one GPU.

Run from the repository root:  python3 chip_smoke.py

1. device: needs CUDA (exits 1 without it; there is no CPU path);
2. build: compiles the CUDA kernels from ``ycnr_tpu_torch/csrc``;
3. K1 (batched SPD solve) against its plain version in float64, n = 10,
   32, 64, 128, with padding and ill-conditioned (guarded) systems;
4. K2 (fused masked scorer) against its plain version on one
   MovieLens-20M-width serving block, bf16 and f32 score buffers;
5. the main path as ``bench.py`` runs it: ALS-WR rank 64 on the
   ML-20M-shaped synthetic set, bucketed layout (8 groups), bf16 gathers,
   4 epochs with held-out RMSE, held to the reference trajectory;
6. serving: ``Recommender.precompute_all`` through K2 for every user,
   checked against the exact scorer on a sample, plus single and batch
   requests;
7. both kernels must have launched on the main path.

Every failed check raises, so the exit code is nonzero. Stdout ends with a
JSON line of per-kernel results and, last, ``{"ok": true, "device": ...}``.
"""

from __future__ import annotations

import json
import subprocess
import sys
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
    A, b, _ = guarded_systems(64, 20_000, seed=64, dev=dev)
    ms = cuda_ms(lambda: spd_solve_cuda(A, b))
    plain_ms = cuda_ms(lambda: spd_solve_reference(A, b))
    log(f"K1 n=64 B=20000: kernel {ms:.4f} ms, plain (torch.linalg."
        f"cholesky + cholesky_solve, f32) {plain_ms:.4f} ms")
    return {"max_abs_err": worst_abs, "max_rel_err": worst_rel, "ms": ms,
            "plain_ms": plain_ms}


def random_rated_bits(n_users: int, n_items: int, density: float, seed: int):
    """Packed rated bits in the build_rated_bits layout for a random mask."""
    rng = np.random.default_rng(seed)
    w = 4 * (-(-(n_items + 1) // 128))
    mask = np.zeros((n_users, w * 32), bool)
    mask[:, :n_items] = rng.random((n_users, n_items)) < density
    mask[:, n_items:] = True  # trash and pad columns are always masked
    return np.packbits(mask, axis=1, bitorder="little").view("<u4")


def phase_k2(dev) -> dict:
    from ycnr_tpu_torch.eval.recommend import bits_tensor
    from ycnr_tpu_torch.ops.fused_topn import fused_scores_cuda, \
        fused_scores_reference

    n_users, n_items, k = 4096, 26_744, 64
    rng = np.random.default_rng(7)
    bits_np = random_rated_bits(n_users, n_items, 0.01, seed=8)
    m = bits_np.shape[1] * 32
    V = np.zeros((m, k), np.float32)
    V[:n_items] = rng.normal(0, 0.5, (n_items, k))
    bi = np.zeros(m, np.float32)
    bi[:n_items] = rng.normal(0, 0.1, n_items)
    rows = torch.as_tensor(rng.normal(0, 0.5, (n_users, k)), device=dev,
                           dtype=torch.float32).to(torch.bfloat16)
    Vt = torch.as_tensor(V, device=dev).to(torch.bfloat16)
    bit = torch.as_tensor(bi, device=dev)
    bits = bits_tensor(bits_np, dev)
    out = {}
    for score_bf16 in (True, False):
        seg_k, s3_k = fused_scores_cuda(rows, Vt, bit, bits, score_bf16)
        seg_p, s3_p = fused_scores_reference(rows, Vt, bit, bits, score_bf16)
        sync()
        name = "bf16" if score_bf16 else "f32"
        diff = max((seg_k - seg_p).abs().max().item(),
                   (s3_k.float() - s3_p.float()).abs().max().item())
        log(f"K2 {name} scores, {n_users} users x {n_items} items, k={k}: "
            f"segmax equal {torch.equal(seg_k, seg_p)}, s3 equal "
            f"{torch.equal(s3_k, s3_p)}, max abs diff {diff}")
        check(torch.equal(seg_k, seg_p), f"K2 {name}: segmax exact")
        check(torch.equal(s3_k, s3_p), f"K2 {name}: s3 exact")
        ms = cuda_ms(lambda: fused_scores_cuda(rows, Vt, bit, bits,
                                               score_bf16))
        plain_ms = cuda_ms(lambda: fused_scores_reference(
            rows, Vt, bit, bits, score_bf16), iters=3, warmup=1)
        log(f"K2 {name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
        out[name] = {"max_abs_err": diff, "ms": ms, "plain_ms": plain_ms}
    return out


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


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs the port on a GPU only", file=sys.stderr)
        sys.exit(1)
    run(torch.device("cuda", 0))


def run(dev):
    import ycnr_tpu_torch
    from ycnr_tpu_torch.eval.recommend import (_layout_tensors, _topn_blocks,
                                               bits_tensor, build_rated_bits,
                                               recommend_all)
    from ycnr_tpu_torch.models.base import init_state, rmse_padded
    from ycnr_tpu_torch.models.bucketed_phase import (als_epoch_fn,
                                                      device_bucketed)
    from ycnr_tpu_torch.ops import _build, fused_topn, spd_solve
    from ycnr_tpu_torch.serve.cache import RecCache
    from ycnr_tpu_torch.serve.engine import Recommender
    from ycnr_tpu_torch.shared import (build_blocked_csr, build_bucketed,
                                       pad_coo, synthetic_ratings,
                                       train_test_split)

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

    k1 = phase_k1(dev)
    sync()
    k2 = phase_k2(dev)
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
    dul = device_bucketed(ul, torch.float32, dev)
    dil = device_bucketed(il, torch.float32, dev)
    state = init_state(n_users, n_items, rank, seed=0, device=dev)
    test_coo = tuple(torch.as_tensor(x, device=dev) for x in
                     pad_coo(su, si, sr, n_users, n_items, 8192)[:3]) + (
        len(sr),)
    epoch = als_epoch_fn(dul, dil, lam, gather_bf16=True)
    sync()

    spd_solve.launches = 0
    fused_topn.launches = 0
    rmse, times = [], []
    for ep in range(4):
        t0 = time.time()
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
    launches = {"spd_solve": spd_solve.launches,
                "fused_scores": fused_topn.launches}
    log(f"main path kernel launches: {launches}")
    check(launches["spd_solve"] > 0, "K1 launched on the main path")
    check(launches["fused_scores"] > 0, "K2 launched on the main path")
    for ep, (got, want) in enumerate(zip(rmse, ANCHOR_RMSE)):
        check(abs(got - want) <= RMSE_TOL,
              f"epoch {ep + 1} rmse {got:.6f} within {RMSE_TOL} of {want}")
    log(f"s/epoch, epochs 2-4: {times[1]:.4f} {times[2]:.4f} "
        f"{times[3]:.4f} (median {float(np.median(times[1:])):.4f}) on "
        f"{smi}")
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
    dlay = _layout_tensors(lay, dev)
    served = int((lay.entity_ids < n_users).sum())
    fused_ms = cuda_ms(lambda: fused_topn.fused_topn_blocks(
        state, eids, bits, 10), iters=3, warmup=1)
    exact_ms = cuda_ms(lambda: _topn_blocks(state, dlay, 10, bits),
                       iters=3, warmup=1)
    log(f"serving pass, {served:,} users top-10: fused {fused_ms:.1f} ms = "
        f"{served / fused_ms * 1e3:,.0f} recs/s; exact {exact_ms:.1f} ms = "
        f"{served / exact_ms * 1e3:,.0f} recs/s; on {smi}")
    sync()

    kernels = [
        {"name": "spd_solve", "route": "cuda",
         "source": "ycnr_tpu_torch/csrc/spd_solve.cu",
         "replaces": "ycnr_tpu/ops/pallas_solve.py:355",
         "launches": launches["spd_solve"],
         "max_abs_err": k1["max_abs_err"], "ms": k1["ms"],
         "plain_ms": k1["plain_ms"]},
        {"name": "fused_scores", "route": "cuda",
         "source": "ycnr_tpu_torch/csrc/fused_topn.cu",
         "replaces": "ycnr_tpu/ops/pallas_topn.py:100",
         "launches": launches["fused_scores"],
         "max_abs_err": max(k2["bf16"]["max_abs_err"],
                            k2["f32"]["max_abs_err"]),
         "ms": k2["bf16"]["ms"], "plain_ms": k2["bf16"]["plain_ms"]},
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
