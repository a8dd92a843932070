"""Fused masked scorer for bulk top-n serving: K2, its plain version, and
the two-level top-n select around it.

Counterpart of ``ycnr_tpu/ops/pallas_topn.py``. Per layout block the scorer
computes, for every user row and every catalog item j,
``s = rows . V[j] + bi[j]`` from bf16 inputs with an f32 sum, masks rated
items to ``NEG_INF`` straight from the packed ``build_rated_bits`` words,
and returns per-128-item-segment maxima of the f32 scores (``segmax``)
plus the masked scores stored compact (``s3``, bf16 or f32). The top-n
segments are then chosen exactly from ``segmax`` and the top-n items taken
among their ``n * 128`` candidates.

Unlike the TPU kernel, kernel slot j is catalog item j: the item
permutation that ``pltpu.repeat``'s tiling forced there has no counterpart.

Numbers. K2 (``csrc/fused_topn.cu``) multiplies on the tensor cores, the
plain version sums in k order; every product of two bf16 values is exact
in f32, so the two differ only in how the sums are rounded. Write
``P = sum_k |r_k| |v_k|``. The plain version adds k terms and the bias
with round-to-nearest: at most ``(k + 1) 2^-24 (P + |bi|)`` from the
exact sum. An ``mma`` step adds 16 products to the accumulator after
aligning them to the largest exponent and may truncate, which costs at
most 18 ulps of the largest of those 17 terms, i.e. ``36 2^-24`` of their
absolute sum; K2 takes ``ceil(k / 16)`` such steps and then adds the bias
with round-to-nearest. Together, with a factor of two to spare::

    |s - s_plain| <= c(k) 2^-24 (P + |bi|),  c(k) = 2 (36 ceil(k/16) + k + 2)
    |s - s_f64|   <= c64(k) 2^-24 (P + |bi|), c64(k) = 2 (36 ceil(k/16) + 1)

(``fused_scores_bound``; c(64) = 420). ``segmax`` is within the largest
bound of its segment. A bf16 ``s3`` rounds scores that differ by that
much, so its entries may differ by one bf16 step (``2^-7 |s|``) more.
What is exact stays exact, in both versions: a rated or padding column
is ``NEG_INF``; with f32 scores ``segmax == s3.amax(2)``; with bf16 scores
``segmax.bfloat16() == s3.amax(2)`` (rounding is monotone).
"""

from __future__ import annotations

import torch

from ycnr_tpu_torch.ops import _build
from ycnr_tpu_torch.utils.profiling import span

NEG_INF = -3.0e38  # matches eval.recommend.NEG_INF (finite: no inf - inf)

SEG_LEN = 128  # score segment length; the rated-bits words align to it
MAX_K = 256
# K2's grid: blocks of 128 users (64 above k = 128, where a stage of V is
# larger) by runs of consecutive segments, about _BLOCKS_PER_SM blocks for
# every SM of the card
_BLOCKS_PER_SM = 8

launches = 0  # K2 launches since the last reset (chip_smoke reads it)


def fused_supported(n_items: int, n: int) -> bool:
    """Shape gate: the two-level select needs more segments than n."""
    s = -(-(n_items + 1) // SEG_LEN)
    return s > n and n <= 64


def partition(u_b: int, k: int, n_seg: int, sms: int):
    """K2's work split: (users per block, segments per block). Block
    (i, j) scores users [i tile, (i + 1) tile) against segments
    [j run, (j + 1) run), both cut at the arrays' ends. The run is the
    longest that still gives the card ``_BLOCKS_PER_SM * sms`` blocks."""
    tile = 128 if k <= 128 else 64
    tiles = -(-u_b // tile)
    runs = max(1, min(n_seg, -(-_BLOCKS_PER_SM * sms // tiles)))
    return tile, -(-n_seg // runs)


def fused_scores_bound(rows, V, bi, f64: bool = False) -> torch.Tensor:
    """[U_B, M] elementwise tolerance between K2's f32 scores and the plain
    version's (module docstring), or a float64 sum's with ``f64``."""
    k = rows.shape[1]
    steps = -(-k // 16)
    c = 2.0 * (36 * steps + 1) if f64 else 2.0 * (36 * steps + k + 2)
    dt = torch.float64 if f64 else torch.float32
    P = rows.abs().to(dt) @ V.abs().to(dt).T
    return c * 2.0 ** -24 * (P + bi.abs().to(dt)[None, :])


def fused_scores_reference(rows, V, bi, bits, score_bf16: bool):
    """The plain version of K2.

    rows [U_B, k] bf16, V [M, k] bf16 (M = 128 * S), bi [M] f32,
    bits [U_B, 4 * S] int32 -> (segmax [U_B, S] f32, s3 [U_B, S, 128]).
    The dot product is summed in k order in f32; the kernel's tensor-core
    sum agrees with it within ``fused_scores_bound``.
    """
    u_b, k = rows.shape
    m = V.shape[0]
    r = rows.float()
    v = V.float()
    acc = torch.zeros(u_b, m, dtype=torch.float32, device=rows.device)
    for kk in range(k):
        acc += r[:, kk, None] * v[None, :, kk]
    s = acc + bi[None, :]
    j = torch.arange(m, device=rows.device)
    word = bits[:, j >> 5]
    rated = ((word >> (j & 31)) & 1) != 0  # arithmetic shift is fine: & 1
    s = torch.where(rated, torch.full_like(s, NEG_INF), s)
    s3 = s.reshape(u_b, m // SEG_LEN, SEG_LEN)
    segmax = s3.amax(dim=2)
    return segmax, s3.to(torch.bfloat16 if score_bf16 else torch.float32)


def fused_scores_cuda(rows, V, bi, bits, score_bf16: bool):
    """Launch K2 on PyTorch's current stream (no synchronization)."""
    global launches
    dev = rows.device
    ts = (rows, V, bi, bits)
    if not all(t.is_cuda and t.device == dev for t in ts):
        raise ValueError("fused_scores_cuda needs all inputs on one CUDA "
                         "device")
    if (rows.dtype, V.dtype, bi.dtype, bits.dtype) != (
            torch.bfloat16, torch.bfloat16, torch.float32, torch.int32):
        raise TypeError("K2 takes rows/V bf16, bi f32, bits int32")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("K2 takes contiguous inputs")
    u_b, k = rows.shape
    m = V.shape[0]
    n_seg = m // SEG_LEN
    if (V.shape[1] != k or m % SEG_LEN or bi.shape != (m,)
            or bits.shape != (u_b, 4 * n_seg)):
        raise ValueError(
            f"K2 shapes: rows {tuple(rows.shape)}, V {tuple(V.shape)}, "
            f"bi {tuple(bi.shape)}, bits {tuple(bits.shape)}")
    if not 1 <= k <= MAX_K:
        raise ValueError(f"K2 takes 1 <= k <= {MAX_K}, got k = {k}")
    segmax = torch.empty(u_b, n_seg, dtype=torch.float32, device=dev)
    s3 = torch.empty(u_b, n_seg, SEG_LEN, device=dev,
                     dtype=torch.bfloat16 if score_bf16 else torch.float32)
    if u_b == 0:
        return segmax, s3
    tile, run_len = partition(
        u_b, k, n_seg, torch.cuda.get_device_properties(dev)
        .multi_processor_count)
    lib = _build.load_library()
    rc = lib.ycnr_fused_scores(
        rows.data_ptr(), V.data_ptr(), bi.data_ptr(), bits.data_ptr(),
        segmax.data_ptr(), s3.data_ptr(), u_b, k, n_seg, int(score_bf16),
        tile, run_len, _build.stream(dev))
    _build.check(rc, "ycnr_fused_scores")
    launches += 1
    return segmax, s3


def _fused_scores(rows, V, bi, bits, score_bf16: bool):
    """K2 on CUDA, the plain version on the CPU."""
    if rows.device.type == "cpu":
        return fused_scores_reference(rows, V, bi, bits, score_bf16)
    return fused_scores_cuda(rows, V, bi, bits, score_bf16)


def fused_topn_core(U, V, bu, bi, mu, entity_ids, rated_bits, n: int, *,
                    score_bf16: bool = True):
    """Masked top-n over every block of a serving layout.

    entity_ids [NB, U_B] int (index into U), rated_bits [NB, U_B, W] int32
    (``build_rated_bits``'s uint32 words viewed as int32) ->
    (ids [NB, U_B, n] int32, vals [NB, U_B, n]). Values are the stored
    scores plus ``mu + b_u`` in the state's dtype (exact f32 for an f32
    state), as in the reference. Users with fewer than n unrated
    items get ``NEG_INF``-scored tail picks whose ids may lie in
    [n_items, W * 32); callers drop entries scoring <= NEG_INF / 2.

    Spans (``utils/profiling.span``): ``score`` for the set-up and for
    each block's gather and K2, ``select`` for each block's top-n, and
    ``to_host`` for the lists stacked to be copied out.
    """
    w = rated_bits.shape[-1]
    m = w * 32
    s = m // SEG_LEN
    if s <= n:
        raise ValueError("catalog too small for the fused path; "
                         "use the exact scorer")
    dev = U.device
    k = U.shape[1]
    with span("score"):
        ub16 = U.to(torch.bfloat16)
        vp = torch.zeros(m, k, dtype=torch.bfloat16, device=dev)
        vp[: V.shape[0]] = V.to(torch.bfloat16)
        bip = torch.zeros(m, dtype=torch.float32, device=dev)
        bip[: bi.shape[0]] = bi.float()
    ids, vals = [], []
    for eids, bits_b in zip(entity_ids, rated_bits):
        with span("score"):
            eids = eids.long()
            segmax, s3 = _fused_scores(ub16[eids], vp, bip, bits_b,
                                       score_bf16)
        with span("select"):
            _, top_seg = torch.topk(segmax, n, dim=1)  # exact: f32 maxima
            cand = torch.gather(
                s3, 1, top_seg[:, :, None].expand(-1, -1, SEG_LEN)).float()
            v, loc = torch.topk(cand.reshape(-1, n * SEG_LEN), n, dim=1)
            seg_sel = torch.gather(top_seg, 1, loc // SEG_LEN)
            ids.append((seg_sel * SEG_LEN + loc % SEG_LEN).to(torch.int32))
            vals.append(v + (mu + bu[eids])[:, None])  # exact rebias
    with span("to_host"):
        return torch.stack(ids), torch.stack(vals)


def fused_topn_blocks(state, entity_ids, rated_bits, n: int, *,
                      score_bf16: bool = True):
    """``fused_topn_core`` over an ``MFState``: the drop-in for the exact
    scorer's bits path (same inputs, same outputs)."""
    return fused_topn_core(state.U, state.V, state.bu, state.bi, state.mu,
                           entity_ids, rated_bits, n, score_bf16=score_bf16)
