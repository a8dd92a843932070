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
"""

from __future__ import annotations

import torch

from ycnr_tpu_torch.ops import _build

NEG_INF = -3.0e38  # matches eval.recommend.NEG_INF (finite: no inf - inf)

SEG_LEN = 128  # score segment length; the rated-bits words align to it
MAX_K = 256
_MAX_USERS = 65_535 * 32  # grid.y * users per block

launches = 0  # K2 launches since the last reset (chip_smoke reads it)


def fused_supported(n_items: int, n: int) -> bool:
    """Shape gate: the two-level select needs more segments than n."""
    s = -(-(n_items + 1) // SEG_LEN)
    return s > n and n <= 64


def fused_scores_reference(rows, V, bi, bits, score_bf16: bool):
    """The plain version of K2, bit for bit.

    rows [U_B, k] bf16, V [M, k] bf16 (M = 128 * S), bi [M] f32,
    bits [U_B, 4 * S] int32 -> (segmax [U_B, S] f32, s3 [U_B, S, 128]).
    The dot product is summed in k order in f32, the kernel's order;
    products of bf16 values are exact in f32, so the sums agree exactly.
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
    if not (1 <= k <= MAX_K and u_b <= _MAX_USERS):
        raise ValueError(f"K2 takes k <= {MAX_K} and <= {_MAX_USERS} rows, "
                         f"got k = {k}, {u_b} rows")
    segmax = torch.empty(u_b, n_seg, dtype=torch.float32, device=dev)
    s3 = torch.empty(u_b, n_seg, SEG_LEN, device=dev,
                     dtype=torch.bfloat16 if score_bf16 else torch.float32)
    if u_b == 0:
        return segmax, s3
    lib = _build.load_library()
    rc = lib.ycnr_fused_scores(
        rows.data_ptr(), V.data_ptr(), bi.data_ptr(), bits.data_ptr(),
        segmax.data_ptr(), s3.data_ptr(), u_b, k, n_seg, int(score_bf16),
        torch.cuda.current_stream(dev).cuda_stream)
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
    """
    w = rated_bits.shape[-1]
    m = w * 32
    s = m // SEG_LEN
    if s <= n:
        raise ValueError("catalog too small for the fused path; "
                         "use the exact scorer")
    dev = U.device
    k = U.shape[1]
    ub16 = U.to(torch.bfloat16)
    vp = torch.zeros(m, k, dtype=torch.bfloat16, device=dev)
    vp[: V.shape[0]] = V.to(torch.bfloat16)
    bip = torch.zeros(m, dtype=torch.float32, device=dev)
    bip[: bi.shape[0]] = bi.float()
    ids, vals = [], []
    for eids, bits_b in zip(entity_ids, rated_bits):
        eids = eids.long()
        segmax, s3 = _fused_scores(ub16[eids], vp, bip, bits_b, score_bf16)
        _, top_seg = torch.topk(segmax, n, dim=1)  # exact: f32 maxima
        cand = torch.gather(
            s3, 1, top_seg[:, :, None].expand(-1, -1, SEG_LEN)).float()
        v, loc = torch.topk(cand.reshape(-1, n * SEG_LEN), n, dim=1)
        seg_sel = torch.gather(top_seg, 1, loc // SEG_LEN)
        ids.append((seg_sel * SEG_LEN + loc % SEG_LEN).to(torch.int32))
        vals.append(v + (mu + bu[eids])[:, None])  # exact rebias
    return torch.stack(ids), torch.stack(vals)


def fused_topn_blocks(state, entity_ids, rated_bits, n: int, *,
                      score_bf16: bool = True):
    """``fused_topn_core`` over an ``MFState``: the drop-in for the exact
    scorer's bits path (same inputs, same outputs)."""
    return fused_topn_core(state.U, state.V, state.bu, state.bi, state.mu,
                           entity_ids, rated_bits, n, score_bf16=score_bf16)
