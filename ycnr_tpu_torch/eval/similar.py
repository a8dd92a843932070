"""Item-item similarity over the trained item factors (counterpart of
``ycnr_tpu/eval/similar.py``).

"More like this" = top-n items by cosine (or dot) similarity of V rows:
one [B, k] x [k, n_items + 1] product per request batch (``torch.matmul``
and ``torch.topk``: the JAX package runs this outside any hand-written
kernel too); the query rows are gathered by ``ops.row_gather``.

Cold items (zero factor rows — never rated, or the trailing trash row) are
masked out of both sides: they carry no signal, and a zero row's cosine is
0/eps noise.
"""

from __future__ import annotations

import numpy as np
import torch

from ycnr_tpu_torch import full_precision_matmul
from ycnr_tpu_torch.models.base import MFState
from ycnr_tpu_torch.ops.fused_topn import NEG_INF
from ycnr_tpu_torch.ops.row_gather import row_gather


def _similar_program(V, item_ids, n: int, metric: str):
    norms = torch.sqrt((V * V).sum(1))
    live = norms > 0.0
    if metric == "cosine":
        Vq = V / norms.clamp_min(1e-12)[:, None]
    else:
        Vq = V
    Q = row_gather(Vq, item_ids)  # [B, k]
    scores = Q @ Vq.T  # [B, n_items + 1]
    neg = torch.full((), NEG_INF, dtype=scores.dtype, device=scores.device)
    scores = torch.where(live[None, :], scores, neg)
    # a cold QUERY row (zero factors) carries no signal: mask its whole row
    # so callers' `> NEG_INF/2` filter yields an empty list, matching
    # precompute_similar's skip — not an arbitrary zero-score ranking
    scores = torch.where(live[item_ids][:, None], scores, neg)
    rows = torch.arange(item_ids.shape[0], device=scores.device)
    scores[rows, item_ids] = NEG_INF  # self
    return torch.topk(scores, n, dim=1)


def similar_items(state: MFState, item_ids, n: int = 10,
                  metric: str = "cosine"):
    """(items [B, n], scores [B, n]) of the most similar catalog items for
    each query item; self and cold items masked to NEG_INF (a cold QUERY
    masks its whole row — filter `scores > NEG_INF / 2` to drop). metric:
    "cosine" (scale-free; default) or "dot" (popularity-weighted — factor
    row norms grow with rating count)."""
    if metric not in ("cosine", "dot"):
        raise ValueError(f"metric must be 'cosine' or 'dot', got {metric!r}")
    full_precision_matmul()
    item_ids = torch.as_tensor(
        np.asarray(item_ids).reshape(-1).astype(np.int64),
        device=state.V.device)
    n = min(int(n), state.n_items - 1)  # self is always excluded
    scores, items = _similar_program(state.V, item_ids, n, metric)
    return items.to(torch.int32).cpu().numpy(), scores.cpu().numpy()
