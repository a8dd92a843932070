"""fused_gram's wide body (128 < w <= 256), mirrored in plain torch.

``fused_gram_wide_kernel`` (``ycnr_tpu_torch/csrc/fused_gram.cu``) runs a
block of 8 warps per (entity, part) on the lower 16 x 16 tiles of the
padded Gram (T = ceil(w / 16) tiles a side). Warp v keeps the tile rows
rb = T-1-v and ra = v (only rb when they are the same row; warps v >
(T-1)/2 keep none): tile (rb, tj) in its accumulator tj, (ra, tj) in
accumulator T - tj. Every warp takes every 16-slot step in slot order and
adds that step's 16 exact products to each of its tiles in f32 (one
``mma.sync m16n8k16``), so an entry is one chain of ceil(R / 16) adds. The
epilogue writes each lower tile and its transpose from the same values and
puts the ridge on the diagonal. b's row tile of rb and of ra is the same
warp's extra product with the slot ratings.

The wrapper (``ops/fused_gram.fused_gram_cuda``) cuts long lists into
parts (``_parts`` at the wide body's fill), sums the parts' A and b in
order and adds the ridge after; with one part the kernel adds it.

A plain module (no pytest, no global state) so that the CPU tests
(``test_torch_fused_gram_wide.py``) and the card tests
(``test_torch_cuda.py``) hold the kernel to the same mirror.
"""

import torch

from ycnr_tpu_torch.ops import fused_gram as fg

TILE = 16  # columns a tile side, and slots an mma step
WARPS = 8  # warps a block


def warp_tiles(T: int, warp: int):
    """The lower tiles warp keeps, as (accumulator, ti, tj)."""
    rb, ra = T - 1 - warp, warp
    if warp > rb:
        return []
    tiles = [(tj, rb, tj) for tj in range(rb + 1)]
    if warp < rb:
        tiles += [(T - tj, ra, tj) for tj in range(ra + 1)]
    return tiles


def warp_b_rows(T: int, warp: int):
    """The row tiles of b that warp computes."""
    rb, ra = T - 1 - warp, warp
    return [] if warp > rb else [rb] + ([ra] if warp < rb else [])


def _part(F, r, T):
    """One part's lower tiles and b, padded to 16 T: F [NE, R, 16 T] f32
    (the staged rows, columns past w zero), r [NE, R] f32 ratings.
    Returns (G [NE, 16 T, 16 T] lower tiles as the warps hold them, NaN
    where no warp holds a tile; b [NE, 16 T])."""
    NE, R, W16 = F.shape
    steps = -(-R // TILE)
    pad = steps * TILE - R
    F = torch.nn.functional.pad(F, (0, 0, 0, pad))
    r = torch.nn.functional.pad(r, (0, pad))
    full = torch.zeros(NE, W16, W16)
    bfull = torch.zeros(NE, W16)
    for k in range(steps):  # one mma step: 16 exact products, summed in f32
        Fs = F[:, TILE * k:TILE * (k + 1)]
        full = full + Fs.transpose(1, 2) @ Fs
        bfull = bfull + (Fs.transpose(1, 2) @ r[:, TILE * k:TILE * (k + 1),
                                                None])[..., 0]
    G = torch.full((NE, W16, W16), float("nan"))
    b = torch.full((NE, W16), float("nan"))
    for warp in range(WARPS):
        for _, ti, tj in warp_tiles(T, warp):
            rs, cs = slice(TILE * ti, TILE * (ti + 1)), slice(TILE * tj,
                                                              TILE * (tj + 1))
            G[:, rs, cs] = full[:, rs, cs]
        for ti in warp_b_rows(T, warp):
            rs = slice(TILE * ti, TILE * (ti + 1))
            b[:, rs] = bfull[:, rs]
    return G, b


def fused_gram_wide_mirror(table, idx, rat, reg=None):
    """(A [NE, w, w], b [NE, w]) as the wide body and its wrapper compute
    them: table [n, w] bf16 (128 < w <= 256), idx [NE, R], rat [NE, R]
    bf16, reg [NE] f32 or None. CPU tensors."""
    NE, R = idx.shape
    w = table.shape[1]
    T = -(-w // TILE)
    assert fg.NARROW_W < w <= fg.MAX_W
    F = torch.zeros(NE, R, TILE * T)
    F[..., :w] = table[idx].float()
    r = rat.float()
    s, r_part = fg._parts(NE, R, fg.fill_blocks(w))
    As, bs = [], []
    for p in range(s):
        G, b = _part(F[:, p * r_part:(p + 1) * r_part],
                     r[:, p * r_part:(p + 1) * r_part], T)
        low = torch.tril(torch.ones(TILE * T, TILE * T, dtype=torch.bool))
        A = torch.where(low, G, G.transpose(1, 2))  # upper = lower's bits
        As.append(A[:, :w, :w])
        bs.append(b[:, :w])
    A = torch.stack(As, 1).sum(1) if s > 1 else As[0]
    b = torch.stack(bs, 1).sum(1) if s > 1 else bs[0]
    if reg is not None:
        A = A.clone()
        A.diagonal(dim1=1, dim2=2).add_(reg.float()[:, None])
    return A, b
