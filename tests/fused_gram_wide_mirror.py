"""fused_gram's wide body (128 < w <= 256), mirrored in plain torch.

``fused_gram_wide_kernel`` (``ycnr_tpu_torch/csrc/fused_gram.cu``) cuts
the padded Gram into 64 x 64 blocks, T64 = ceil(w / 64) a side, and deals
the lower ones to two consumer warpgroups as runs of adjacent blocks in
one block row (``DEAL``): one ``wgmma m64nNk16`` a run and 16-slot step,
N = 64 x the run's blocks, each adding that step's 16 exact products to
every entry of the run in f32. So an entry is one chain of ceil(R / 16)
adds in slot order, kept by one warpgroup (the kernel runs every step of
its last 64-slot stage; the steps past R add exact zeros). b's row block
r is one more ``m64n8k16`` a step, by the warpgroup that lists r. The
epilogue writes each lower block and its transpose from the same values
(a diagonal block's upper half from its lower half) and puts the ridge on
the diagonal.

The wrapper (``ops/fused_gram.fused_gram_cuda``) cuts long lists into
parts (``_parts`` at the wide body's fill), sums the parts' A and b in
order and adds the ridge after; with one part the kernel adds it.

A plain module (no pytest, no global state) so that the CPU tests
(``test_torch_fused_gram_wide.py``) and the card tests
(``test_torch_cuda.py``) hold the kernel to the same mirror.
"""

import torch

from ycnr_tpu_torch.ops import fused_gram as fg

BLOCK = 64  # columns a block side, and rows of a wgmma
STEP = 16  # slots a wgmma step
WARPGROUPS = 2  # consumer warpgroups a block
THREADS = 128  # threads a warpgroup

# T64 -> per consumer warpgroup: (runs (row, first column, blocks), rows of
# b), as ``Deal`` in the kernel
DEAL = {
    3: (([(0, 0, 1), (2, 0, 2)], [0, 2]),
        ([(1, 0, 2), (2, 2, 1)], [1])),
    4: (([(0, 0, 1), (3, 0, 4)], [0, 3]),
        ([(1, 0, 2), (2, 0, 3)], [1, 2])),
}


def blocks_a_side(w: int) -> int:
    """T64: 64-column blocks a side of the padded Gram at width w."""
    assert fg.NARROW_W < w <= fg.MAX_W
    return -(-w // BLOCK)


def warpgroup_blocks(T64: int, g: int):
    """The lower blocks (row, column) warpgroup g keeps."""
    runs, _ = DEAL[T64][g]
    return [(r, c0 + q) for r, c0, n in runs for q in range(n)]


def warpgroup_b_rows(T64: int, g: int):
    """The row blocks of b warpgroup g computes."""
    return list(DEAL[T64][g][1])


def accumulators(T64: int, g: int) -> int:
    """f32 accumulators a thread of warpgroup g holds: a run of N columns
    is N / 2 (64 x N over 128 threads), a row block of b 4 (m64n8)."""
    runs, brows = DEAL[T64][g]
    return sum(BLOCK * n * BLOCK // THREADS for _, _, n in runs) + \
        4 * len(brows)


def _part(F, r, T64):
    """One part's lower blocks and b, padded to 64 T64: F [NE, R, 64 T64]
    f32 (the staged rows, columns past w zero), r [NE, R] f32 ratings.
    Returns (G [NE, 64 T64, 64 T64] lower blocks as the warpgroups hold
    them, NaN where no warpgroup holds a block; b [NE, 64 T64])."""
    NE, R, W64 = F.shape
    steps = -(-R // STEP)
    pad = steps * STEP - R
    F = torch.nn.functional.pad(F, (0, 0, 0, pad))
    r = torch.nn.functional.pad(r, (0, pad))
    full = torch.zeros(NE, W64, W64)
    bfull = torch.zeros(NE, W64)
    for k in range(steps):  # one wgmma step: 16 exact products, f32 adds
        Fs = F[:, STEP * k:STEP * (k + 1)]
        full = full + Fs.transpose(1, 2) @ Fs
        bfull = bfull + (Fs.transpose(1, 2) @ r[:, STEP * k:STEP * (k + 1),
                                                None])[..., 0]
    G = torch.full((NE, W64, W64), float("nan"))
    b = torch.full((NE, W64), float("nan"))
    for g in range(WARPGROUPS):
        for bi, bj in warpgroup_blocks(T64, g):
            rs = slice(BLOCK * bi, BLOCK * (bi + 1))
            cs = slice(BLOCK * bj, BLOCK * (bj + 1))
            G[:, rs, cs] = full[:, rs, cs]
        for bi in warpgroup_b_rows(T64, g):
            rs = slice(BLOCK * bi, BLOCK * (bi + 1))
            b[:, rs] = bfull[:, rs]
    return G, b


def fused_gram_wide_mirror(table, idx, rat, reg=None):
    """(A [NE, w, w], b [NE, w]) as the wide body and its wrapper compute
    them: table [n, w] bf16 (128 < w <= 256), idx [NE, R], rat [NE, R]
    bf16, reg [NE] f32 or None. CPU tensors."""
    NE, R = idx.shape
    w = table.shape[1]
    T64 = blocks_a_side(w)
    F = torch.zeros(NE, R, BLOCK * T64)
    F[..., :w] = table[idx].float()
    r = rat.float()
    s, r_part = fg._parts(NE, R, fg.fill_blocks(w))
    low = torch.tril(torch.ones(BLOCK * T64, BLOCK * T64, dtype=torch.bool))
    As, bs = [], []
    for p in range(s):
        G, b = _part(F[:, p * r_part:(p + 1) * r_part],
                     r[:, p * r_part:(p + 1) * r_part], T64)
        A = torch.where(low, G, G.transpose(1, 2))  # upper = lower's bits
        As.append(A[:, :w, :w])
        bs.append(b[:, :w])
    A = torch.stack(As, 1).sum(1) if s > 1 else As[0]
    b = torch.stack(bs, 1).sum(1) if s > 1 else bs[0]
    if reg is not None:
        A = A.clone()
        A.diagonal(dim1=1, dim2=2).add_(reg.float()[:, None])
    return A, b
