"""K1's tiled body (64 < n <= 256), mirrored in plain torch.

``spd_solve_tiled_kernel`` (``ycnr_tpu_torch/csrc/spd_solve.cu``) holds
the padded matrix (identity past n) as its lower T x T tiles. For each
tile column k: (a) the diagonal tile's LDL^T elimination by rows with b's
tile carried, giving L_kk^T, 1 / L[j][j] and z_k; (b) the tiles below it
solved row by row against L_kk (and the identity, giving L_kk^-1), b's
tiles losing L_ik z_k; (c) the trailing tiles losing L_ik L_jk^T, one
product of the panel's columns p after another. Then the back substitution
by tiles: x_i = L_ii^-T y_i through the stored inverse, and every tile
above loses L_ij^T x_i.

A plain module (no pytest, no global state) so that the CPU tests
(``test_torch_solve_mirror.py``), the card tests (``test_torch_cuda.py``)
and ``chip_smoke.py`` hold the kernel to the same mirror.
"""

import torch

TILE = 32  # the kernel's kTile


def tile_index(i: int, j: int) -> int:
    """Where tile (i, j), i >= j, of the lower tiles starts, in tiles
    (``spd_solve_tiled_kernel``'s ``tile``)."""
    return i * (i + 1) // 2 + j


def tile_offset(r: int, c: int, T: int, ld: int) -> int:
    """Offset in floats of entry (r, c) of the padded matrix, r // T >=
    c // T, in the tiles' shared memory: rows ``ld`` floats apart."""
    return tile_index(r // T, c // T) * T * ld + (r % T) * ld + c % T


def _factor_tile(D, bq):
    """(a) on the diagonal tile D [B, T, T] (row q = lane q's) and b's tile
    bq [B, T]: L_kk^T (row j holds L[q][j] at q > j), 1 / L[j][j], z."""
    Bn, T, _ = D.shape
    a = D.clone()
    qi = torch.arange(T)
    lt = torch.zeros(Bn, T, T)
    s = torch.empty(Bn, T)
    z = torch.empty(Bn, T)
    for j in range(T):
        col = a[:, :, j].clone()  # a[q][j] from every lane, through the slot
        d = col[:, j]
        m = a[:, :, j] * (1.0 / d)[:, None]  # L[q][j] / L[j][j]
        bj = bq[:, j].clone()
        live = ((qi[None, :] > j) & (qi[None, :] <= qi[:, None]))  # [q, c]
        a = torch.where(live, a - col[:, None, :] * m[:, :, None], a)
        bq = torch.where(qi > j, bq - bj[:, None] * m, bq)
        sj = 1.0 / torch.sqrt(d)
        lt[:, j, j + 1:] = a[:, j + 1:, j] * sj[:, None]
        s[:, j] = sj
        z[:, j] = bj * sj
    return lt, s, z


def _panel_rows(rows, lt, s):
    """(b): x with x L_kk^T = row, for every row of rows [B, R, T]."""
    a = rows.clone()
    for j in range(a.shape[-1]):
        a[:, :, j] = a[:, :, j] * s[:, j, None]
        a[:, :, j + 1:] = a[:, :, j + 1:] - a[:, :, j:j + 1] * lt[:, None, j,
                                                                   j + 1:]
    return a


def tiled_solve_mirror(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x = A^-1 b as spd_solve_tiled_kernel computes it, in f32, all
    systems at once: its storage, order and padding."""
    T = TILE
    Bn, n = b.shape
    NT = -(-n // T)
    N = NT * T
    Ap = torch.eye(N).repeat(Bn, 1, 1)
    Ap[:, :n, :n] = A
    bs = torch.zeros(Bn, N)
    bs[:, :n] = b
    tiles = {(i, j): Ap[:, i * T:(i + 1) * T, j * T:(j + 1) * T].clone()
             for i in range(NT) for j in range(i + 1)}
    L, inv = {}, {}  # L_ik [B, r, p] (i > k), L_kk^-1 [B, p, q]
    for k in range(NT):
        ks = slice(k * T, (k + 1) * T)
        lt, s, bs[:, ks] = _factor_tile(tiles[(k, k)], bs[:, ks])
        inv[k] = _panel_rows(torch.eye(T).repeat(Bn, 1, 1), lt, s) \
            .transpose(1, 2).tril()
        for i in range(k + 1, NT):
            L[(i, k)] = _panel_rows(tiles[(i, k)], lt, s)
            acc = bs[:, i * T:(i + 1) * T]
            for p in range(T):
                acc = acc - L[(i, k)][:, :, p] * bs[:, k * T + p, None]
            bs[:, i * T:(i + 1) * T] = acc
        for j in range(k + 1, NT):
            for i in range(j, NT):
                C = tiles[(i, j)]
                for p in range(T):
                    C = C - L[(i, k)][:, :, p, None] * L[(j, k)][:, None, :, p]
                tiles[(i, j)] = C
    x = torch.zeros(Bn, N)
    qi = torch.arange(T)
    for i in range(NT - 1, -1, -1):
        yi = bs[:, i * T:(i + 1) * T]
        xi = torch.zeros(Bn, T)
        for p in range(T):
            xi = torch.where(p >= qi, xi + inv[i][:, p, :] * yi[:, p, None],
                             xi)
        x[:, i * T:(i + 1) * T] = xi
        for j in range(i):
            acc = bs[:, j * T:(j + 1) * T]
            for r in range(T):
                acc = acc - L[(i, j)][:, r, :] * xi[:, r, None]
            bs[:, j * T:(j + 1) * T] = acc
    return x[:, :n]
