"""K1's warp-per-system scheme, mirrored in plain torch on the CPU.

``csrc/spd_solve.cu`` cannot run here, so its arithmetic is written out
once more: identity padding to 16, 32 or 64 columns, column c's owner
holding all rows of A's column c, an LDL^T elimination in column order
in which each owner takes its entry of row j from its own column (A is
symmetric) and updates its columns right of j over the whole square, the
right-hand side as one more row, and the back substitution from the
entries below the diagonal. The mirror is held to the port's plain
solve, to a float64 solve and to the JAX package's Pallas solve in
interpret mode, at the tolerance ``tests/test_torch_solve.py`` states for
f32 (1e-4 relative to the largest entry); padding systems give exactly 0.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ycnr_tpu.ops.pallas_solve import pallas_spd_solve
from ycnr_tpu_torch.ops import spd_solve as sp

torch.set_num_threads(1)

RTOL = 1e-4


def padded_size(n: int) -> int:
    """The kernel's template size for n <= 64."""
    return 16 if n <= 16 else 32 if n <= 32 else 64


def warp_solve_mirror(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x = A^-1 b as spd_solve_warp_kernel computes it, in f32, all systems
    at once. a[:, c, r] is what the owner of column c holds for row r
    (A[r][c]); a[:, c, N] is b[c]."""
    B, n = b.shape
    N = padded_size(n)
    a = torch.zeros(B, N, N + 1, dtype=torch.float32)
    a[:, :, :N] = torch.eye(N)
    a[:, :n, :n] = A.transpose(1, 2)
    a[:, :n, N] = b
    cols = torch.arange(N)
    dinv = torch.zeros(B, N)
    updated = torch.zeros(N, N, dtype=torch.int64)  # [c, r] update counts
    for j in range(N):
        row = a[:, :, j].clone()  # row j, one entry from every owner
        invd = 1.0 / row[:, j]
        dinv[:, j] = invd
        right = cols > j
        m = torch.where(right[None, :], row * invd[:, None],
                        torch.zeros(()))  # [B, c]
        z = a[:, j, N].clone()  # the owner of column j hands z_j round
        # rows r > j of the square, and b
        upd = a.clone()
        upd[:, :, :N] -= row[:, None, :] * m[:, :, None]
        upd[:, :, N] -= z[:, None] * m
        live = torch.cat([right[None, :].expand(N, N),
                          torch.ones(N, 1, dtype=torch.bool)], 1) \
            & right[:, None]
        a = torch.where(live[None], upd, a)
        updated += live[:, :N].long()
    acc = a[:, :, N].clone()
    x = torch.zeros(B, N)
    for r in range(N - 1, -1, -1):
        x[:, r] = acc[:, r] * dinv[:, r]
        below = cols < r  # columns c < r fold x_r in
        acc = torch.where(below[None, :],
                          acc - a[:, :, r] * x[:, r, None], acc)
    # entry (c, r) was updated once per earlier column of both
    assert torch.equal(updated, torch.minimum(cols[:, None], cols[None, :]))
    # the two copies of an entry agree to rounding: the square stays
    # symmetric, which is what lets an owner read row j from its column
    sq = a[:, :, :N]
    low = torch.tril(sq.transpose(1, 2), -1)  # [r, c] for r > c
    assert B == 0 or torch.allclose(low, torch.tril(sq, -1), rtol=1e-3,
                                    atol=1e-4 * sq.abs().max().item())
    return x[:, :n]


def _systems(B, n, seed):
    rng = np.random.default_rng(seed)
    M = rng.normal(size=(B, n, n))
    A = (M @ M.transpose(0, 2, 1) / n + 0.1 * np.eye(n)).astype(np.float32)
    b = rng.normal(size=(B, n)).astype(np.float32)
    A[:3] = np.eye(n)  # padding systems: I x = 0
    b[:3] = 0
    return A, b


@pytest.mark.parametrize("n", [1, 5, 10, 16, 17, 32, 33, 50, 64])
def test_mirror_equals_plain_solve_and_float64(n):
    A, b = _systems(24, n, n)
    At, bt = torch.as_tensor(A), torch.as_tensor(b)
    x = warp_solve_mirror(At, bt)
    plain = sp.spd_solve_reference(At, bt)
    ref = sp.spd_solve_reference(At.double(), bt.double())
    scale = ref.abs().max().item()
    assert (x - plain).abs().max().item() <= RTOL * scale
    assert (x.double() - ref).abs().max().item() <= RTOL * scale
    assert torch.all(x[:3] == 0)  # padding systems exactly 0


@pytest.mark.parametrize("n", [10, 32, 64])
def test_mirror_equals_pallas_interpret(n):
    A, b = _systems(16, n, 100 + n)
    xp = np.asarray(pallas_spd_solve(jnp.asarray(A), jnp.asarray(b),
                                     batch_tile=8, interpret=True))
    x = warp_solve_mirror(torch.as_tensor(A), torch.as_tensor(b)).numpy()
    np.testing.assert_allclose(x, xp, rtol=RTOL,
                               atol=RTOL * np.abs(xp).max())
    assert np.all(x[:3] == 0) and np.all(xp[:3] == 0)


@pytest.mark.parametrize("n,N", [(1, 16), (16, 16), (17, 32), (32, 32),
                                 (33, 64), (64, 64)])
def test_padded_size_and_identity_padding(n, N):
    """The padding block is an identity with a zero right-hand side: the
    padded solve equals the unpadded one bit for bit."""
    assert padded_size(n) == N
    A, b = _systems(8, n, n)
    At, bt = torch.as_tensor(A), torch.as_tensor(b)
    big = torch.eye(N).repeat(8, 1, 1)
    big[:, :n, :n] = At
    bb = torch.zeros(8, N)
    bb[:, :n] = bt
    assert padded_size(N) == N
    xb = warp_solve_mirror(big, bb)
    assert torch.equal(xb[:, :n], warp_solve_mirror(At, bt))
    assert torch.all(xb[:, n:] == 0)


def test_guarded_ill_conditioned_systems_against_float64():
    """ALS-like normal equations (few gathered rows + ridge), cond in the
    thousands: within f32 Cholesky's forward error of a float64 solve."""
    rng = np.random.default_rng(3)
    B, n, R = 32, 64, 12
    F = rng.normal(0, 0.5, (B, R, n)).astype(np.float32)
    r = rng.normal(3, 1, (B, R)).astype(np.float32)
    A = np.einsum("brk,brm->bkm", F, F) + 0.05 * R * np.eye(n, dtype="f4")
    A = 0.5 * (A + A.transpose(0, 2, 1))
    b = np.einsum("brk,br->bk", F, r)
    At, bt = torch.as_tensor(A), torch.as_tensor(b)
    x = warp_solve_mirror(At, bt)
    ref = sp.spd_solve_reference(At.double(), bt.double())
    rel = (x.double() - ref).abs().amax(1) / ref.abs().amax(1)
    assert rel.max().item() < 1e-3  # chip_smoke's K1_RTOL


# ---------------------------------------------------------------------------
# The n > 128 body: the lower triangle packed column by column in shared
# memory, factored in panels of 8 columns: each panel left-looking (row t's
# entry of column j from its own entries of the panel's earlier columns and
# row j's), then the trailing triangle minus the panel's rank-8 product
# (a sum over the panel in column order, subtracted once); then forward and
# back substitution with thread t holding row t.
# ---------------------------------------------------------------------------

SMEM_BYTES = 232_448  # what one block may use on Hopper (227 KB)
PANEL = 8


def _cu_constant(name: str) -> str:
    import re
    from ycnr_tpu_torch.ops import _build

    src = open(f"{_build.CSRC}/spd_solve.cu").read()
    return re.search(rf"constexpr int {name} = ([^;]+);", src).group(1)


def packed_solve_mirror(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x = A^-1 b as spd_solve_packed_kernel computes it, in f32, all
    systems at once; S[:, packed_index(r, c, n)] is entry (r, c), r >= c."""
    B, n = b.shape
    pk = sp.packed_index
    S = torch.empty(B, n * (n + 1) // 2, dtype=torch.float32)
    for c in range(n):  # column c of the triangle = row c of A from c on
        S[:, pk(c, c, n):pk(c, c, n) + n - c] = A[:, c, c:]
    invd = torch.empty(B, n)
    for j0 in range(0, n, PANEL):
        pw = min(PANEL, n - j0)
        Lp = torch.zeros(B, n, PANEL)  # L[r][j0 + q]
        for q in range(pw):
            j = j0 + q
            d = S[:, pk(j, j, n)].clone()
            for p in range(q):
                d = d - Lp[:, j, p] * Lp[:, j, p]
            inv = torch.rsqrt(d)
            invd[:, j] = inv
            rows = torch.arange(j + 1, n)
            v = S[:, pk(rows, j, n)].clone()
            for p in range(q):
                v = v - Lp[:, j + 1:, p] * Lp[:, j, p, None]
            v = v * inv[:, None]
            Lp[:, j + 1:, q] = v
            S[:, pk(rows, j, n)] = v
        c0 = j0 + PANEL
        if pw == PANEL and c0 < n:
            r, c = np.tril_indices(n - c0)
            r, c = r + c0, c + c0
            acc = Lp[:, r, 0] * Lp[:, c, 0]
            for p in range(1, PANEL):
                acc = acc + Lp[:, r, p] * Lp[:, c, p]
            dst = torch.as_tensor(pk(r, c, n))
            S[:, dst] = S[:, dst] - acc
    y = b.clone()
    for j in range(n):  # forward: z_j, then every row below folds it in
        y[:, j] *= invd[:, j]
        rows = torch.arange(j + 1, n)
        y[:, j + 1:] -= S[:, pk(rows, j, n)] * y[:, j, None]
    for j in range(n - 1, -1, -1):  # back: x_j, then every row above
        y[:, j] *= invd[:, j]
        cols = torch.arange(j)
        y[:, :j] -= S[:, pk(j, cols, n)] * y[:, j, None]
    return y


def _cond(A: np.ndarray) -> np.ndarray:
    w = np.linalg.eigvalsh(A.astype(np.float64))
    return w[:, -1] / w[:, 0]


def _guarded(B, n, seed):
    """ALS-like normal equations over R < n gathered rows plus the ridge:
    rank-deficient F^T F made definite by lam * cnt, so cond(A) reaches
    the hundreds to thousands; systems 0-2 are padding (I x = 0)."""
    rng = np.random.default_rng(seed)
    R = n // 4
    F = rng.normal(0, 0.3, (B, R, n)).astype(np.float32)
    r = rng.normal(3, 1, (B, R)).astype(np.float32)
    A = np.einsum("brk,brm->bkm", F, F) + 0.05 * R * np.eye(n, dtype="f4")
    A = (0.5 * (A + A.transpose(0, 2, 1))).astype(np.float32)
    b = np.einsum("brk,br->bk", F, r).astype(np.float32)
    A[:3] = np.eye(n)
    b[:3] = 0
    return A, b


@pytest.mark.parametrize("n", [1, 2, 7, 129, 256])
def test_packed_index_enumerates_the_lower_triangle_by_columns(n):
    """packed_index (the device function's mirror) numbers the entries
    (r, c), r >= c, 0, 1, ... in column order: no gap, no overlap."""
    want = [(r, c) for c in range(n) for r in range(c, n)]
    got = [sp.packed_index(r, c, n) for r, c in want]
    assert got == list(range(n * (n + 1) // 2))


@pytest.mark.parametrize("n", [129, 192, 250, 256])
def test_packed_mirror_against_float64(n):
    """Within f32 Cholesky's forward error of a float64 solve,
    cond(A) n 2^-24 per system; padding systems exactly 0."""
    A, b = _guarded(8, n, seed=n)
    x = packed_solve_mirror(torch.as_tensor(A), torch.as_tensor(b))
    ref = np.linalg.solve(A.astype(np.float64),
                          b.astype(np.float64)[..., None])[..., 0]
    assert np.all(x[:3].numpy() == 0)
    live = slice(3, None)
    rel = (np.abs(x.double().numpy() - ref).max(1)
           / np.abs(ref).max(1).clip(1e-300))[live]
    bound = _cond(A[live]) * n * 2.0 ** -24
    assert np.all(rel <= bound), (rel, bound)
    assert np.all(rel < 1e-3)  # chip_smoke's K1_RTOL


@pytest.mark.parametrize("n", [129, 192])
def test_packed_mirror_equals_plain_solve(n):
    A, b = _systems(6, n, n)
    At, bt = torch.as_tensor(A), torch.as_tensor(b)
    x = packed_solve_mirror(At, bt)
    plain = sp.spd_solve_reference(At, bt)
    scale = plain.abs().max().item()
    assert (x - plain).abs().max().item() <= RTOL * scale
    assert torch.all(x[:3] == 0)


def test_packed_mirror_equals_pallas_interpret_n192():
    """The reference's own n = 192 route (the panel variant, as
    tests/test_pallas_solve.py runs it) on the same systems."""
    A, b = _guarded(4, 192, seed=11)
    xp = np.asarray(pallas_spd_solve(jnp.asarray(A), jnp.asarray(b),
                                     interpret=True, variant="static"))
    x = packed_solve_mirror(torch.as_tensor(A), torch.as_tensor(b)).numpy()
    np.testing.assert_allclose(x, xp, rtol=RTOL,
                               atol=RTOL * np.abs(xp).max())
    assert np.all(x[:3] == 0) and np.all(xp[:3] == 0)


def test_max_n_is_the_packed_body_limit():
    """MAX_N is the CUDA source's limit (a thread a row in the panels and
    the substitutions) and the packed triangle, the panel's columns and the
    pivots fit a block's shared memory there; the full square would not."""
    assert sp.MAX_N == 256
    assert _cu_constant("kPackedThreads") == "256"
    assert _cu_constant("kMaxN") == "kPackedThreads"
    assert int(_cu_constant("kBlockMaxN")) == 128
    assert int(_cu_constant("kPanel")) == PANEL
    n = sp.MAX_N
    packed = 4 * ((n * (n + 1) // 2 + 3) // 4 * 4 + (PANEL + 1) * n)
    assert packed <= SMEM_BYTES < 4 * n * n


def test_wrapper_refuses_what_k1_does_not_take():
    A = torch.eye(257).repeat(2, 1, 1)
    b = torch.zeros(2, 257)
    with pytest.raises(ValueError, match="CUDA"):
        sp.spd_solve_cuda(A, b)  # the CPU is the plain version's
    # the plain version takes any n and float64 on the CPU
    x = sp.spd_solve(A.double(), b.double())
    assert x.dtype == torch.float64 and torch.all(x == 0)
