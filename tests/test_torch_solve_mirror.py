"""K1's two bodies, mirrored in plain torch on the CPU.

``csrc/spd_solve.cu`` cannot run here, so its arithmetic is written out
once more. The warp body (n <= 64): identity padding to 16, 32 or 64
columns, column c's owner holding all rows of A's column c, an LDL^T
elimination in column order in which each owner takes its entry of row j
from its own column (A is symmetric) and updates its columns right of j
over the whole square, the right-hand side as one more row, and the back
substitution from the entries below the diagonal. The tiled body (64 < n
<= 256): ``tests/k1_tiled_mirror.py``, shared with the card tests and
``chip_smoke.py``, and its storage is held to the source's constants
here. Each mirror is held to the port's plain solve, to a
float64 solve and to the JAX package's Pallas solve in interpret mode, at
the tolerance ``tests/test_torch_solve.py`` states for f32 (1e-4 relative
to the largest entry); padding systems give exactly 0. The card tests
(``tests/test_torch_cuda.py``) hold the kernel to these mirrors.
"""

import re

import numpy as np
import pytest
import torch

from k1_tiled_mirror import TILE, tile_index, tile_offset, tiled_solve_mirror
from ycnr_tpu_torch.ops import _build
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
    import jax.numpy as jnp

    from ycnr_tpu.ops.pallas_solve import pallas_spd_solve

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




def test_wrapper_refuses_what_k1_does_not_take():
    A = torch.eye(257).repeat(2, 1, 1)
    b = torch.zeros(2, 257)
    with pytest.raises(ValueError, match="CUDA"):
        sp.spd_solve_cuda(A, b)  # the CPU is the plain version's
    # the plain version takes any n and float64 on the CPU
    x = sp.spd_solve(A.double(), b.double())
    assert x.dtype == torch.float64 and torch.all(x == 0)


# ---------------------------------------------------------------------------
# The 64 < n <= 256 body (spd_solve_tiled_kernel): its mirror is
# tests/k1_tiled_mirror.py, which the card tests and chip_smoke.py share.
# ---------------------------------------------------------------------------

SMEM_BYTES = 232_448  # what one block may use on Hopper (227 KB)
SM_SMEM_BYTES = 233_472  # an SM's (228 KB); 1 KB of it is reserved a block
WIDE_NS = [65, 96, 127, 128, 129, 160, 192, 193, 224, 250, 256]


def _cu_constant(name: str) -> str:
    src = open(f"{_build.CSRC}/spd_solve.cu").read()
    return re.search(rf"constexpr int {name} = ([^;]+);", src).group(1)


def _tile_constants() -> tuple:
    """The source's tile size T and a tile row's stride in floats."""
    T = int(_cu_constant("kTile"))
    assert _cu_constant("kTileLd") == "kTile + 4"
    return T, T + 4


def _tiled_cfg(NT: int) -> dict:
    """TiledCfg<NT>'s constants as the source computes them: each
    ``static constexpr int`` of the struct evaluated in order (C++'s
    integer division and ``?:``)."""
    src = open(f"{_build.CSRC}/spd_solve.cu").read()
    body = re.search(r"struct TiledCfg \{(.*?)\n\};", src, re.S).group(1)
    env = {"NT": NT, "kTile": int(_cu_constant("kTile"))}
    env["kTileLd"] = eval(_cu_constant("kTileLd"), {}, env)
    for name, expr in re.findall(r"static constexpr int (\w+) =\s*([^;]+);",
                                 body):
        expr = " ".join(expr.split()).replace("/", "//")
        expr = re.sub(r"(.+?) \? (.+?) : (.+)", r"(\2 if \1 else \3)", expr)
        env[name] = eval(expr, {}, env)
    return env


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


def _tiled_smem(n: int, T: int, ld: int) -> int:
    """spd_solve_tiled_kernel's shared memory (TiledCfg::kSmem): the lower
    tiles, b / 1 / L[j][j] / x of N floats each, three pivot slots."""
    NT = -(-n // T)
    return 4 * (NT * (NT + 1) // 2 * T * ld + 3 * NT * T + 3 * T)


@pytest.mark.parametrize("n", WIDE_NS)
def test_tile_index_enumerates_the_lower_tiles(n):
    """Every entry of the lower tiles (the diagonal tiles whole) gets its
    own offset, and together they fill the tiles' shared memory with no
    gap and no overlap: tile after tile, each T rows of ld floats whose
    last ld - T are the padding."""
    T, ld = _tile_constants()
    NT = -(-n // T)
    offs = [tile_offset(r, c, T, ld) for r in range(NT * T)
            for c in range(NT * T) if r // T >= c // T]
    assert len(set(offs)) == len(offs) == NT * (NT + 1) // 2 * T * T
    want = [t * T * ld + r * ld + c for t in range(NT * (NT + 1) // 2)
            for r in range(T) for c in range(T)]
    assert sorted(offs) == want
    assert [tile_index(i, j) for i in range(NT) for j in range(i + 1)] \
        == list(range(NT * (NT + 1) // 2))


@pytest.mark.parametrize("n", WIDE_NS)
def test_tiled_identity_padding_and_padding_systems_are_exact(n):
    """The padding past n is an identity block with a zero right-hand
    side: the same systems padded by hand to the next multiple of T solve
    to the unpadded mirror's x bit for bit and to exactly 0 past n; the
    padding systems (I x = 0) solve to exactly 0."""
    A, b = _systems(6, n, 7 * n)
    At, bt = torch.as_tensor(A), torch.as_tensor(b)
    x = tiled_solve_mirror(At, bt)
    assert torch.all(x[:3] == 0)
    N = -(-n // 32) * 32
    big = torch.eye(N).repeat(6, 1, 1)
    big[:, :n, :n] = At
    bb = torch.zeros(6, N)
    bb[:, :n] = bt
    xb = tiled_solve_mirror(big, bb)
    assert torch.equal(xb[:, :n], x)
    assert torch.all(xb[:, n:] == 0)


@pytest.mark.parametrize("n", WIDE_NS)
def test_tiled_mirror_within_cholesky_forward_error(n):
    """Within f32 Cholesky's forward error of a float64 solve, cond(A) n
    2^-24 per system, on guarded ALS-like systems; padding systems exactly
    0."""
    A, b = _guarded(6, n, seed=n)
    x = tiled_solve_mirror(torch.as_tensor(A), torch.as_tensor(b))
    ref = np.linalg.solve(A.astype(np.float64),
                          b.astype(np.float64)[..., None])[..., 0]
    assert np.all(x[:3].numpy() == 0)
    live = slice(3, None)
    rel = (np.abs(x.double().numpy() - ref).max(1)
           / np.abs(ref).max(1).clip(1e-300))[live]
    bound = _cond(A[live]) * n * 2.0 ** -24
    assert np.all(rel <= bound), (rel, bound)
    assert np.all(rel < 1e-3)  # chip_smoke's K1_RTOL


@pytest.mark.parametrize("n", WIDE_NS)
def test_tiled_mirror_equals_plain_solve(n):
    A, b = _systems(6, n, n)
    At, bt = torch.as_tensor(A), torch.as_tensor(b)
    x = tiled_solve_mirror(At, bt)
    plain = sp.spd_solve_reference(At, bt)
    scale = plain.abs().max().item()
    assert (x - plain).abs().max().item() <= RTOL * scale
    assert torch.all(x[:3] == 0)


@pytest.mark.parametrize("n,variant", [(96, "static"), (128, "static_hbm"),
                                       (192, "panel")])
def test_tiled_mirror_equals_pallas_interpret(n, variant):
    """The reference's own routes at these sizes (pallas_spd_solve turns
    "static" into static_hbm at n 128 and into panel at n 192, as
    tests/test_pallas_solve.py runs them) on the same systems."""
    import jax.numpy as jnp

    from ycnr_tpu.ops.pallas_solve import pallas_spd_solve

    A, b = _guarded(4, n, seed=11 + n)
    xp = np.asarray(pallas_spd_solve(jnp.asarray(A), jnp.asarray(b),
                                     interpret=True, variant="static"))
    x = tiled_solve_mirror(torch.as_tensor(A), torch.as_tensor(b)).numpy()
    np.testing.assert_allclose(x, xp, rtol=RTOL,
                               atol=RTOL * np.abs(xp).max())
    assert np.all(x[:3] == 0) and np.all(xp[:3] == 0)


@pytest.mark.parametrize("n", [128, 192])
def test_tiled_guarded_ill_conditioned_systems_against_float64(n):
    """ALS-like normal equations at the rank-128 and rank-192 paths' n
    (few gathered rows, some 5x larger, + the ridge): cond(A) in the
    thousands, within f32 Cholesky's forward error of a float64 solve."""
    rng = np.random.default_rng(n)
    B, R = 16, 12
    F = rng.normal(0, 0.5, (B, R, n)).astype(np.float32)
    F[::4] *= 5
    r = rng.normal(3, 1, (B, R)).astype(np.float32)
    A = np.einsum("brk,brm->bkm", F, F) + 0.05 * R * np.eye(n, dtype="f4")
    A = (0.5 * (A + A.transpose(0, 2, 1))).astype(np.float32)
    b = np.einsum("brk,br->bk", F, r).astype(np.float32)
    x = tiled_solve_mirror(torch.as_tensor(A), torch.as_tensor(b))
    ref = np.linalg.solve(A.astype(np.float64),
                          b.astype(np.float64)[..., None])[..., 0]
    rel = np.abs(x.double().numpy() - ref).max(1) / np.abs(ref).max(1)
    assert _cond(A).max() > 1e3
    assert np.all(rel <= _cond(A) * n * 2.0 ** -24)
    assert rel.max() < 1e-3  # chip_smoke's K1_RTOL


@pytest.mark.parametrize("n,blocks", [(128, 4), (192, 2), (193, 1),
                                      (224, 1), (256, 1)])
def test_tiled_shared_memory_and_blocks_an_sm(n, blocks):
    """TiledCfg's shared memory is the lower tiles and the body's vectors,
    fits a block's shared memory at every n up to MAX_N (the full square
    would not at n 256) and gives 4 / 2 / 1 blocks an SM at n 128 / 192 /
    193-256; the thread count is 32 a tile column."""
    T, ld = _tile_constants()
    assert (T, ld) == (TILE, 36) == (32, 36)
    assert int(_cu_constant("kMaxN")) == sp.MAX_N == 256
    smem = _tiled_smem(n, T, ld)
    cfg = _tiled_cfg(-(-n // T))
    assert cfg["kSmem"] == smem <= SMEM_BYTES < 4 * sp.MAX_N ** 2
    assert SM_SMEM_BYTES // (smem + 1024) == cfg["kSmemBlocks"] == blocks
    assert cfg["kBlocks"] == blocks
    assert cfg["kThreads"] == 32 * -(-n // T)


@pytest.mark.parametrize("n,want", [(1, "warp"), (64, "warp"),
                                    (65, "tiled"), (128, "tiled"),
                                    (129, "tiled"), (192, "tiled"),
                                    (193, "tiled"), (224, "tiled"),
                                    (256, "tiled")])
def test_body_routing(n, want):
    """ops/spd_solve.body follows the C entry point: the warp body to n =
    64, the tiled body above; body_launches has those keys."""
    assert sp.body(n) == want
    assert set(sp.body_launches) == {"warp", "tiled"}
