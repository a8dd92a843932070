"""K2's stated bound, exact invariants and work split, on the CPU.

``csrc/fused_topn.cu`` multiplies on the tensor cores and cannot run here.
What can: the bound function against a float64 sum (for the plain version
and for a model of the tensor core's worst case, 16 products a step,
every step truncated), the invariants that stay exact whatever the sum's
rounding, and a mirror of the kernel's arithmetic of tiles, segment runs
and accumulator fragments, which must cover every (user, item) once.
"""

import numpy as np
import pytest
import torch

from ycnr_tpu_torch.ops import fused_topn as ft

torch.set_num_threads(1)


def _inputs(u_b, k, n_seg, seed, density=0.3):
    rng = np.random.default_rng(seed)
    m = n_seg * ft.SEG_LEN
    rows = torch.as_tensor(rng.normal(0, 0.5, (u_b, k)),
                           dtype=torch.float32).bfloat16()
    V = torch.as_tensor(rng.normal(0, 0.5, (m, k)),
                        dtype=torch.float32).bfloat16()
    bi = torch.as_tensor(rng.normal(0, 0.1, m), dtype=torch.float32)
    mask = rng.random((u_b, m)) < density
    mask[:, -40:] = True  # trash and pad columns
    bits = np.packbits(mask, axis=1, bitorder="little").view("<u4")
    return rows, V, bi, torch.as_tensor(bits.view(np.int32)), \
        torch.as_tensor(mask)


def _truncating_steps(rows, V, bi):
    """A model of the worst the tensor cores may do: the exact sum of a
    step's 16 products and the accumulator, rounded toward zero to f32
    after every step; then the bias added with round-to-nearest."""
    r, v = rows.double().numpy(), V.double().numpy()
    acc = np.zeros((r.shape[0], v.shape[0]), np.float32)
    for k0 in range(0, r.shape[1], 16):
        exact = acc.astype(np.float64) + r[:, k0:k0 + 16] @ v[:, k0:k0 + 16].T
        near = exact.astype(np.float32)
        over = np.abs(near.astype(np.float64)) > np.abs(exact)
        acc = np.where(over, np.nextafter(near, np.float32(0)), near)
    return torch.as_tensor(acc + bi.numpy()[None, :])


SHAPES = [(37, 10, 3), (130, 64, 4), (5, 1, 1), (70, 200, 2)]


@pytest.mark.parametrize("u_b,k,n_seg", SHAPES)
def test_bound_holds_against_float64_and_the_plain_version(u_b, k, n_seg):
    rows, V, bi, bits, mask = _inputs(u_b, k, n_seg, k)
    _, s3 = ft.fused_scores_reference(rows, V, bi, bits, False)
    plain = s3.reshape(u_b, -1)
    s64 = rows.double() @ V.double().T + bi.double()[None, :]
    model = _truncating_steps(rows, V, bi)
    bound = ft.fused_scores_bound(rows, V, bi)
    b64 = ft.fused_scores_bound(rows, V, bi, f64=True)
    assert bound.dtype == torch.float32 and b64.dtype == torch.float64
    assert torch.all(b64 < bound.double())  # the f64 bound is the tighter
    live = ~mask
    # the truncating model stays within both bounds, at under half of each
    # (the bounds carry a factor of two)
    assert torch.all((model - plain).abs()[live] <= 0.5 * bound[live])
    assert torch.all((model.double() - s64).abs()[live] <= 0.5 * b64[live])
    # and the plain version is within its own share of the stated bound,
    # (k + 1) 2^-24 (sum |r||v| + |bi|)
    pb = b64 / (2.0 * (36 * -(-k // 16) + 1) * 2.0 ** -24)
    assert torch.all((plain.double() - s64).abs()[live]
                     <= (k + 1) * 2.0 ** -24 * pb[live])


@pytest.mark.parametrize("k", [1, 10, 16, 64, 100, 256])
def test_bound_constants(k):
    """c(k) = 2 (36 ceil(k/16) + k + 2), c64(k) = 2 (36 ceil(k/16) + 1),
    times 2^-24 (sum |r||v| + |bi|)."""
    rows = torch.ones(2, k).bfloat16()
    V = torch.ones(ft.SEG_LEN, k).bfloat16()
    bi = torch.full((ft.SEG_LEN,), -3.0)
    steps = -(-k // 16)
    want = 2 * (36 * steps + k + 2) * 2.0 ** -24 * (k + 3.0)
    want64 = 2 * (36 * steps + 1) * 2.0 ** -24 * (k + 3.0)
    got = ft.fused_scores_bound(rows, V, bi)
    got64 = ft.fused_scores_bound(rows, V, bi, f64=True)
    assert torch.allclose(got, torch.full_like(got, want), rtol=1e-6)
    assert torch.allclose(got64, torch.full_like(got64, want64), rtol=1e-12)
    if k == 64:
        assert 2 * (36 * steps + k + 2) == 420


@pytest.mark.parametrize("score_bf16", [True, False])
@pytest.mark.parametrize("u_b,k,n_seg", SHAPES)
def test_plain_version_keeps_the_exact_invariants(u_b, k, n_seg, score_bf16):
    rows, V, bi, bits, mask = _inputs(u_b, k, n_seg, 7 + k)
    seg, s3 = ft.fused_scores_reference(rows, V, bi, bits, score_bf16)
    assert seg.dtype == torch.float32 and seg.shape == (u_b, n_seg)
    assert s3.shape == (u_b, n_seg, ft.SEG_LEN)
    flat = s3.reshape(u_b, -1).float()
    neg = torch.tensor(ft.NEG_INF).to(s3.dtype).float()
    assert torch.all(flat[mask] == neg)
    assert torch.all(flat[~mask] > ft.NEG_INF / 2)
    if score_bf16:
        assert s3.dtype == torch.bfloat16
        assert torch.equal(seg.bfloat16(), s3.amax(2))
    else:
        assert s3.dtype == torch.float32
        assert torch.equal(seg, s3.amax(2))


def test_fully_rated_segment_has_neg_inf_maximum():
    rows, V, bi, bits, _ = _inputs(9, 10, 3, 0)
    bits[:, 4:8] = -1  # every item of segment 1 rated
    seg, s3 = ft.fused_scores_reference(rows, V, bi, bits, False)
    assert torch.all(seg[:, 1] == ft.NEG_INF)
    assert torch.all(s3[:, 1] == ft.NEG_INF)


def _blocks(u_b, k, n_seg, sms):
    """The kernel's grid: (first user, users, first segment, segments)."""
    tile, run = ft.partition(u_b, k, n_seg, sms)
    for i in range(-(-u_b // tile)):
        for j in range(-(-n_seg // run)):
            yield (i * tile, min(tile, u_b - i * tile), j * run,
                   min(run, n_seg - j * run))


@pytest.mark.parametrize("u_b,k,n_seg,sms", [
    (5130, 64, 210, 132), (4096, 64, 210, 132), (1, 64, 210, 132),
    (77, 10, 5, 132), (1000, 200, 7, 132), (129, 128, 3, 4),
    (300, 129, 1, 132), (100_000, 64, 2, 132)])
def test_partition_covers_every_user_and_segment_once(u_b, k, n_seg, sms):
    tile, run = ft.partition(u_b, k, n_seg, sms)
    assert tile == (128 if k <= 128 else 64) and 1 <= run <= n_seg
    seen = np.zeros((u_b, n_seg), np.int64)
    n_blocks = 0
    for u0, nu, s0, ns in _blocks(u_b, k, n_seg, sms):
        assert nu >= 1 and ns >= 1
        seen[u0:u0 + nu, s0:s0 + ns] += 1
        n_blocks += 1
    assert np.all(seen == 1)
    assert -(-n_seg // run) <= 65_535  # grid.y
    # enough blocks for the card, as far as the call has work for them
    target = ft._BLOCKS_PER_SM * sms
    tiles = -(-u_b // tile)
    assert n_blocks >= min(target, tiles * n_seg) // 2


def test_main_path_partition_fills_the_card():
    """One serving block of the ML-20M layout (about 5,130 users, 210
    segments) gives each of 132 SMs several blocks."""
    tile, run = ft.partition(5130, 64, 210, 132)
    blocks = -(-5130 // tile) * -(-210 // run)
    assert (tile, run) == (128, 9) and blocks == 41 * 24
    assert blocks >= 4 * 132


@pytest.mark.parametrize("tile", [128, 64])
def test_fragment_layout_covers_the_tile_once(tile):
    """mma.sync m16n8k16's accumulator layout as the epilogue reads it:
    warp w, lane l, tile j, element e -> user 16 w + (l >> 2) + 8 (e >> 1),
    item 8 j + 2 (l & 3) + (e & 1), whose rated bit is bit
    8 (j & 3) + 2 (l & 3) + (e & 1) of word j >> 2."""
    seen = np.zeros((tile, ft.SEG_LEN), np.int64)
    for w in range(tile // 16):
        for lane in range(32):
            g, l3 = lane >> 2, lane & 3
            for j in range(16):
                for e in range(4):
                    user = 16 * w + g + 8 * (e >> 1)
                    item = 8 * j + 2 * l3 + (e & 1)
                    seen[user, item] += 1
                    assert item >> 5 == j >> 2
                    assert item & 31 == 8 * (j & 3) + 2 * l3 + (e & 1)
    assert np.all(seen == 1)


@pytest.mark.parametrize("score_bf16", [True, False])
def test_block_by_block_mirror_equals_the_whole(score_bf16):
    """Scoring block by block over the kernel's grid, each block from its
    own slice of rows, V segments, biases and bit words, gives the plain
    version's outputs for the whole call."""
    u_b, k, n_seg = 300, 10, 7
    rows, V, bi, bits, _ = _inputs(u_b, k, n_seg, 11)
    seg, s3 = ft.fused_scores_reference(rows, V, bi, bits, score_bf16)
    seg_m = torch.full_like(seg, float("nan"))
    s3_m = torch.full_like(s3, float("nan"))
    n = 0
    for u0, nu, s0, ns in _blocks(u_b, k, n_seg, sms=2):
        items = slice(s0 * ft.SEG_LEN, (s0 + ns) * ft.SEG_LEN)
        a, b = ft.fused_scores_reference(
            rows[u0:u0 + nu], V[items], bi[items],
            bits[u0:u0 + nu, 4 * s0:4 * (s0 + ns)].contiguous(), score_bf16)
        seg_m[u0:u0 + nu, s0:s0 + ns] = a
        s3_m[u0:u0 + nu, s0:s0 + ns] = b
        n += 1
    assert n > 3
    assert torch.equal(seg_m, seg) and torch.equal(s3_m, s3)


def test_cuda_wrapper_refuses_cpu_tensors_and_counts_nothing():
    rows, V, bi, bits, _ = _inputs(4, 8, 1, 0)
    before = ft.launches
    with pytest.raises(ValueError):
        ft.fused_scores_cuda(rows, V, bi, bits, True)
    ft._fused_scores(rows, V, bi, bits, True)  # CPU: the plain version
    assert ft.launches == before
