"""The port's kernels on the card against their plain versions: K1 (a
float64 solve), K2 (its bound, a float64 sum and its exact invariants),
the row gather and take-along gather (bit equality, the narrow rows of the
SGD and BPR epochs included), the fused gather -> Gram with and without the
ridge (its bound, and a float64 sum; the wide body, w 129-256, also
against its mirror, ``tests/fused_gram_wide_mirror.py``), and the fixed
order of the trainers' scatter-adds (one SGD, stream-SGD and BPR epoch
twice: the same bits).

Needs a CUDA device: every test skips without one. On a GPU machine, which
has no JAX, run them without the suite's JAX conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_cuda.py
"""

import contextlib

import numpy as np
import pytest
import torch

from ycnr_tpu_torch.ops import fused_gram as fg
from ycnr_tpu_torch.ops import fused_topn as ft
from ycnr_tpu_torch.ops import row_gather as rg
from ycnr_tpu_torch.ops import spd_solve as sp

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _spd(B, n, seed, dev):
    rng = np.random.default_rng(seed)
    M = rng.normal(size=(B, n, n))
    A = M @ M.transpose(0, 2, 1) / n + 0.5 * np.eye(n)
    A[:3] = np.eye(n)  # padding systems
    b = rng.normal(size=(B, n))
    b[:3] = 0
    return (torch.as_tensor(A, dtype=torch.float32, device=dev),
            torch.as_tensor(b, dtype=torch.float32, device=dev))


@pytest.mark.parametrize("B", [1, 257, 5000])
@pytest.mark.parametrize("n", [1, 5, 10, 16, 17, 32, 33, 64, 65, 100, 128])
def test_k1_matches_float64_reference(dev, n, B):
    A, b = _spd(B + 3, n, n, dev)
    before = sp.launches
    x = sp.spd_solve(A, b)
    torch.cuda.synchronize()
    assert sp.launches == before + 1
    ref = sp.spd_solve_reference(A.double(), b.double())
    rel = ((x.double() - ref).abs().amax(1)
           / ref.abs().amax(1).clamp_min(1e-300))
    assert rel[3:].max().item() < 1e-3
    assert torch.all(x[:3] == 0)


def test_k1_refuses_what_it_does_not_take(dev):
    A, b = _spd(4, 8, 0, dev)
    with pytest.raises(TypeError):  # float64 is solved on the CPU only
        sp.spd_solve(A.double(), b.double())
    A, b = _spd(2, sp.MAX_N + 1, 0, dev)
    with pytest.raises(ValueError):
        sp.spd_solve(A, b)


def _guarded_spd(B, n, seed, dev):
    """ALS-like normal equations over n // 4 gathered rows plus the ridge
    (cond(A) in the hundreds to thousands); systems 0-2 are padding."""
    rng = np.random.default_rng(seed)
    R = n // 4
    F = torch.as_tensor(rng.normal(0, 0.3, (B, R, n)), dtype=torch.float32,
                        device=dev)
    r = torch.as_tensor(rng.normal(3, 1, (B, R)), dtype=torch.float32,
                        device=dev)
    A = F.transpose(1, 2) @ F + 0.05 * R * torch.eye(n, device=dev)
    A = 0.5 * (A + A.transpose(1, 2))
    b = torch.einsum("brk,br->bk", F, r)
    A[:3] = torch.eye(n, device=dev)
    b[:3] = 0
    return A.contiguous(), b.contiguous()


@pytest.mark.parametrize("B", [1, 128, 130, 257, 2000])
@pytest.mark.parametrize("n", [65, 96, 128, 129, 192, 193, 224, 255, 256])
def test_k1_wide_within_cholesky_forward_error(dev, n, B):
    """The tiled body (n > 64) against a float64 solve, within cond(A) n
    2^-24 per system; padding systems exactly 0. B + 3 systems a launch:
    131 and 133 are one short of a wave of one block an SM on a 132-SM
    card and one past it."""
    A, b = _guarded_spd(B + 3, n, n + B, dev)
    before = sp.launches
    x = sp.spd_solve(A, b)
    torch.cuda.synchronize()
    assert sp.launches == before + 1
    Ad = A.double()
    ref = sp.spd_solve_reference(Ad, b.double())
    rel = ((x.double() - ref).abs().amax(1)
           / ref.abs().amax(1).clamp_min(1e-300))[3:]
    w = torch.linalg.eigvalsh(Ad[3:])
    bound = w[:, -1] / w[:, 0] * n * 2.0 ** -24
    assert bool((rel <= bound).all()), (rel.max().item(), bound.min().item())
    assert torch.all(x[:3] == 0)


@pytest.mark.parametrize("n", [65, 96, 127, 128, 129, 160, 192, 193, 224,
                               250, 255, 256])
def test_k1_tiled_matches_its_mirror(dev, n):
    """The tiled body against its plain-torch mirror
    (tests/k1_tiled_mirror.py) on the same well-conditioned
    systems: the same operations in the same order, so within 1e-5
    relative (the kernel fuses each multiply-add, the mirror rounds twice);
    padding systems exactly 0 in both."""
    from k1_tiled_mirror import tiled_solve_mirror

    A, b = _spd(35, n, 3 * n, dev)
    x = sp.spd_solve(A, b)
    torch.cuda.synchronize()
    xm = tiled_solve_mirror(A.cpu(), b.cpu())
    rel = ((x.cpu() - xm).abs().amax(1)
           / xm.abs().amax(1).clamp_min(1e-30))[3:]
    assert rel.max().item() <= 1e-5
    assert torch.all(x[:3] == 0) and torch.all(xm[:3] == 0)


@pytest.mark.parametrize("n", [65, 127, 128, 250, 255, 256])
def test_k1_tiled_unaligned_a_takes_the_4_byte_copies(dev, n):
    """A whose base is 4 bytes past a 16-byte boundary (and, at n 65, 127,
    250 and 255, rows that are not whole 16-byte chunks) is copied 4 bytes
    at a time: the same x as the aligned copy, bit for bit."""
    A, b = _spd(40, n, n, dev)
    buf = torch.empty(A.numel() + 1, device=dev)
    Au = buf[1:].view_as(A)
    Au.copy_(A)
    assert Au.is_contiguous() and Au.data_ptr() % 16 == 4
    x = sp.spd_solve(A, b)
    xu = sp.spd_solve(Au, b)
    torch.cuda.synchronize()
    assert torch.equal(x, xu)
    assert torch.all(xu[:3] == 0)


def test_k1_body_launches_count_each_body(dev):
    """body_launches counts a launch under the body that ran it: "warp"
    to n = 64, "tiled" above, and launches sums them."""
    before = dict(sp.body_launches), sp.launches
    for n, B in ((64, 4), (65, 4), (128, 300), (256, 2)):
        A, b = _spd(B, n, n, dev)
        sp.spd_solve(A, b)
    torch.cuda.synchronize()
    assert sp.body_launches["warp"] == before[0]["warp"] + 1
    assert sp.body_launches["tiled"] == before[0]["tiled"] + 3
    assert sp.launches == before[1] + 4


def test_k1_tiled_body_at_the_largest_netflix_block(dev):
    """The largest K1 call of a netflix-als-r256.train epoch: 3,408
    guarded n-256 systems in one launch, padding systems (I x = 0) among
    them. Every live system within cond(A) n 2^-24 of a float64 solve,
    every padding system exactly 0."""
    B, n = 3408, 256
    A, b = _guarded_spd(B, n, 20, dev)
    pad = torch.arange(0, B, 97, device=dev)
    A[pad] = torch.eye(n, device=dev)
    b[pad] = 0
    before = sp.body_launches["tiled"]
    x = sp.spd_solve(A, b)
    torch.cuda.synchronize()
    assert sp.body_launches["tiled"] == before + 1
    live = torch.ones(B, dtype=torch.bool, device=dev)
    live[:3] = False
    live[pad] = False
    assert torch.all(x[~live] == 0)
    for s in torch.arange(B, device=dev)[live].split(512):
        Ad = A[s].double()
        ref = sp.spd_solve_reference(Ad, b[s].double())
        rel = ((x[s].double() - ref).abs().amax(1)
               / ref.abs().amax(1).clamp_min(1e-300))
        w = torch.linalg.eigvalsh(Ad)
        bound = w[:, -1] / w[:, 0] * n * 2.0 ** -24
        assert bool((rel <= bound).all()), (rel.max().item(),
                                            bound.min().item())


def _k2_inputs(u_b, k, n_seg, seed, dev):
    rng = np.random.default_rng(seed)
    m = n_seg * ft.SEG_LEN
    rows = torch.as_tensor(rng.normal(size=(u_b, k)), device=dev).bfloat16()
    V = torch.as_tensor(rng.normal(size=(m, k)), device=dev).bfloat16()
    bi = torch.as_tensor(rng.normal(size=m), dtype=torch.float32, device=dev)
    bits = torch.as_tensor(rng.integers(-2**31, 2**31, (u_b, 4 * n_seg)),
                           dtype=torch.int32, device=dev)
    bits[:, -1] = -1  # the last 32 columns masked for every user
    return rows, V, bi, bits


def _k2_check(rows, V, bi, bits, score_bf16):
    """K2 against the plain version within the stated bound, against a
    float64 sum, and its exact invariants."""
    seg, s3 = ft._fused_scores(rows, V, bi, bits, score_bf16)
    seg_p, s3_p = ft.fused_scores_reference(rows, V, bi, bits, False)
    torch.cuda.synchronize()
    u_b, n_seg = seg.shape
    bound = ft.fused_scores_bound(rows, V, bi)
    masked = s3_p.reshape(u_b, -1) == ft.NEG_INF
    assert masked[:, -32:].all()
    assert s3.dtype == (torch.bfloat16 if score_bf16 else torch.float32)
    assert s3.shape == (u_b, n_seg, ft.SEG_LEN)
    flat = s3.reshape(u_b, -1).float()
    neg = torch.tensor(ft.NEG_INF, device=s3.device).to(s3.dtype).float()
    assert torch.all(flat[masked] == neg)
    assert torch.all(flat[~masked] > ft.NEG_INF / 2)
    tol = bound + (2.0 ** -7 * s3_p.reshape(u_b, -1).abs()
                   if score_bf16 else 0.0)
    err = (flat - s3_p.reshape(u_b, -1)).abs()
    assert torch.all(err[~masked] <= tol[~masked])
    assert torch.all((seg - seg_p).abs()
                     <= bound.reshape(u_b, n_seg, -1).amax(2))
    if score_bf16:
        assert torch.equal(seg.bfloat16(), s3.amax(2))
    else:
        assert torch.equal(seg, s3.amax(2))
        s64 = rows.double() @ V.double().T + bi.double()[None, :]
        b64 = ft.fused_scores_bound(rows, V, bi, f64=True)
        assert torch.all((flat.double() - s64).abs()[~masked]
                         <= b64[~masked])


@pytest.mark.parametrize("score_bf16", [True, False])
def test_k2_matches_plain_version_exactly(dev, score_bf16):
    """Since K2 multiplies on the tensor cores it matches the plain
    version within its stated bound, and exactly in what is exact: masked
    columns and the segment maxima of the stored scores."""
    rows, V, bi, bits = _k2_inputs(77, 64, 5, 1, dev)
    before = ft.launches
    _k2_check(rows, V, bi, bits, score_bf16)
    assert ft.launches == before + 1


@pytest.mark.parametrize("score_bf16", [True, False])
@pytest.mark.parametrize("u_b,k,n_seg", [
    (1, 1, 1), (5, 10, 3), (129, 10, 11), (300, 64, 210), (128, 16, 2),
    (1000, 24, 7), (200, 128, 9), (70, 200, 4), (130, 256, 3)])
def test_k2_ragged_shapes_and_ranks(dev, u_b, k, n_seg, score_bf16):
    _k2_check(*_k2_inputs(u_b, k, n_seg, u_b + k, dev), score_bf16)


def test_k2_unaligned_views(dev):
    """Contiguous views off a 16-byte boundary take the plain-load
    staging."""
    rows, V, bi, bits = _k2_inputs(50, 64, 3, 2, dev)

    def shifted(x):
        buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
        buf[1:].copy_(x.reshape(-1))
        return buf[1:].view(x.shape)

    _k2_check(shifted(rows), shifted(V), shifted(bi), shifted(bits), True)


def test_k2_refuses_f32_rows(dev):
    rows = torch.zeros(4, 8, device=dev)
    V = torch.zeros(128, 8, device=dev, dtype=torch.bfloat16)
    with pytest.raises(TypeError):
        ft.fused_scores_cuda(rows, V, torch.zeros(128, device=dev),
                             torch.zeros(4, 4, dtype=torch.int32, device=dev),
                             True)


@pytest.mark.parametrize("idx_dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("w", [3, 64, 128])
def test_row_gather_is_bit_equal(dev, w, dtype, idx_dtype):
    rng = np.random.default_rng(w)
    table = torch.as_tensor(rng.normal(size=(5000, w)), device=dev).to(dtype)
    idx = torch.as_tensor(rng.integers(0, 5000, (300, 7)),
                          device=dev).to(idx_dtype)
    before, before2 = rg.launches, rg.take_launches
    got = rg.row_gather(table, idx)
    idx2 = idx.reshape(-1, 1).expand(-1, w).contiguous()
    got2 = rg.take_along_rows(table, idx2)
    torch.cuda.synchronize()
    assert rg.launches == before + 1 and rg.take_launches == before2 + 1
    assert torch.equal(got, table[idx])
    assert torch.equal(got2, torch.gather(table, 0, idx2.long()))


@pytest.mark.parametrize("broadcast", [True, False])
@pytest.mark.parametrize("idx_dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("w,c", [(64, 64), (128, 128), (64, 40), (64, 37),
                                 (10, 3)])
def test_take_along_rows_is_bit_equal(dev, w, c, dtype, idx_dtype,
                                      broadcast):
    """Every width, c = w and c < w (aligned or not), both index and element
    sizes, row-broadcast and per-element indices; odd m leaves a scalar
    tail."""
    rng = np.random.default_rng(c)
    n, m = 3000, 1001
    table = torch.as_tensor(rng.normal(size=(n, w)), device=dev).to(dtype)
    if broadcast:
        idx = rng.integers(0, n, (m, 1)).repeat(c, 1)
    else:
        idx = rng.integers(0, n, (m, c))
    idx2 = torch.as_tensor(idx, device=dev).to(idx_dtype)
    before = rg.take_launches
    got = rg.take_along_rows(table, idx2)
    torch.cuda.synchronize()
    assert rg.take_launches == before + 1
    assert torch.equal(got, torch.gather(table[:, :c], 0, idx2.long()))


@pytest.mark.parametrize("which", ["table", "idx2"])
@pytest.mark.parametrize("idx_dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_take_along_rows_unaligned_views_are_bit_equal(dev, dtype, idx_dtype,
                                                       which):
    """A contiguous view one element past a 16-byte boundary takes the
    scalar kernel; it too is bit-equal to torch.gather."""
    rng = np.random.default_rng(3)
    n, m, w = 3000, 1001, 64
    table = torch.as_tensor(rng.normal(size=(n, w)), device=dev).to(dtype)
    idx2 = torch.as_tensor(rng.integers(0, n, (m, 1)).repeat(w, 1),
                           device=dev).to(idx_dtype)
    if which == "table":
        buf = torch.empty(n * w + 1, dtype=dtype, device=dev)
        buf[1:].copy_(table.reshape(-1))
        table = buf[1:].view(n, w)
    else:
        buf = torch.empty(m * w + 1, dtype=idx_dtype, device=dev)
        buf[1:].copy_(idx2.reshape(-1))
        idx2 = buf[1:].view(m, w)
    assert table.is_contiguous() and idx2.is_contiguous()
    assert (table.data_ptr() | idx2.data_ptr()) % 16 != 0
    before = rg.take_launches
    got = rg.take_along_rows(table, idx2)
    torch.cuda.synchronize()
    assert rg.take_launches == before + 1
    assert torch.equal(got, torch.gather(table, 0, idx2.long()))


@pytest.mark.parametrize("ridge", [False, True])
@pytest.mark.parametrize("w", [10, 64, 128, 129, 144, 192, 250, 256])
@pytest.mark.parametrize("ne,R", [(300, 32), (40, 600), (4, 5000), (50, 5)])
def test_fused_gram_within_bound(dev, w, ne, R, ridge):
    rng = np.random.default_rng(R)
    n = 2000
    base = np.zeros((n + 1, w), np.float32)
    base[:n] = rng.normal(size=(n, w))
    idx = rng.integers(0, n, (ne, R))
    idx[:, R // 2 + 1:] = n  # padding slots gather the zero row
    idx[-1] = n  # one all-padding entity
    rat = np.where(idx < n, rng.uniform(1, 5, (ne, R)), 0.0)
    table = torch.as_tensor(base, device=dev).bfloat16()
    it = torch.as_tensor(idx, device=dev)
    rt = torch.as_tensor(rat, dtype=torch.float32, device=dev).bfloat16()
    cnt = (it < n).sum(1).float()
    reg = 0.05 * cnt + (cnt == 0) if ridge else None
    before = fg.launches
    A, b = fg.fused_gram(table, it, rt, reg=reg)
    Ap, bp = fg.fused_gram_reference(table, it, rt, reg=reg)
    torch.cuda.synchronize()
    assert fg.launches == before + 1
    bA, bb = fg.fused_gram_bound(table[it].float(), rt, reg)
    assert torch.all((A - Ap).abs() <= bA)
    assert torch.all((b - bp).abs() <= bb)
    assert max(fg.fused_gram_f64_error(table, it, rt, reg, A, b)) <= \
        fg.F64_REL
    assert torch.equal(A, A.transpose(1, 2))
    pad = torch.eye(w, device=dev) if ridge else torch.zeros(w, w, device=dev)
    assert torch.equal(A[-1], pad) and torch.all(b[-1] == 0)


def test_fused_gram_long_lists_against_float64(dev):
    """Few entities with lists as long as the main path's longest (item
    rung R = 129,872, 8 entities): the wrapper splits each list into
    parts and sums them; the result stays within F64_REL of a float64 sum,
    which a part lost from the sum would exceed."""
    rng = np.random.default_rng(129_872)
    n, w, ne, R = 26_744, 64, 8, 129_872
    base = np.zeros((n + 1, w), np.float32)
    base[:n] = rng.normal(0, 0.1, (n, w))
    idx = rng.integers(0, n, (ne, R))
    cnt = rng.integers(R // 3, R, ne)
    idx[np.arange(R)[None, :] >= cnt[:, None]] = n  # padding slots
    idx[-1] = n  # one all-padding entity
    table = torch.as_tensor(base, device=dev).bfloat16()
    it = torch.as_tensor(idx, device=dev)
    rt = torch.as_tensor(np.where(idx < n, rng.uniform(1, 5, (ne, R)), 0.0),
                         dtype=torch.float32, device=dev).bfloat16()
    c = (it < n).sum(1).float()
    reg = 0.05 * c + (c == 0)
    assert fg._parts(ne, R)[0] > 1
    A, b = fg.fused_gram(table, it, rt, reg=reg)
    Ap, bp = fg.fused_gram_reference(table, it, rt, reg=reg)
    torch.cuda.synchronize()
    bA, bb = fg.fused_gram_bound(table[it].float(), rt, reg)
    assert torch.all((A - Ap).abs() <= bA)
    assert torch.all((b - bp).abs() <= bb)
    assert max(fg.fused_gram_f64_error(table, it, rt, reg, A, b)) <= \
        fg.F64_REL
    assert torch.equal(A, A.transpose(1, 2))
    assert torch.equal(A[-1], torch.eye(w, device=dev))
    assert torch.all(b[-1] == 0)


def _weighted_inputs(dev, w, ne, R, n=2000, seed=0, scale=0.3):
    """A bf16 table with a zero trash row n, half-star bf16 ratings, the
    second half of each list padding, one all-padding entity, and a
    symmetric base Gram (a factor table's Gram, as iALS's)."""
    rng = np.random.default_rng(seed)
    base = np.zeros((n + 1, w), np.float32)
    base[:n] = rng.normal(0, scale, (n, w))
    idx = rng.integers(0, n, (ne, R))
    cnt = rng.integers(R // 3, R + 1, ne)
    idx[np.arange(R)[None, :] >= cnt[:, None]] = n
    idx[-1] = n
    rat = np.where(idx < n, rng.integers(1, 11, (ne, R)) * 0.5, 0.0)
    table = torch.as_tensor(base, device=dev).bfloat16()
    V = table.float()
    G = V.T @ V
    return (table, torch.as_tensor(idx, device=dev),
            torch.as_tensor(rat, dtype=torch.float32, device=dev).bfloat16(),
            0.5 * (G + G.T))


@pytest.mark.parametrize("with_base", [False, True])
@pytest.mark.parametrize("w", [10, 64, 100, 128])
@pytest.mark.parametrize("ne,R", [(300, 32), (40, 600), (50, 5)])
def test_fused_gram_weighted_within_bound(dev, w, ne, R, with_base):
    """The weighted mode (iALS, alpha 40) against its plain version within
    fused_gram_bound and against a float64 sum of the same products
    within F64_REL; A bit-symmetric; a second run gives the same bits;
    the padding entity is exactly base + lam I, b = 0; one weighted
    launch."""
    table, it, rt, G = _weighted_inputs(dev, w, ne, R, seed=w + R)
    base = G if with_base else None
    lam, alpha = 0.1, 40.0
    f0, w0 = fg.launches, fg.weighted_launches
    A, b = fg.fused_gram(table, it, rt, lam, alpha=alpha, base=base)
    A2, b2 = fg.fused_gram(table, it, rt, lam, alpha=alpha, base=base)
    Ap, bp = fg.fused_gram_reference(table, it, rt, lam, alpha=alpha,
                                     base=base)
    torch.cuda.synchronize()
    assert fg.launches - f0 == 2 and fg.weighted_launches - w0 == 2
    bA, bb = fg.fused_gram_bound(table[it].float(), rt, lam, alpha=alpha,
                                 base=base)
    assert torch.all((A - Ap).abs() <= bA)
    assert torch.all((b - bp).abs() <= bb)
    assert max(fg.fused_gram_f64_error(table, it, rt, lam, A, b,
                                       alpha=alpha, base=base)) <= fg.F64_REL
    assert torch.equal(A, A.transpose(1, 2))
    assert torch.equal(A, A2) and torch.equal(b, b2)
    pad = lam * torch.eye(w, device=dev)
    if base is not None:
        pad = base + pad
    assert torch.equal(A[-1], pad) and torch.all(b[-1] == 0)


def test_fused_gram_weighted_long_lists_split_into_parts(dev):
    """The item phase's longest rung (8 entities of R = 129,872) in the
    weighted mode: the wrapper splits each list into parts, sums them and
    adds the base Gram and the ridge once, after; within F64_REL of a
    float64 sum (which a part lost, or a base added per part, would
    exceed), bit-symmetric, the padding entity base + lam I exactly."""
    n, w, ne, R = 26_744, 64, 8, 129_872
    table, it, rt, G = _weighted_inputs(dev, w, ne, R, n=n, seed=7,
                                        scale=0.1)
    lam, alpha = 0.1, 40.0
    assert fg._parts(ne, R)[0] > 1
    w0 = fg.weighted_launches
    A, b = fg.fused_gram(table, it, rt, lam, alpha=alpha, base=G)
    A2, b2 = fg.fused_gram(table, it, rt, lam, alpha=alpha, base=G)
    torch.cuda.synchronize()
    assert fg.weighted_launches - w0 == 2
    assert max(fg.fused_gram_f64_error(table, it, rt, lam, A, b,
                                       alpha=alpha, base=G)) <= fg.F64_REL
    assert torch.equal(A, A.transpose(1, 2))
    assert torch.equal(A, A2) and torch.equal(b, b2)
    assert torch.equal(A[-1], G + lam * torch.eye(w, device=dev))
    assert torch.all(b[-1] == 0)


def test_fused_gram_weighted_refuses_the_wide_body(dev):
    table, it, rt, G = _weighted_inputs(dev, 192, 4, 16, n=50)
    with pytest.raises(ValueError, match="w <= 128"):
        fg.fused_gram(table, it, rt, 0.1, alpha=2.0, base=G)


def test_ials_rank64_epoch_runs_the_weighted_fused_gram(dev):
    """A bucketed iALS epoch at rank 64 with bf16 gathers on the card: one
    weighted fused_gram launch a block, no row gather, K1 for the solve;
    the factors within 1e-3 of the same epoch on the CPU (the plain
    einsum route; other summation order) and the trash rows 0."""
    from ycnr_tpu_torch.models import bucketed_phase as bp
    from ycnr_tpu_torch.models.base import init_state, zero_cold_entities
    from ycnr_tpu_torch.ops.bucketed import build_bucketed

    rng = np.random.default_rng(64)
    nu, ni, k, nnz = 3000, 800, 64, 60_000
    pairs = np.unique(np.stack([rng.integers(0, nu, nnz),
                                rng.integers(0, ni, nnz)], 1), axis=0)
    u, i = pairs[:, 0], pairs[:, 1]
    r = (rng.integers(1, 11, len(u)) * 0.5).astype(np.float32)
    ul = build_bucketed(u, i, r, nu, ni, 32, k, max_groups=4)
    il = build_bucketed(i, u, r, ni, nu, 32, k, max_groups=4)
    assert bp.uses_fused(dev, torch.float32, 40.0, True, k)
    blocks = sum(g.other_idx.shape[0] for g in ul + il)
    out = {}
    for d in (dev, "cpu"):
        rdt = torch.bfloat16 if d == dev else None
        dul = bp.device_bucketed(ul, device=d, rating_dtype=rdt)
        dil = bp.device_bucketed(il, device=d, rating_dtype=rdt)
        st = zero_cold_entities(init_state(nu, ni, k, seed=3, device=d),
                                u, i)
        g0, f0, s0 = rg.launches, fg.launches, sp.launches
        w0 = fg.weighted_launches
        out[str(d)] = bp.ials_epoch_fn(dul, dil, 0.1, 40.0, True)(st)
        if d == dev:
            torch.cuda.synchronize()
            assert rg.launches == g0 and sp.launches - s0 == blocks
            assert fg.launches - f0 == blocks
            assert fg.weighted_launches - w0 == blocks
    got, want = out[str(dev)], out["cpu"]
    for x, y in zip(got[:2], want[:2]):
        assert bool(torch.isfinite(x).all()) and not bool(x[-1].any())
        np.testing.assert_allclose(x.cpu().numpy(), y.numpy(), rtol=1e-3,
                                   atol=1e-3 * y.abs().max().item())


def test_fused_branch_refuses_f32_ratings(dev):
    """On CUDA, bf16 ALS-WR runs the fused branch, which reads the layout's
    bf16 ratings as they are and raises on any other."""
    from ycnr_tpu_torch.models import bucketed_phase as bp
    from ycnr_tpu_torch.models.base import init_state
    from ycnr_tpu_torch.ops.bucketed import build_bucketed

    rng = np.random.default_rng(0)
    nu, ni, k = 50, 40, 8
    u, i = rng.integers(0, nu, 600), rng.integers(0, ni, 600)
    r = rng.uniform(1, 5, 600).astype(np.float32)
    lay = build_bucketed(u, i, r, nu, ni, 8, k, max_groups=2)
    st = init_state(nu, ni, k, seed=0, device=dev)
    assert bp.uses_fused(dev, torch.float32, None, True, k)
    with pytest.raises(ValueError, match="ratings"):
        bp.phase_bucketed(st.U, st.V, bp.device_bucketed(lay, device=dev),
                          0.05, gather_bf16=True)
    E = bp.phase_bucketed(st.U, st.V, bp.device_bucketed(
        lay, device=dev, rating_dtype=torch.bfloat16), 0.05,
        gather_bf16=True)
    assert bool(torch.isfinite(E).all())


def test_fused_gram_refuses_what_it_does_not_take(dev):
    table = torch.zeros(10, 8, device=dev)
    idx = torch.zeros(2, 4, dtype=torch.int32, device=dev)
    rat = torch.zeros(2, 4, device=dev).bfloat16()
    with pytest.raises(TypeError):
        fg.fused_gram(table, idx, rat)  # f32 table
    with pytest.raises(ValueError):
        fg.fused_gram(torch.zeros(10, 257, device=dev).bfloat16(), idx, rat)


def _wide_inputs(dev, w, ne=40, R=300, n=500, seed=0, idx_dtype=np.int64):
    rng = np.random.default_rng(seed)
    base = np.zeros((n + 1, w), np.float32)
    base[:n] = rng.normal(0, 0.3, (n, w))
    idx = rng.integers(0, n, (ne, R))
    cnt = rng.integers(R // 3, R + 1, ne)
    cnt[-1] = 0  # one all-padding entity
    idx[np.arange(R)[None, :] >= cnt[:, None]] = n
    rat = np.where(idx < n, rng.uniform(1, 5, (ne, R)), 0.0)
    c = torch.as_tensor(cnt, dtype=torch.float32, device=dev)
    return (torch.as_tensor(base, device=dev).bfloat16(),
            torch.as_tensor(idx.astype(idx_dtype), device=dev),
            torch.as_tensor(rat, dtype=torch.float32, device=dev).bfloat16(),
            0.05 * c + (c == 0))


@pytest.mark.parametrize("idx_dtype", [np.int32, np.int64])
@pytest.mark.parametrize("w", [129, 136, 144, 160, 192, 200, 208, 240, 250,
                               256])
def test_fused_gram_wide_matches_its_mirror(dev, w, idx_dtype):
    """The wide body against its plain-torch mirror
    (tests/fused_gram_wide_mirror.py) and the plain version: the mirror
    sums each wgmma step's 16 products in f32 in another order than the
    tensor core, so both are held within the plain version's bound (the
    kernel to the mirror within twice it); A bit-symmetric, padding
    exact, a second run bit-equal."""
    from fused_gram_wide_mirror import fused_gram_wide_mirror

    table, it, rt, reg = _wide_inputs(dev, w, seed=w, idx_dtype=idx_dtype)
    A, b = fg.fused_gram(table, it, rt, reg=reg)
    A2, b2 = fg.fused_gram(table, it, rt, reg=reg)
    Am, bm = fused_gram_wide_mirror(table.cpu(), it.cpu(), rt.cpu(),
                                    reg.cpu())
    torch.cuda.synchronize()
    bA, bb = fg.fused_gram_bound(table[it].float(), rt, reg)
    assert torch.equal(A, A2) and torch.equal(b, b2)
    assert torch.all((A.cpu() - Am).abs() <= 2 * bA.cpu())
    assert torch.all((b.cpu() - bm).abs() <= 2 * bb.cpu())
    Ap, bp = fg.fused_gram_reference(table, it, rt, reg=reg)
    assert torch.all((A - Ap).abs() <= bA)
    assert torch.all((b - bp).abs() <= bb)
    assert torch.equal(A, A.transpose(1, 2))
    assert torch.equal(A[-1], torch.eye(w, device=dev)) and \
        torch.all(b[-1] == 0)


@pytest.mark.parametrize("w", [192, 256])
def test_fused_gram_wide_unaligned_table_takes_plain_loads(dev, w):
    """A table not on a 16-byte boundary goes through the wide body's
    plain loads: the same bound, symmetry and padding."""
    table, it, rt, reg = _wide_inputs(dev, w, seed=1)
    buf = torch.empty(table.numel() + 1, dtype=torch.bfloat16, device=dev)
    buf[1:].copy_(table.reshape(-1))
    tab = buf[1:].view(table.shape)
    assert tab.data_ptr() % 16 != 0
    A, b = fg.fused_gram(tab, it, rt, reg=reg)
    Ap, bp = fg.fused_gram_reference(tab, it, rt, reg=reg)
    torch.cuda.synchronize()
    bA, bb = fg.fused_gram_bound(tab[it].float(), rt, reg)
    assert torch.all((A - Ap).abs() <= bA)
    assert torch.all((b - bp).abs() <= bb)
    assert torch.equal(A, A.transpose(1, 2))
    assert torch.equal(A[-1], torch.eye(w, device=dev))


def test_fused_gram_wide_long_lists_split_into_parts(dev):
    """Few entities with long lists at w 192: the wrapper cuts them at the
    wide body's fill and sums the parts; within F64_REL of float64."""
    table, it, rt, reg = _wide_inputs(dev, 192, ne=4, R=20_000, n=5000,
                                      seed=2)
    assert fg._parts(4, 20_000, fg.fill_blocks(192))[0] > 1
    A, b = fg.fused_gram(table, it, rt, reg=reg)
    torch.cuda.synchronize()
    assert max(fg.fused_gram_f64_error(table, it, rt, reg, A, b)) <= \
        fg.F64_REL
    assert torch.equal(A, A.transpose(1, 2))
    assert torch.equal(A[-1], torch.eye(192, device=dev))


@pytest.mark.parametrize("w", [192, 256])
def test_fused_gram_wide_persistent_grid_is_bit_equal(dev, w):
    """More items than the persistent grid has blocks (1,000 entities of
    300 slots, one part each): two runs are bit-equal, and each entity's A
    and b are the bits of a call on the first 100 entities alone (another
    grid, another block for every item), as one warpgroup's chain per
    entry makes them."""
    table, it, rt, reg = _wide_inputs(dev, w, ne=1000, R=300, seed=5)
    assert fg._parts(1000, 300, fg.fill_blocks(w))[0] == 1
    assert fg._parts(100, 300, fg.fill_blocks(w))[0] == 1
    A, b = fg.fused_gram(table, it, rt, reg=reg)
    A2, b2 = fg.fused_gram(table, it, rt, reg=reg)
    As, bs = fg.fused_gram(table, it[:100].contiguous(),
                           rt[:100].contiguous(), reg=reg[:100].contiguous())
    torch.cuda.synchronize()
    assert torch.equal(A, A2) and torch.equal(b, b2)
    assert torch.equal(A[:100], As) and torch.equal(b[:100], bs)
    assert max(fg.fused_gram_f64_error(table, it, rt, reg, A, b)) <= \
        fg.F64_REL


@pytest.mark.parametrize("ne", [1, 2, 50])
@pytest.mark.parametrize("w", [144, 192, 256])
def test_fused_gram_wide_grids_smaller_than_the_card(dev, w, ne):
    """Fewer items than SMs (one entity; a few; 50 entities of 300 slots,
    one part each): the grid shrinks to the items, and each entity still
    comes out within the bound of the plain version and F64_REL of
    float64, bit-symmetric, the padding entity exact (ne > 1)."""
    table, it, rt, reg = _wide_inputs(dev, w, ne=ne, R=300, seed=ne)
    assert fg._parts(ne, 300, fg.fill_blocks(w))[0] == 1
    A, b = fg.fused_gram(table, it, rt, reg=reg)
    Ap, bp = fg.fused_gram_reference(table, it, rt, reg=reg)
    torch.cuda.synchronize()
    bA, bb = fg.fused_gram_bound(table[it].float(), rt, reg)
    assert torch.all((A - Ap).abs() <= bA)
    assert torch.all((b - bp).abs() <= bb)
    assert max(fg.fused_gram_f64_error(table, it, rt, reg, A, b)) <= \
        fg.F64_REL
    assert torch.equal(A, A.transpose(1, 2))
    if ne > 1:
        assert torch.equal(A[-1], torch.eye(w, device=dev))
        assert torch.all(b[-1] == 0)


@pytest.mark.parametrize("offset", [0, 1, 2, 3])
@pytest.mark.parametrize("w", [16, 17, 33, 34])
def test_row_gather_narrow_rows_of_a_tile_are_bit_equal(dev, w, offset):
    """The SGD and BPR tables: f32 rows of 64, 68, 132 and 136 bytes, and a
    slice view starting at any row (the stream epoch's tile), so the base
    address is 16-, 8- or 4-byte aligned: every vector width of the
    kernel."""
    rng = np.random.default_rng(w + offset)
    full = torch.as_tensor(rng.normal(size=(4001, w)), dtype=torch.float32,
                           device=dev)
    tile = full[offset:offset + 3000]
    idx = torch.as_tensor(rng.integers(0, 3000, 8192), device=dev)
    before = rg.launches
    got = rg.row_gather(tile, idx)
    torch.cuda.synchronize()
    assert rg.launches == before + 1
    assert torch.equal(got, tile[idx])


def _implicit(nu, ni, nnz, seed):
    rng = np.random.default_rng(seed)
    # Zipf-like users and items: many duplicates within a batch
    u = np.minimum(rng.zipf(1.3, nnz) - 1, nu - 1).astype(np.int32)
    i = np.minimum(rng.zipf(1.3, nnz) - 1, ni - 1).astype(np.int32)
    r = rng.uniform(1, 5, nnz).astype(np.float32)
    return u, i, r


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_scatter_add_is_deterministic_and_right(dev, dtype):
    """``models.base.scatter_add_`` on the card: duplicates accumulate (as
    ``np.add.at``), and ten runs give the same bits, which ``index_add_``
    with its atomics does not promise."""
    from ycnr_tpu_torch.models.base import scatter_add_

    rng = np.random.default_rng(0)
    idx = np.minimum(rng.zipf(1.2, 65_536) - 1, 999)
    delta = rng.normal(size=(65_536, 17))
    want = np.zeros((1001, 17))
    np.add.at(want, idx, delta)
    ti = torch.as_tensor(idx, device=dev)
    td = torch.as_tensor(delta, dtype=dtype, device=dev)
    runs = [scatter_add_(torch.zeros(1001, 17, dtype=dtype, device=dev), ti,
                         td) for _ in range(10)]
    torch.cuda.synchronize()
    assert all(torch.equal(runs[0], r) for r in runs[1:])
    tol = 1e-9 if dtype == torch.float64 else 2e-3
    np.testing.assert_allclose(runs[0].cpu().numpy(), want, atol=tol)
    assert not bool(runs[0][1000].any())


@pytest.mark.parametrize("trainer", ["sgd-sum", "sgd-mean", "stream", "bpr-rows",
                                     "bpr-batches"])
def test_one_epoch_twice_gives_the_same_bits(dev, trainer):
    """Same seed => bitwise same factors, on the card, with hot entities
    that repeat within every batch; the result also agrees with the same
    epoch on the CPU (plain gathers, in-order adds) to f32 rounding."""
    from ycnr_tpu_torch.models import base, bpr, sgd, sgd_stream

    nu, ni, k, B = 700, 300, 16, 2048
    u, i, r = _implicit(nu, ni, 30_000, 3)

    def epoch(device):
        st = base.init_state(nu, ni, k, seed=1, mu=3.0, device=device)
        if trainer.startswith("sgd"):
            d = sgd.prepare_sgd_data(u, i, r, B, nu, ni, device=device)
            perm = np.random.default_rng(5).permutation(d.u.shape[0])
            # "sum" adds a hot user's ~500 terms a batch: a small step
            lr = 2e-4 if trainer == "sgd-sum" else 0.01
            return sgd.sgd_epoch(st, d, perm, 0.02, lr, B,
                                 trainer.split("-")[1])
        if trainer == "stream":
            d, _ = sgd_stream.prepare_stream_sgd(u, i, r, B, nu, ni, seed=2,
                                                 device=device)
            order = np.random.default_rng(5).permutation(d.ul.shape[0])
            return sgd_stream.sgd_stream_epoch(
                st, d.ul, d.ib, d.rb, d.wu, d.wi, d.u_lo, order, 0.02, 0.01,
                d.tile)
        batches = trainer == "bpr-batches"
        d = bpr.prepare_bpr_data(u, i, B, nu, ni, device=device,
                                 shuffle_rows_seed=0 if batches else None)
        n_pad = d.u.shape[0]
        rng = np.random.default_rng(5)
        negs = rng.integers(0, ni, n_pad)
        if batches:
            return bpr.bpr_epoch_batches(st, d, rng.permutation(n_pad // B),
                                         negs, 0.01, 0.05, B, "emean")
        return bpr.bpr_epoch(st, d, rng.permutation(n_pad), negs, 0.01,
                             0.05, B, "emean")

    before = rg.launches
    a, b = epoch(dev), epoch(dev)
    torch.cuda.synchronize()
    assert rg.launches > before  # the gathers went through the kernel
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    for x, y in zip(a, epoch("cpu")):
        assert bool(torch.isfinite(x).all())
        np.testing.assert_allclose(x.cpu().numpy(), y.numpy(), rtol=1e-4,
                                   atol=1e-5)
    for x in a[:4]:
        assert not bool(x[-1].any())  # trash rows stay zero


def test_serving_asked_for_k2_runs_k2_or_raises(dev):
    """On the card ``recommend_all`` and ``train()``'s serving measurement
    never give way to the exact scorer: a catalog too small for the fused
    select raises, a large enough one launches K2 and says so."""
    from ycnr_tpu_torch.config import ALSConfig, DataConfig, RunConfig
    from ycnr_tpu_torch.data.dataset import load_dataset
    from ycnr_tpu_torch.eval.recommend import recommend_all
    from ycnr_tpu_torch.models.base import init_state
    from ycnr_tpu_torch.train.loop import _log_serving_metric
    from ycnr_tpu_torch.train.metrics import MetricsLogger

    class Events(MetricsLogger):
        def __init__(self):
            super().__init__(None)
            self.events = []

        def log(self, **kw):
            self.events.append(kw)

    for n_items, fused in ((120, False), (1400, True)):
        cfg = RunConfig(name="t", algorithm="als", scorer="fused",
                        measure_serving=True, out_dir="",
                        data=DataConfig(n_users=200, n_items=n_items,
                                        n_ratings=4000, true_rank=4, seed=0),
                        als=ALSConfig(rank=8, epochs=1))
        ds = load_dataset(cfg.data, rank_hint=8)
        st = init_state(ds.n_users, ds.n_items, 8, seed=0, device=dev)
        log = Events()
        before = ft.launches
        if not fused:
            with pytest.raises(ValueError, match="too few"):
                _log_serving_metric(cfg, ds, st, log)
            with pytest.raises(ValueError, match="too few"):
                recommend_all(st, ds.user_layout, 10, method="fused32")
            assert ft.launches == before and not log.events
            continue
        _log_serving_metric(cfg, ds, st, log)
        torch.cuda.synchronize()
        assert ft.launches > before
        assert log.events[-1]["scorer"] == "fused"
        users, ids, _ = recommend_all(st, ds.user_layout, 10, method="fused")
        assert ids.shape == (len(np.unique(ds.train_u)), 10)


def _rank192_epochs(dev, fused: bool):
    """One rank-192 bf16 ALS-WR epoch on the card (the fused branch, or
    with ``uses_fused`` patched to False the row gather -> einsum -> K1
    route) and the same epoch on the CPU; the card's launch counts."""
    from unittest import mock

    from ycnr_tpu_torch.models import bucketed_phase as bp
    from ycnr_tpu_torch.models.base import init_state
    from ycnr_tpu_torch.ops.bucketed import build_bucketed

    rng = np.random.default_rng(192)
    nu, ni, k = 300, 200, 192
    u, i = rng.integers(0, nu, 6000), rng.integers(0, ni, 6000)
    r = rng.uniform(1, 5, 6000).astype(np.float32)
    ul = build_bucketed(u, i, r, nu, ni, 32, k, max_groups=3)
    il = build_bucketed(i, u, r, ni, nu, 32, k, max_groups=3)
    assert bp.uses_fused(dev, torch.float32, None, True, k)
    route = (contextlib.nullcontext() if fused else
             mock.patch.object(bp, "uses_fused", lambda *a: False))
    out, counts = {}, {}
    for d in (dev, "cpu"):
        st = init_state(nu, ni, k, seed=3, device=d)
        rdt = torch.bfloat16 if fused and d == dev else None
        epoch = bp.als_epoch_fn(
            bp.device_bucketed(ul, device=d, rating_dtype=rdt),
            bp.device_bucketed(il, device=d, rating_dtype=rdt), 0.05,
            gather_bf16=True)
        g0, s0, r0 = fg.launches, sp.launches, rg.launches
        with route:
            out[str(d)] = epoch(st)
        if d == dev:
            torch.cuda.synchronize()
            counts = {"fused_gram": fg.launches - g0,
                      "spd_solve": sp.launches - s0,
                      "row_gather": rg.launches - r0}
    return out[str(dev)], out["cpu"], counts


def test_rank192_bucketed_epoch_takes_the_einsum_route(dev):
    """With the route patched back (``uses_fused`` False), bf16 ALS-WR at
    rank 192 on the card runs row gather -> einsum -> K1 (the tiled body
    at n = 192), never fused_gram; the epoch agrees with the same epoch on
    the CPU and keeps the trash rows 0."""
    a, b, counts = _rank192_epochs(dev, fused=False)
    assert counts["fused_gram"] == 0 and counts["row_gather"] > 0
    assert counts["spd_solve"] > 0
    for x, y in zip(a[:2], b[:2]):
        assert bool(torch.isfinite(x).all()) and not bool(x[-1].any())
        np.testing.assert_allclose(x.cpu().numpy(), y.numpy(), rtol=1e-3,
                                   atol=1e-3 * y.abs().max().item())


def test_rank192_bucketed_epoch_takes_the_wide_body(dev):
    """bf16 ALS-WR at rank 192 on the card runs fused_gram's wide body ->
    K1, no row gather; the epoch agrees with the same epoch on the CPU
    (the plain route) and keeps the trash rows 0."""
    a, b, counts = _rank192_epochs(dev, fused=True)
    assert counts["fused_gram"] > 0 and counts["row_gather"] == 0
    assert counts["spd_solve"] > 0
    for x, y in zip(a[:2], b[:2]):
        assert bool(torch.isfinite(x).all()) and not bool(x[-1].any())
        np.testing.assert_allclose(x.cpu().numpy(), y.numpy(), rtol=1e-3,
                                   atol=1e-3 * y.abs().max().item())


def test_rank256_phase_splits_its_long_lists(dev):
    """One rank-256 ALS-WR item phase through ``phase_bucketed`` on blocks
    of fewer entities than the wide body's fill, with lists of 2,500-6,000
    slots, so that every block splits: each block's A within F64_REL of a
    float64 sum, the phase's rows as the plain path's on the CPU,
    ``split_launches`` and ``part_bytes`` as ``_parts`` gives them, and
    one ``part_sum`` span a block inside its ``normal_eq``."""
    from unittest import mock

    from ycnr_tpu_torch.models import bucketed_phase as bp
    from ycnr_tpu_torch.ops.bucketed import build_bucketed
    from ycnr_tpu_torch.utils import profiling as prof

    rng = np.random.default_rng(256)
    n_items, n_users, k, lam = 60, 8000, 256, 0.065
    cnt = rng.integers(2500, 6001, n_items)
    i = np.repeat(np.arange(n_items), cnt)
    u = np.concatenate([rng.choice(n_users, c, replace=False) for c in cnt])
    r = (rng.integers(1, 11, len(u)) * 0.5).astype(np.float32)
    groups = build_bucketed(i, u, r, n_items, n_users, 32, k, max_groups=2)
    shapes = [g.other_idx.shape[1:] for g in groups
              for _ in range(g.other_idx.shape[0])]
    parts = [fg._parts(ne, R, fg.fill_blocks(k))[0] for ne, R in shapes]
    assert all(ne < 264 and R >= 2048 and s > 1
               for (ne, R), s in zip(shapes, parts))
    F = torch.zeros(n_users + 1, k)
    F[:-1] = 0.1 * torch.randn(n_users, k,
                               generator=torch.Generator().manual_seed(1))
    calls = []

    def recording(table, idx, rat, reg=None, **kw):
        A, b = real(table, idx, rat, reg, **kw)
        calls.append((table, idx, rat, reg, A.clone(), b.clone()))
        return A, b

    real = bp.fused_gram
    dg = bp.device_bucketed(groups, device=dev, rating_dtype=torch.bfloat16)
    counts0 = (fg.launches, fg.split_launches, fg.part_bytes)
    prof.drain()
    prof.enable()
    try:
        with mock.patch.object(bp, "fused_gram", recording):
            got = bp.phase_bucketed(torch.zeros(n_items + 1, k, device=dev),
                                    F.to(dev), dg, lam, gather_bf16=True)
        torch.cuda.synchronize()
    finally:
        prof.disable()
    spans = prof.drain().spans
    assert (fg.launches - counts0[0], fg.split_launches - counts0[1],
            fg.part_bytes - counts0[2]) == (
        len(shapes), len(shapes),
        sum(fg.part_bytes_of(ne, s, k) for (ne, _), s in zip(shapes, parts)))
    by_id = {s.id: s for s in spans}
    sums = [s for s in spans if s.name == "part_sum"]
    assert len(sums) == len(shapes)
    assert all(by_id[s.parent].name == "normal_eq" for s in sums)
    assert len(calls) == len(shapes)
    for table, idx, rat, reg, A, b in calls:
        assert max(fg.fused_gram_f64_error(table, idx, rat, reg, A, b)) <= \
            fg.F64_REL
        assert torch.equal(A, A.transpose(1, 2))
    want = bp.phase_bucketed(torch.zeros(n_items + 1, k), F,
                             bp.device_bucketed(groups, device="cpu"), lam,
                             gather_bf16=True)
    assert bool(torch.isfinite(got).all()) and not bool(got[-1].any())
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=1e-3,
                               atol=1e-3 * want.abs().max().item())


def test_cli_train_and_recommend_all_fused_on_the_card(dev, tmp_path,
                                                       capsys):
    """python -m ycnr_tpu_torch on the card (the default device): train a
    bf16 ALS-WR preset from a store (fused_gram + K1), then recommend --all
    --scorer fused launches K2, serves no rated item and gives the
    in-process recommend_all's ids."""
    import json

    from ycnr_tpu_torch.cli import main
    from ycnr_tpu_torch.data.store import RatingsStore
    from ycnr_tpu_torch.eval.recommend import recommend_all
    from ycnr_tpu_torch.ops.layout import build_blocked_csr
    from ycnr_tpu_torch.train.checkpoint import load_checkpoint

    store = str(tmp_path / "s")
    main(["prepare", "--source", "synthetic", "--store", store, "--users",
          "400", "--items", "2000", "--ratings", "30000"])
    g0, s0 = fg.launches, sp.launches
    main(["train", "--preset", "ml20m-als", "--store", store, "--epochs",
          "2", "--rank", "16", "--out", str(tmp_path / "runs")])
    assert fg.launches > g0 and sp.launches > s0
    capsys.readouterr()
    ckpt = str(tmp_path / "runs" / "ml20m-als" / "ckpt")
    k0 = ft.launches
    main(["recommend", "--ckpt", ckpt, "--store", store, "--all", "-n",
          "10", "--scorer", "fused", "--save", str(tmp_path / "r.jsonl")])
    assert ft.launches > k0
    rows = [json.loads(x) for x in open(tmp_path / "r.jsonl")]
    u, i, r = RatingsStore(store).read_all()
    state, _ = load_checkpoint(ckpt)
    lay = build_blocked_csr(u, i, r, state.n_users, state.n_items,
                            rank_hint=state.rank)
    users, items, _ = recommend_all(state, lay, n=10, method="fused")
    assert [x["user"] for x in rows] == users.tolist()
    for x, want in zip(rows, items):
        assert x["items"] == want.tolist()
        assert not set(x["items"]) & set(i[u == x["user"]].tolist())


def _shm_serving_setup(dev, name, n_users=300, n_items=3000, rank=16):
    """A state published into a fresh segment, read back onto the card
    through ShmRecommender with a fresh ShmRecCache."""
    from ycnr_tpu_torch.data.synthetic import synthetic_ratings
    from ycnr_tpu_torch.models.base import init_state
    from ycnr_tpu_torch.serve.cache import ShmRecCache
    from ycnr_tpu_torch.serve.shm import FactorShmWriter, ShmRecommender

    u, i, _ = synthetic_ratings(n_users, n_items, 20_000, true_rank=4,
                                seed=2)
    w = FactorShmWriter(name, n_users, n_items, rank)
    w.publish(init_state(n_users, n_items, rank, seed=1, device=dev), 3)
    cache = ShmRecCache(name + "c", 1 << 12)
    rec = ShmRecommender(name, u, i, cache=cache)  # the default: the card
    return w, cache, rec, u, i


def _shm_teardown(w, cache, rec):
    rec.close()
    cache.close()
    cache.unlink()
    w.close()
    w.unlink()


def test_shm_reader_lands_every_tensor_on_the_card(dev):
    import uuid

    from ycnr_tpu_torch.models.base import init_state
    from ycnr_tpu_torch.serve.shm import FactorShmReader, FactorShmWriter

    name = f"/ycnr_tcuda_{uuid.uuid4().hex[:10]}"
    state = init_state(50, 40, 8, seed=4, mu=1.5, device=dev)
    with FactorShmWriter(name, 50, 40, 8) as w:
        w.publish(state, 7)
        with FactorShmReader(name) as r:
            got, e = r.read()  # the default device: the card
        w.unlink()
    assert e == 7
    for a, b in zip(got, state):
        assert a.is_cuda and a.dtype == torch.float32
        assert torch.equal(a, b)


def test_precompute_through_the_shm_cache_launches_k2(dev):
    """ShmRecommender on the card: precompute_all fills the shared cache
    through K2, and a request is then a cache hit equal to scoring."""
    import uuid

    w, cache, rec, u, i = _shm_serving_setup(
        dev, f"/ycnr_tcuda_{uuid.uuid4().hex[:10]}")
    try:
        k0 = ft.launches
        n = rec.engine.precompute_all(10)
        torch.cuda.synchronize()
        assert ft.launches > k0 and n == len(np.unique(u))
        hits = cache.hits
        got = rec.recommend(int(u[0]), 10)
        assert cache.hits == hits + 1
        assert not set(got.tolist()) & set(i[u == u[0]].tolist())
    finally:
        _shm_teardown(w, cache, rec)


def test_cold_request_launches_k1_and_row_gather(dev):
    """A cold: line through ServingApp on the card folds the user in with
    row_gather + K1 and serves none of the items it rated."""
    import json
    import uuid

    from ycnr_tpu_torch.serve.server import ServingApp

    w, cache, rec, u, i = _shm_serving_setup(
        dev, f"/ycnr_tcuda_{uuid.uuid4().hex[:10]}")
    app = ServingApp(rec, n=10, shm=True)
    try:
        s0, g0 = sp.launches, rg.launches
        out = json.loads(app.handle("cold:3:5.0,17:4.0,250:1.0"))
        torch.cuda.synchronize()
        assert sp.launches > s0 and rg.launches > g0
        assert len(out["items"]) == 10 and not {3, 17, 250} & set(
            out["items"])
    finally:
        app.close()
        _shm_teardown(w, cache, rec)


# --- out of core (models/ooc.py, the compact SGD wire) ---------------------

def _ooc_problem(n_users=3000, n_items=800, n=60_000, raw=False):
    from ycnr_tpu_torch.data.synthetic import synthetic_ratings

    u, i, r = synthetic_ratings(n_users, n_items, n, true_rank=4, seed=3,
                                rating_levels=not raw)
    return u, i, r


@pytest.mark.parametrize("raw", [False, True])
def test_ooc_decode_on_cuda_equals_cpu(dev, raw):
    """The packed and RECT decodes on the card give the CPU's blocks bit
    for bit (int8 and raw ratings, deltas >= 32,768 and their overflow
    bits, bf16 and f32 ratings)."""
    from ycnr_tpu_torch.models import ooc
    from ycnr_tpu_torch.ops import packed

    rng = np.random.default_rng(0)
    e = np.repeat(np.arange(300), 40)
    o = rng.integers(0, 500_000, len(e))
    r = (rng.standard_normal(len(e)).astype(np.float32) if raw
         else rng.integers(1, 11, len(e)) / 2.0)
    kw = dict(rank_hint=16, target_bytes=1 << 18, max_groups=3)
    for wire in (packed.build_packed(e, o, r, 300, 500_000, **kw),
                 packed.build_rect(e, o, r, 300, 500_000, **kw)):
        assert any((g.lo >= 32768).any() and g.hi_val.any() for g in wire)
        for g in wire:
            dec = (ooc.decode_block_rect if g.lo.ndim == 3
                   else ooc.decode_block)
            for b in range(g.n_blocks):
                blk = [getattr(g, n)[b] for n in ooc._WIRE_NAMES[:5]]
                for dt in (torch.float32, torch.bfloat16):
                    c = dec(*(ooc.wire_tensor(x, "cpu") for x in blk), g.R,
                            g.n_other, dt)
                    d = dec(*(ooc.wire_tensor(x, dev) for x in blk), g.R,
                            g.n_other, dt)
                    for x, y in zip(c, d):
                        assert torch.equal(x, y.cpu())


@pytest.mark.parametrize("algo,k", [("als", 32), ("ials", 32), ("ials", 136)],
                         ids=["als", "ials", "ials_rank136"])
def test_streamed_epoch_equals_pinned_and_resident(dev, algo, k):
    """On the card, with bf16 gathers, a host-streamed epoch, in chunks of
    one block so many chunks are in flight, a pinned epoch (RECT and
    packed) and the resident bucketed epoch give the same bits. At rank 32
    that is fused_gram + K1 for ALS-WR and fused_gram's weighted mode + K1
    for iALS, with no row gather; iALS at rank 136 keeps the row gather,
    the einsums and K1, with no fused_gram."""
    from ycnr_tpu_torch.models import base, bucketed_phase as bp, ooc
    from ycnr_tpu_torch.ops import bucketed, packed

    u, i, r = _ooc_problem()
    kw = dict(rank_hint=32, target_bytes=1 << 20, max_groups=4)
    up = packed.build_packed(u, i, r, 3000, 800, **kw)
    ip = packed.build_packed(i, u, r, 800, 3000, **kw)
    alpha = None if algo == "als" else 2.0
    fused = bp.uses_fused(dev, torch.float32, alpha, True, k)
    assert fused == (k <= 128)
    rdt = torch.bfloat16 if fused else None
    ug = bp.device_bucketed(bucketed.build_bucketed(u, i, r, 3000, 800,
                                                    **kw), device=dev,
                            rating_dtype=rdt)
    ig = bp.device_bucketed(bucketed.build_bucketed(i, u, r, 800, 3000,
                                                    **kw), device=dev,
                            rating_dtype=rdt)

    def start():
        return base.init_state(3000, 800, k, seed=1, device=dev)

    if alpha is None:
        ref = bp.als_epoch_fn(ug, ig, 0.05, True)(start())
    else:
        ref = bp.ials_epoch_fn(ug, ig, 0.1, alpha, True)(start())
    runs = []
    for wire in ((up, ip), ooc.wire_to_device(up, ip, device=dev)[:2],
                 ooc.wire_to_device(up, ip, pin_format="keep",
                                    device=dev)[:2]):
        g0, f0, s0 = rg.launches, fg.launches, sp.launches
        w0 = fg.weighted_launches
        if alpha is None:
            st = ooc.als_epoch_ooc(start(), *wire, 0.05, gather_bf16=True,
                                   chunk_blocks=1)
        else:
            st = ooc.ials_epoch_ooc(start(), *wire, 0.1, alpha,
                                    gather_bf16=True, chunk_blocks=1)
        torch.cuda.synchronize()
        assert sp.launches > s0
        if fused:
            assert fg.launches > f0 and rg.launches == g0
            assert fg.weighted_launches - w0 == (0 if alpha is None
                                                 else fg.launches - f0)
        else:
            assert rg.launches > g0 and fg.launches == f0
        runs.append(st)
    for st in runs:
        assert torch.equal(st.U, ref.U) and torch.equal(st.V, ref.V)


def test_stream_sgd_four_forms_bit_equal_on_cuda(dev):
    """The four stream-SGD forms (flat / compact, resident / streamed in
    chunks of 3 batches) give the same bits on the card."""
    from ycnr_tpu_torch.models import base, sgd_stream as ss
    from ycnr_tpu_torch.ops import sgd_wire

    u, i, r = _ooc_problem(600, 300, 20_000)
    flat, _ = ss.prepare_stream_sgd(u, i, r, 512, 600, 300, seed=2,
                                    device=dev)
    host, _ = ss.prepare_stream_sgd(u, i, r, 512, 600, 300, seed=2,
                                    device=False)
    comp = sgd_wire.compact_from_stream(host, 300)
    order = np.random.default_rng(4).permutation(flat.ul.shape[0])

    def start():
        st = base.init_state(600, 300, 16, seed=3, mu=3.5, device=dev)
        return st

    outs = [ss.sgd_stream_epoch(start(), flat.ul, flat.ib, flat.rb, flat.wu,
                                flat.wi, flat.u_lo, order, 0.02, 0.01,
                                flat.tile),
            ss.sgd_stream_epoch_ooc(start(), host, order, 0.02, 0.01,
                                    chunk_batches=3),
            ss.sgd_stream_epoch_pinned(start(),
                                       sgd_wire.put_compact(comp, dev),
                                       order, 0.02, 0.01),
            ss._compact_epoch_ooc(start(), comp, order, 0.02, 0.01,
                                  chunk_batches=3)]
    torch.cuda.synchronize()
    for st in outs[1:]:
        for a, b in zip(st[:4], outs[0][:4]):
            assert torch.equal(a, b)


# --- the mesh on the card (parallel/) --------------------------------------

@pytest.mark.parametrize("backend,world", [("nccl", 1), ("gloo", 2)])
def test_mesh_collectives_on_cuda_tensors(dev, backend, world):
    """All-reduce, all-gather and broadcast of CUDA tensors in real rank
    processes: NCCL on one card, gloo with two ranks on it."""
    from ycnr_tpu_torch.parallel.mesh import spawn_ranks

    got = spawn_ranks("ycnr_tpu_torch.parallel.mesh:collective_check",
                      world, backend=backend, device="cuda")
    assert got == {"ok": True, "backend": backend, "device": "cuda:0",
                   "world": world}


def test_sharded_train_two_gloo_ranks_on_one_card(dev, tmp_path):
    """train() at n_shards=2 over gloo with both ranks on cuda:0, f32:
    the held-out RMSE within 1e-4 of the CPU float64 sharded run, the
    gathered state on the card, trash rows 0."""
    import dataclasses

    from ycnr_tpu_torch.config import MeshConfig, get_preset
    from ycnr_tpu_torch.data.dataset import load_dataset
    from ycnr_tpu_torch.train.loop import train

    cfg = get_preset("ml100k-als")
    cfg = dataclasses.replace(
        cfg, out_dir=None, mesh=MeshConfig(n_shards=2),
        als=dataclasses.replace(cfg.als, epochs=3, rank=16),
        data=dataclasses.replace(cfg.data, source="synthetic", n_users=600,
                                 n_items=300, n_ratings=20_000))
    ds = load_dataset(cfg.data, rank_hint=16)
    got = train(cfg, ds, device="cuda", backend="gloo")
    f64 = dataclasses.replace(cfg, als=dataclasses.replace(
        cfg.als, dtype="float64"))
    ref = train(f64, ds, device="cpu")
    assert got.state.U.is_cuda
    np.testing.assert_allclose(got.rmse_history, ref.rmse_history, rtol=0,
                               atol=1e-4)
    assert not got.state.U[-1].any() and not got.state.V[-1].any()


# --- out of core on the mesh (parallel/ooc_mesh.py) -------------------------

@pytest.mark.parametrize("algo,k", [("als", 32), ("ials", 32), ("ials", 136)],
                         ids=["als", "ials", "ials_rank136"])
def test_sharded_ooc_epoch_on_the_card(dev, algo, k):
    """Two gloo thread ranks on cuda:0, bf16 gathers: the streamed tier
    (chunks of one block) gives the pinned tier's bits; K1 launches, at
    rank 32 with ``fused_gram`` (iALS: its weighted mode, the item phase's
    partials without base or ridge) and no ``row_gather``, for iALS at
    rank 136 with ``row_gather`` (the einsum route, ``gather_normal_eq``
    in the item phase) and no ``fused_gram``; the gathered factors lie
    within 1e-3 of the same epoch's plain version on the CPU (f32,
    bf16-rounded gathers; other summation order); trash rows 0."""
    from ycnr_tpu_torch.models.base import init_state
    from ycnr_tpu_torch.parallel import ooc_mesh as om
    from ycnr_tpu_torch.parallel import shard as sh
    from ycnr_tpu_torch.parallel.mesh import run_ranks

    u, i, r = _ooc_problem()
    sw, meta = om.build_sharded_wire(u, i, r, 3000, 800, 2, rank_hint=32,
                                     target_bytes=1 << 20, max_groups=4)
    alpha = None if algo == "als" else 2.0

    def run(device, tier):
        def rank(m):
            st = sh.scatter_state(init_state(3000, 800, k, seed=1,
                                             device=device), meta, m)
            if tier == "pinned":
                ep = om.make_sharded_ooc_epoch(
                    m, om.put_sharded_wire(sw, m), 0.05, alpha=alpha,
                    gather_bf16=True)
                st = ep(st)
            else:
                ep = om.make_sharded_ooc_epoch(m, None, 0.05, alpha=alpha,
                                               gather_bf16=True,
                                               wire_as_args=True,
                                               chunk_blocks=1)
                st = ep(st, om.feed_sharded_wire(sw, m))
            g = sh.gather_state(st, meta, m)
            return g.U.cpu(), g.V.cpu(), bool(st.U[-1].any())

        return run_ranks(rank, 2, device=device)

    g0, f0, s0 = rg.launches, fg.launches, sp.launches
    w0 = fg.weighted_launches
    pinned = run(dev, "pinned")
    torch.cuda.synchronize()
    assert sp.launches > s0
    if k <= 128:
        assert fg.launches > f0 and rg.launches == g0
        assert fg.weighted_launches - w0 == (0 if algo == "als"
                                             else fg.launches - f0)
    else:
        assert rg.launches > g0 and fg.launches == f0
    streamed = run(dev, "streamed")
    plain = run("cpu", "pinned")[0]
    for a, b in zip(pinned, streamed):
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
        assert not a[2]
    for got, want in zip(pinned[0][:2], plain[:2]):
        assert (got - want).abs().max() <= 1e-3 * want.abs().max()


def test_sharded_ooc_train_two_gloo_ranks_on_one_card(dev):
    """train(ooc=True) at n_shards=2 over gloo with both ranks on cuda:0,
    f32: the held-out RMSE within 1e-4 of the CPU float64 run, the
    gathered state on the card, trash rows 0."""
    import dataclasses

    from ycnr_tpu_torch.config import MeshConfig, get_preset
    from ycnr_tpu_torch.data.dataset import load_dataset
    from ycnr_tpu_torch.train.loop import train

    cfg = get_preset("ml100k-als")
    cfg = dataclasses.replace(
        cfg, out_dir=None, mesh=MeshConfig(n_shards=2), ooc=True,
        als=dataclasses.replace(cfg.als, epochs=3, rank=16),
        data=dataclasses.replace(cfg.data, source="synthetic", n_users=600,
                                 n_items=300, n_ratings=20_000))
    ds = load_dataset(cfg.data, rank_hint=16)
    got = train(cfg, ds, device="cuda", backend="gloo")
    f64 = dataclasses.replace(cfg, als=dataclasses.replace(
        cfg.als, dtype="float64"))
    ref = train(f64, ds, device="cpu")
    assert got.state.U.is_cuda
    np.testing.assert_allclose(got.rmse_history, ref.rmse_history, rtol=0,
                               atol=1e-4)
    assert not got.state.U[-1].any() and not got.state.V[-1].any()


def test_bench_process_prints_one_line_on_the_card(dev, tmp_path):
    """python -m ycnr_tpu_torch.tools.bench --smoke --topn with no
    --device: it runs on the card, exactly one stdout line with bench.py's
    keys and vs_baseline null, the diagnostics on stderr."""
    import json
    import os
    import subprocess
    import sys

    env = dict(os.environ, YCNR_BENCH_CACHE=str(tmp_path))
    res = subprocess.run([sys.executable, "-m", "ycnr_tpu_torch.tools.bench",
                          "--smoke", "--topn"], env=env, capture_output=True,
                         text=True, timeout=600)
    assert res.returncode == 0, res.stderr
    lines = res.stdout.strip().splitlines()
    assert len(lines) == 1
    out = json.loads(lines[0])
    assert set(out) == {"metric", "value", "unit", "vs_baseline",
                        "steady_16g_s"}
    assert out["vs_baseline"] is None and out["value"] > 0
    assert "device: cuda" in res.stderr and "rated items served: 0" in \
        res.stderr


def test_wire_probe_times_pinned_copies_to_the_card(dev):
    from ycnr_tpu_torch.tools.bench_ooc import wire_probe

    got = wire_probe(dev)
    assert set(got) == {"u16_deltas", "i8_noise", "f32_noise"}
    # 32 MiB copies from pinned memory: GB/s, far above a pageable copy's
    # first-touch rate
    assert all(v > 1000 for v in got.values()), got


def test_groups_both_frees_the_first_runs_layouts(dev, tmp_path,
                                                  monkeypatch):
    """--groups both: the 16-group run starts with none of the 8-group
    run's device memory held (its layouts are freed first), so the peak
    does not add the two. A first run makes what torch keeps for the
    process (cuBLAS's workspace, 32 MiB) before the two are compared."""
    from ycnr_tpu_torch.tools import bench as tbench

    monkeypatch.setenv("YCNR_BENCH_CACHE", str(tmp_path))
    tbench.main(["--smoke", "--groups", "8"])
    real, seen = tbench.run_bench, []

    def run(*a, **kw):
        torch.cuda.synchronize()
        seen.append(torch.cuda.memory_allocated(dev))
        return real(*a, **kw)

    monkeypatch.setattr(tbench, "run_bench", run)
    tbench.main(["--smoke", "--groups", "both"])
    assert len(seen) == 2 and seen[1] == seen[0], seen
