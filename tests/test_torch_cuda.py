"""The port's kernels on the card against their plain versions: K1 (a
float64 solve), K2 (its bound, a float64 sum and its exact invariants),
the row gather and take-along gather (bit equality) and the fused
gather -> Gram with and without the ridge (its bound, and a float64 sum).

Needs a CUDA device: every test skips without one. On a GPU machine, which
has no JAX, run them without the suite's JAX conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_cuda.py
"""

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
    with pytest.raises(TypeError):
        sp.spd_solve(A.double(), b.double())
    A, b = _spd(2, 129, 0, dev)
    with pytest.raises(ValueError):
        sp.spd_solve(A, b)


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
@pytest.mark.parametrize("w", [10, 64, 128])
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
    assert bp.uses_fused(dev, torch.float32, None, True)
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
        fg.fused_gram(torch.zeros(10, 129, device=dev).bfloat16(), idx, rat)
