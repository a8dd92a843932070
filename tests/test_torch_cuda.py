"""The port's kernels on the card against their plain versions: K1, K2,
the row gather (bit equality) and the fused gather -> Gram (its bound).

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
    A = np.einsum("bij,bkj->bik", M, M) / n + 0.5 * np.eye(n)
    A[:3] = np.eye(n)  # padding systems
    b = rng.normal(size=(B, n))
    b[:3] = 0
    return (torch.as_tensor(A, dtype=torch.float32, device=dev),
            torch.as_tensor(b, dtype=torch.float32, device=dev))


@pytest.mark.parametrize("n", [1, 10, 64, 100, 128])
def test_k1_matches_float64_reference(dev, n):
    A, b = _spd(257, n, n, dev)
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


@pytest.mark.parametrize("score_bf16", [True, False])
def test_k2_matches_plain_version_exactly(dev, score_bf16):
    rng = np.random.default_rng(1)
    u_b, k, n_seg = 77, 64, 5
    m = n_seg * ft.SEG_LEN
    rows = torch.as_tensor(rng.normal(size=(u_b, k)), device=dev).bfloat16()
    V = torch.as_tensor(rng.normal(size=(m, k)), device=dev).bfloat16()
    bi = torch.as_tensor(rng.normal(size=m), dtype=torch.float32, device=dev)
    bits = torch.as_tensor(rng.integers(-2**31, 2**31, (u_b, 4 * n_seg)),
                           dtype=torch.int32, device=dev)
    before = ft.launches
    seg, s3 = ft._fused_scores(rows, V, bi, bits, score_bf16)
    seg_p, s3_p = ft.fused_scores_reference(rows, V, bi, bits, score_bf16)
    torch.cuda.synchronize()
    assert ft.launches == before + 1
    assert torch.equal(seg, seg_p) and torch.equal(s3, s3_p)


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
    before = rg.launches
    got = rg.row_gather(table, idx)
    idx2 = idx.reshape(-1, 1).expand(-1, w).contiguous()
    got2 = rg.take_along_rows(table, idx2)
    torch.cuda.synchronize()
    assert rg.launches == before + 2
    assert torch.equal(got, table[idx])
    assert torch.equal(got2, torch.gather(table, 0, idx2.long()))


@pytest.mark.parametrize("w", [10, 64, 128])
@pytest.mark.parametrize("ne,R", [(300, 32), (40, 600), (4, 5000)])
def test_fused_gram_within_bound(dev, w, ne, R):
    rng = np.random.default_rng(R)
    n = 2000
    base = np.zeros((n + 1, w), np.float32)
    base[:n] = rng.normal(size=(n, w))
    idx = rng.integers(0, n, (ne, R))
    idx[:, R // 2:] = n  # padding slots gather the zero row
    idx[-1] = n  # one all-padding entity
    rat = np.where(idx < n, rng.uniform(1, 5, (ne, R)), 0.0)
    table = torch.as_tensor(base, device=dev).bfloat16()
    it = torch.as_tensor(idx, device=dev)
    rt = torch.as_tensor(rat, dtype=torch.float32, device=dev).bfloat16()
    before = fg.launches
    A, b = fg.fused_gram(table, it, rt)
    Ap, bp = fg.fused_gram_reference(table, it, rt)
    torch.cuda.synchronize()
    assert fg.launches == before + 1
    bA, bb = fg.fused_gram_bound(table[it].float(), rt)
    assert torch.all((A - Ap).abs() <= bA)
    assert torch.all((b - bp).abs() <= bb)
    assert torch.equal(A, A.transpose(1, 2))
    assert torch.all(A[-1] == 0) and torch.all(b[-1] == 0)


def test_fused_gram_refuses_what_it_does_not_take(dev):
    table = torch.zeros(10, 8, device=dev)
    idx = torch.zeros(2, 4, dtype=torch.int32, device=dev)
    rat = torch.zeros(2, 4, device=dev).bfloat16()
    with pytest.raises(TypeError):
        fg.fused_gram(table, idx, rat)  # f32 table
    with pytest.raises(ValueError):
        fg.fused_gram(torch.zeros(10, 129, device=dev).bfloat16(), idx, rat)
