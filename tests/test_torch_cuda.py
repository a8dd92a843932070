"""K1 and K2 on the card against their plain versions.

Needs a CUDA device: every test skips without one. On a GPU machine, which
has no JAX, run them without the suite's JAX conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from ycnr_tpu_torch.ops import fused_topn as ft
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
