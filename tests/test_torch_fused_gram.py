"""The port's fused gather -> Gram (``ops/fused_gram.py``) against the JAX
package: T4 (``tools/probe_gather.py:pallas_fused_gram``) in Pallas
interpret mode, and ``ycnr_tpu.models.bucketed_phase.bucket_normal_eq``
with bf16 gathers, the function the bucketed ALS epoch runs; at w 64
(the 4-warp body's width) and at w 192 and 256 (the wide body's).

The two sides sum the same exact bf16 x bf16 products in f32 in other
orders, so each entry is held to |A - A_jax| <= 2 R 2^-24 (|F|^T |F|) and
|b - b_jax| <= 2 R 2^-24 (|F|^T |rat|).
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from ycnr_tpu.models import bucketed_phase as jbp
from ycnr_tpu_torch.ops import fused_gram as fg

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _inputs(n, w, ne, R, seed, pad_frac=0.25):
    """bf16 table with a zero trash row n, slots padded at the tail of each
    entity (index n, rating 0), one all-padding entity."""
    rng = np.random.default_rng(seed)
    base = np.zeros((n + 1, w), np.float32)
    base[:n] = rng.normal(0, 1, (n, w))
    idx = rng.integers(0, n, (ne, R)).astype(np.int32)
    rat = rng.uniform(1, 5, (ne, R)).astype(np.float32)
    cnt = rng.integers(int(R * (1 - pad_frac)), R + 1, ne)
    cnt[-1] = 0
    pad = np.arange(R)[None, :] >= cnt[:, None]
    idx[pad] = n
    rat[pad] = 0
    return base, idx, rat


def _bounds(base, idx, rat):
    """2 R 2^-24 (|F|^T |F|) and 2 R 2^-24 (|F|^T |rat|) in float64, on the
    bf16-rounded inputs."""
    F = np.abs(torch.as_tensor(base).bfloat16().double().numpy()[idx])
    r = np.abs(torch.as_tensor(rat).bfloat16().double().numpy())
    c = 2 * idx.shape[1] * 2.0 ** -24
    return (c * np.einsum("urk,urm->ukm", F, F),
            c * np.einsum("urk,ur->uk", F, r))


def _port(base, idx, rat):
    return fg.fused_gram(torch.as_tensor(base).bfloat16(),
                         torch.as_tensor(idx),
                         torch.as_tensor(rat).bfloat16())


def _widths(cases):
    """Each case at w 64 (its id as before) and at the wide body's w 192
    and 256."""
    return [pytest.param(*c, w, id="-".join(map(str, c))
                         + ("" if w == 64 else f"-w{w}"))
            for w in (64, 192, 256) for c in cases]


@pytest.mark.parametrize("R,ne,w", _widths([(32, 64), (200, 12),
                                            (1000, 3)]))
def test_fused_gram_matches_bucket_normal_eq(R, ne, w):
    base, idx, rat = _inputs(500, w, ne, R, seed=R)
    A, b = _port(base, idx, rat)
    Fg = jnp.asarray(base, jnp.bfloat16)[jnp.asarray(idx)]
    Aj, bj = jbp.bucket_normal_eq(Fg, jnp.asarray(rat), None, jnp.float32,
                                  True)
    bA, bb = _bounds(base, idx, rat)
    assert A.dtype == b.dtype == torch.float32
    assert np.all(np.abs(A.double().numpy() - np.asarray(Aj, np.float64))
                  <= bA)
    assert np.all(np.abs(b.double().numpy() - np.asarray(bj, np.float64))
                  <= bb)
    # the all-padding entity gathers only the zero row: exactly 0
    assert torch.all(A[-1] == 0) and torch.all(b[-1] == 0)


@pytest.mark.parametrize("idx_dtype,w", [
    pytest.param(dt, w, id=dt.__name__ + ("" if w == 64 else f"-w{w}"))
    for w in (64, 192, 256) for dt in (np.int32, np.int64)])
def test_fused_gram_matches_t4(idx_dtype, w):
    probe_path = os.path.join(REPO, "tools", "probe_gather.py")
    spec = importlib.util.spec_from_file_location("tpu_probe_gather",
                                                  probe_path)
    probe = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(probe)
    R, ne, n = 32, 32, 300
    base, idx, rat = _inputs(n, w, ne, R, seed=7)
    with pltpu.force_tpu_interpret_mode():
        s = probe.pallas_fused_gram(
            jnp.asarray(base, jnp.bfloat16), jnp.asarray(idx.reshape(-1)),
            jnp.asarray(rat.reshape(-1), jnp.bfloat16), R=R, tile_ne=8)()
    A, b = _port(base, idx.astype(idx_dtype), rat)
    # the port's sum in the probe's own f32 reduction
    sp = jax.jit(lambda A, b: jnp.sum(A) + jnp.sum(b))(
        jnp.asarray(A.numpy()), jnp.asarray(b.numpy()))
    x = np.concatenate([A.double().numpy().ravel(),
                        b.double().numpy().ravel()])
    bA, bb = _bounds(base, idx, rat)
    # the entries' own bound, plus each side's rounding of a pairwise f32
    # sum of N terms, ceil(log2 N) 2^-24 sum|x|
    tol = (bA.sum() + bb.sum()
           + 2 * np.ceil(np.log2(x.size)) * 2.0 ** -24 * np.abs(x).sum())
    # tight enough to see b: a kernel that dropped it would fail
    assert tol < abs(b.double().sum().item())
    assert abs(float(s) - float(sp)) <= tol


def test_fused_gram_split_arithmetic():
    """A call with few entities cuts long rating lists into parts of at
    least _MIN_PART slots (the last may be shorter) that cover the list;
    it never splits where that is impossible or not needed."""
    for ne, R in [(8, 129_872), (32, 25_352), (3, 1000), (12_472, 56),
                  (8, 300), (100, 4096), (4, 5000), (1, 257)]:
        s, r_part = fg._parts(ne, R)
        assert (s - 1) * r_part < R <= s * r_part
        assert s == 1 or r_part >= fg._MIN_PART
        assert s == 1 or ne * (s - 1) < fg._FILL_BLOCKS
    assert fg._parts(12_472, 56) == (1, 56)
    assert fg._parts(8, 129_872)[0] * 8 >= fg._FILL_BLOCKS


def test_fused_gram_cuda_refuses_cpu_tensors():
    """No fallback: the kernel entry raises for a CPU tensor."""
    base, idx, rat = _inputs(20, 8, 2, 4, seed=0)
    with pytest.raises(ValueError):
        fg.fused_gram_cuda(torch.as_tensor(base).bfloat16(),
                           torch.as_tensor(idx),
                           torch.as_tensor(rat).bfloat16())


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_fused_gram_reference_ridge_is_the_guarded_solves_A(monkeypatch,
                                                            dtype):
    """With reg, the plain version's A is bit for bit the A that
    guarded_batched_solve hands to the solve (ridge, then symmetrize)."""
    from ycnr_tpu_torch.ops import gram

    base, idx, rat = _inputs(300, 16, 24, 40, seed=3)
    table = torch.as_tensor(base).to(dtype)
    rt = torch.as_tensor(rat).to(dtype)
    it = torch.as_tensor(idx)
    cnt = (it < 300).sum(1).to(dtype)
    reg = 0.05 * cnt + (cnt == 0)
    A, b = fg.fused_gram_reference(table, it, rt, reg=reg)
    seen = {}
    monkeypatch.setattr(gram, "spd_solve",
                        lambda A_, b_: seen.setdefault("A", A_))
    A0, b0 = fg.fused_gram_reference(table, it, rt)
    gram.guarded_batched_solve(A0, b0, reg)
    assert A.dtype == dtype and torch.equal(A, seen["A"])
    assert torch.equal(b, b0)
    assert torch.equal(A[-1], torch.eye(16, dtype=dtype))  # padding entity


@pytest.mark.parametrize("drop", [False, True])
def test_f64_check_catches_a_lost_part(drop):
    """fused_gram_f64_error passes a float64 sum rounded to f32 on a long
    list that the wrapper would split, and fails the same sum with one
    part's slots left out."""
    table, idx, rat = _inputs(300, 16, 4, 6000, 9, pad_frac=0.1)
    table = torch.as_tensor(table).bfloat16()
    it, rt = torch.as_tensor(idx), torch.as_tensor(rat).bfloat16()
    cnt = (it < 300).sum(1).float()
    reg = 0.05 * cnt + (cnt == 0)
    s, r_part = fg._parts(4, 6000)
    assert s > 1
    kept = it.clone()
    if drop:
        kept[:, r_part:2 * r_part] = 300  # the zero trash row
    A, b = fg.fused_gram_reference(table.double(), kept, rt.double(),
                                   reg.double())
    eA, eb = fg.fused_gram_f64_error(table, it, rt, reg, A.float(),
                                     b.float())
    assert (max(eA, eb) > fg.F64_REL) is drop


def _bf16_rne(x32: np.ndarray) -> np.ndarray:
    """float32 -> bf16 (as float32) rounding to nearest even, by bits: the
    rounding of the kernel's cvt.rn.bf16.f32."""
    u = x32.astype(np.float32).view(np.uint32).astype(np.uint64)
    u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    return u.astype(np.uint32).view(np.float32)


@pytest.mark.parametrize("alpha", [40.0, 0.3, 7.7])
def test_weights_round_as_the_kernel_does(alpha):
    """wt = bf16(f32(alpha) * r) and c = bf16(1 + wt), each rounded once to
    nearest even from f32: what torch's bf16 arithmetic with a float gives
    (the einsum route) and what the weighted kernel computes."""
    r = np.concatenate([np.arange(0, 5.5, 0.5),
                        np.random.default_rng(0).uniform(0, 5, 500)])
    r16 = torch.as_tensor(r, dtype=torch.float32).bfloat16()
    wt, c = fg.weights(r16, alpha, torch.bfloat16)
    assert wt.dtype == c.dtype == torch.bfloat16
    rf = r16.float().numpy()
    want_wt = _bf16_rne(np.float32(alpha) * rf)
    want_c = _bf16_rne(np.float32(1.0) + want_wt)
    np.testing.assert_array_equal(wt.float().numpy(), want_wt)
    np.testing.assert_array_equal(c.float().numpy(), want_c)


def test_weighted_products_split_exactly_into_two_bf16():
    """The weighted kernel's split: p = wt F (two bf16 values) is exact in
    f32; hi = p with its low 16 bits cleared and lo = p - hi are both bf16
    values, and hi F_j + lo F_j = wt F_i F_j exactly (float64)."""
    rng = np.random.default_rng(1)
    F = torch.as_tensor(rng.normal(0, 0.3, 4096),
                        dtype=torch.float32).bfloat16().float()
    Fj = torch.as_tensor(rng.normal(0, 0.3, 4096),
                         dtype=torch.float32).bfloat16().float()
    wt, _ = fg.weights(torch.as_tensor(rng.uniform(0, 5, 4096),
                                       dtype=torch.float32).bfloat16(),
                       40.0, torch.bfloat16)
    p = F * wt.float()
    assert torch.equal(p.double(), F.double() * wt.double())
    hi = (p.view(torch.int32) & -65536).view(torch.float32)
    lo = p - hi
    assert torch.equal(hi.bfloat16().float(), hi)
    assert torch.equal(lo.bfloat16().float(), lo)
    assert torch.equal(hi.double() + lo.double(), p.double())
    assert torch.equal(hi.double() * Fj.double() + lo.double() * Fj.double(),
                       p.double() * Fj.double())


@pytest.mark.parametrize("R,ne,w", [(32, 64, 64), (200, 12, 64),
                                    (1000, 3, 128), (50, 20, 10)])
def test_weighted_plain_version_against_float64(R, ne, w):
    """fused_gram(..., alpha=, base=) on the CPU: within the f32 sum's own
    error of a float64 sum of the same products (the weights rounded as
    the kernel rounds them), A symmetric, and the all-padding entity
    exactly base + lam I with b = 0; within fused_gram_bound of the f64
    sum too."""
    base, idx, rat = _inputs(500, w, ne, R, seed=R + w)
    rng = np.random.default_rng(w)
    table = torch.as_tensor(base).bfloat16()
    it, rt = torch.as_tensor(idx), torch.as_tensor(rat).bfloat16()
    M = torch.as_tensor(rng.normal(0, 1, (w, w)), dtype=torch.float32)
    G = 0.5 * (M @ M.T + (M @ M.T).T)
    lam, alpha = 0.1, 40.0
    A, b = fg.fused_gram(table, it, rt, lam, alpha=alpha, base=G)
    assert A.dtype == b.dtype == torch.float32
    assert torch.equal(A, A.transpose(1, 2))
    eye = torch.eye(w)
    assert torch.equal(A[-1], G + lam * eye) and torch.all(b[-1] == 0)
    eA, eb = fg.fused_gram_f64_error(table, it, rt, lam, A, b, alpha=alpha,
                                     base=G)
    assert eA <= (R + 4) * 2.0 ** -24 and eb <= (R + 4) * 2.0 ** -24
    # the bound between kernel and plain version also covers plain - f64
    F = table[it].double()
    wt, c = fg.weights(rt, alpha, torch.bfloat16)
    A64 = (torch.einsum("urk,urm->ukm", F * wt.double()[..., None], F)
           + G.double() + lam * eye.double())
    b64 = torch.einsum("urk,ur->uk", F, c.double())
    bA, bb = fg.fused_gram_bound(F, rt, lam, alpha=alpha, base=G)
    assert torch.all((A.double() - A64).abs() <= bA)
    assert torch.all((b.double() - b64).abs() <= bb)
    # without base and ridge: bucket_normal_eq's weighted partials
    A0, b0 = fg.fused_gram(table, it, rt, alpha=alpha)
    Fg = jnp.asarray(base, jnp.bfloat16)[jnp.asarray(idx)]
    Aj, bj = jbp.bucket_normal_eq(Fg, jnp.asarray(rat), alpha, jnp.float32,
                                  True)
    sA = torch.einsum("urk,urm->ukm", F.abs() * wt.double()[..., None],
                      F.abs())
    tol = 2 * R * 2.0 ** -24
    assert torch.all((A0.double() - torch.as_tensor(
        np.asarray(Aj, np.float64))).abs() <= tol * sA)
    assert torch.all((b0.double() - torch.as_tensor(
        np.asarray(bj, np.float64))).abs()
        <= tol * torch.einsum("urk,ur->uk", F.abs(), c.double()))


def test_weighted_mode_refusals_on_the_cuda_entry(monkeypatch):
    """The weighted mode takes w <= NARROW_W and one float ridge; a base
    Gram or a float ridge only in it (checked before any launch)."""
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda t: True))
    for w, kw, err in [(129, dict(alpha=2.0), "w <= 128"),
                       (16, dict(alpha=2.0, reg=torch.ones(2)), "one float"),
                       (16, dict(base=torch.zeros(16, 16)), "weighted"),
                       (16, dict(reg=0.1), "weighted")]:
        base, idx, rat = _inputs(20, w, 2, 4, seed=0)
        with pytest.raises((ValueError, TypeError), match=err):
            fg.fused_gram_cuda(torch.as_tensor(base).bfloat16(),
                               torch.as_tensor(idx),
                               torch.as_tensor(rat).bfloat16(), **kw)

