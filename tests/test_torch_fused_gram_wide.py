"""fused_gram's wide body (128 < w <= 256) on the CPU: its block deal, its
arithmetic mirrored in plain torch (``tests/fused_gram_wide_mirror.py``)
against the plain version and a float64 sum, the wrapper's split at the
wide body's fill, the route that now sends bf16 ALS-WR at ranks 129-256
through it, and the out-of-core memory model's figure for it. The kernel
itself runs on the card (``test_torch_cuda.py``, ``chip_smoke.py``).
"""

import os
import sys

import numpy as np
import pytest
import torch

from ycnr_tpu_torch.models import bucketed_phase as bp
from ycnr_tpu_torch.ops import fused_gram as fg

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import fused_gram_wide_mirror as mirror  # noqa: E402

torch.set_num_threads(1)

WIDTHS = [144, 192, 200, 250, 256]


def _inputs(w, ne=5, R=70, n=60, seed=0):
    """bf16 table with the zero trash row n last, tail-padded slot lists
    (index n, rating 0) and one all-padding entity; the main path's ridge
    lam * cnt + (cnt == 0)."""
    rng = np.random.default_rng(seed)
    base = np.zeros((n + 1, w), np.float32)
    base[:n] = rng.normal(0, 1, (n, w))
    idx = rng.integers(0, n, (ne, R))
    cnt = rng.integers(R // 2, R + 1, ne)
    cnt[-1] = 0
    pad = np.arange(R)[None, :] >= cnt[:, None]
    idx[pad] = n
    rat = np.where(pad, 0.0, rng.uniform(1, 5, (ne, R)))
    table = torch.as_tensor(base).bfloat16()
    c = torch.as_tensor(cnt, dtype=torch.float32)
    return (table, torch.as_tensor(idx), torch.as_tensor(rat).bfloat16(),
            0.05 * c + (c == 0))


ALL_WIDE = range(fg.NARROW_W + 1, fg.MAX_W + 1)


@pytest.mark.parametrize("w", ALL_WIDE)
def test_deal_covers_every_lower_block_once(w):
    """At every wide width the two consumer warpgroups' runs cover every
    lower 64 x 64 block of the padded Gram exactly once (each run adjacent
    blocks of one block row, on or below the diagonal), and their rows of
    b every row block once."""
    T64 = mirror.blocks_a_side(w)
    assert T64 == (3 if w <= 192 else 4)
    held = [blk for g in range(mirror.WARPGROUPS)
            for blk in mirror.warpgroup_blocks(T64, g)]
    assert sorted(held) == [(i, j) for i in range(T64) for j in range(i + 1)]
    for g in range(mirror.WARPGROUPS):
        runs, _ = mirror.DEAL[T64][g]
        assert all(n >= 1 and c0 + n - 1 <= r for r, c0, n in runs)
    rows = [r for g in range(mirror.WARPGROUPS)
            for r in mirror.warpgroup_b_rows(T64, g)]
    assert sorted(rows) == list(range(T64))


@pytest.mark.parametrize("w", ALL_WIDE)
def test_accumulators_a_thread_at_most_168(w):
    """A consumer thread's f32 accumulators (its runs' N / 2 and 4 a row
    of b) stay within 168 at every width, and the two warpgroups' runs are
    of equal width (the products split evenly)."""
    T64 = mirror.blocks_a_side(w)
    counts = [mirror.accumulators(T64, g) for g in range(mirror.WARPGROUPS)]
    assert max(counts) <= 168
    assert counts == ([104, 100] if T64 == 3 else [168, 168])
    widths = [sum(n for _, _, n in mirror.DEAL[T64][g][0])
              for g in range(mirror.WARPGROUPS)]
    assert widths[0] == widths[1]


def test_mirror_deal_is_the_kernels():
    """The mirror's DEAL is the kernel's: the runs and rows of b of every
    ``Deal<T64, G>`` in csrc/fused_gram.cu."""
    import re

    src = open(os.path.join(os.path.dirname(fg.__file__), os.pardir,
                            "csrc", "fused_gram.cu")).read()
    found = {}
    for T64, g, body in re.findall(
            r"struct Deal<(\d), (\d)> \{(.*?)\};", src, re.S):
        v = {k: int(x) for k, x in re.findall(r"(\w+) = (-?\d+)", body)}
        runs = [(v["r0"], v["c0"], v["n0"]), (v["r1"], v["c1"], v["n1"])]
        found[(int(T64), int(g))] = (runs, [v["b0"], v["b1"]][:v["nb"]])
    assert found == {(T64, g): (list(map(tuple, mirror.DEAL[T64][g][0])),
                                mirror.DEAL[T64][g][1])
                     for T64 in (3, 4) for g in range(2)}


@pytest.mark.parametrize("ridge", [True, False])
@pytest.mark.parametrize("w", WIDTHS)
def test_mirror_within_bound_of_plain_and_float64(w, ridge):
    """The wide body's arithmetic is within fused_gram_bound of the plain
    version and within F64_REL of a float64 sum, at w multiple of 16 or
    not, of 8 or not."""
    table, idx, rat, reg = _inputs(w, seed=w)
    reg = reg if ridge else None
    A, b = mirror.fused_gram_wide_mirror(table, idx, rat, reg)
    Ap, bp_ = fg.fused_gram_reference(table, idx, rat, reg)
    bA, bb = fg.fused_gram_bound(table[idx].float(), rat, reg)
    assert A.shape == (idx.shape[0], w, w) and b.shape == (idx.shape[0], w)
    assert torch.all((A - Ap).abs() <= bA)
    assert torch.all((b - bp_).abs() <= bb)
    assert max(fg.fused_gram_f64_error(table, idx, rat, reg, A, b)) <= \
        fg.F64_REL


@pytest.mark.parametrize("w", WIDTHS)
def test_mirror_symmetric_and_padding_exact(w):
    """A is bit-symmetric; the all-padding entity is exactly A = reg I,
    b = 0; equal inputs give equal bits."""
    table, idx, rat, reg = _inputs(w, seed=w + 1)
    A, b = mirror.fused_gram_wide_mirror(table, idx, rat, reg)
    A2, b2 = mirror.fused_gram_wide_mirror(table, idx, rat, reg)
    assert torch.equal(A, A.transpose(1, 2))
    assert torch.equal(A[-1], reg[-1] * torch.eye(w))
    assert torch.all(b[-1] == 0)
    assert torch.equal(A, A2) and torch.equal(b, b2)


def test_mirror_of_a_split_list_sums_its_parts():
    """A list long enough for the wrapper to cut at the wide body's fill:
    the mirror sums the parts in order and adds the ridge after, and stays
    within F64_REL of float64."""
    w, ne, R = 192, 2, 600
    table, idx, rat, reg = _inputs(w, ne=ne, R=R, seed=3)
    assert fg._parts(ne, R, fg.fill_blocks(w))[0] == 2
    A, b = mirror.fused_gram_wide_mirror(table, idx, rat, reg)
    assert max(fg.fused_gram_f64_error(table, idx, rat, reg, A, b)) <= \
        fg.F64_REL
    assert torch.equal(A, A.transpose(1, 2))
    assert torch.equal(A[-1], reg[-1] * torch.eye(w))


def test_a_dropped_block_fails_the_checks(monkeypatch):
    """The deal check is not vacuous: a deal that leaves one block out
    leaves NaN in A."""
    real = mirror.warpgroup_blocks
    monkeypatch.setattr(mirror, "warpgroup_blocks",
                        lambda T64, g: real(T64, g)[1:] if g == 1 else
                        real(T64, g))
    table, idx, rat, reg = _inputs(192, seed=4)
    A, _ = mirror.fused_gram_wide_mirror(table, idx, rat, reg)
    assert torch.isnan(A).any()


@pytest.mark.parametrize("ne,R", [(8, 129_872), (32, 25_352), (3, 1000),
                                  (12_472, 56), (8, 300), (100, 4096),
                                  (1, 257), (264, 5000), (133, 5000)])
def test_parts_at_the_wide_fill_cover_every_list(ne, R):
    """The wide body's fill cuts lists into parts of at least _MIN_PART
    slots that cover the list, reaching its fill and no further than
    needed; the 4-warp body's split is unchanged."""
    s, r_part = fg._parts(ne, R, fg.fill_blocks(192))
    assert (s - 1) * r_part < R <= s * r_part
    assert s == 1 or r_part >= fg._MIN_PART
    assert s == 1 or ne * (s - 1) < fg._FILL_BLOCKS_WIDE
    assert fg.fill_blocks(256) == fg._FILL_BLOCKS_WIDE == 264
    assert fg.fill_blocks(128) == fg.fill_blocks(64) == 396
    assert fg._FILL_BLOCKS == 396
    assert fg._parts(ne, R, fg.fill_blocks(128)) == fg._parts(ne, R)


def test_narrow_split_unchanged():
    """w <= 128 keeps its fill of 396 and its splits."""
    assert fg._parts(12_472, 56) == (1, 56)
    assert fg._parts(8, 129_872) == (50, 2598)
    assert fg._parts(8, 129_872, fg.fill_blocks(256)) == (33, 3936)


@pytest.mark.parametrize("w", [129, 144, 192, 250, 256])
def test_uses_fused_takes_ranks_129_to_256(w):
    assert bp.uses_fused("cuda", torch.float32, None, True, w)
    assert bp.uses_fused(torch.device("cuda", 0), torch.float32, None,
                         True, w)


@pytest.mark.parametrize("alpha,bf16,dtype,w", [
    (None, True, torch.float32, 257),  # past the wide body
    (40.0, True, torch.float32, 192),  # iALS
    (40.0, True, torch.float32, 129),  # iALS past the weighted 4-warp body
    (2.0, True, torch.float32, 192),
    (None, False, torch.float32, 192),  # f32 gathers
    (None, True, torch.float64, 192),  # f64 factors
    (None, True, torch.float32, 512),
])
def test_uses_fused_keeps_the_einsum_route_elsewhere(alpha, bf16, dtype, w):
    assert not bp.uses_fused("cuda", dtype, alpha, bf16, w)


def test_fused_gram_cuda_refuses_cpu_tensors_at_wide_widths():
    table, idx, rat, reg = _inputs(192)
    with pytest.raises(ValueError, match="CUDA"):
        fg.fused_gram_cuda(table, idx, rat, reg)


def test_fused_gram_cuda_refuses_w_257(monkeypatch):
    """Past MAX_W the kernel entry raises before any launch (the device
    check is bypassed so that the width check is what raises here)."""
    table, idx, rat, _ = _inputs(257, ne=2, R=4)
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda t: True))
    with pytest.raises(ValueError, match="w <= 256"):
        fg.fused_gram_cuda(table, idx, rat)


@pytest.mark.parametrize("side", ["user", "item"])
def test_rank192_fused_rows_equal_bucket_solve_rows(side):
    """At rank 192 (the wide body's width) the fused branch's block step,
    on the CPU through the plain versions, equals bucket_solve_rows with
    bf16 gathers bit for bit, block by block, as at w <= 128."""
    from ycnr_tpu_torch.data.synthetic import synthetic_ratings
    from ycnr_tpu_torch.models.base import init_state
    from ycnr_tpu_torch.ops.bucketed import build_bucketed

    k, nu, ni = 192, 60, 40
    u, i, r = synthetic_ratings(nu, ni, 900, true_rank=4, noise=0.3, seed=1)
    st = init_state(nu, ni, k, seed=1, device="cpu")
    if side == "user":
        lay, F = build_bucketed(u, i, r, nu, ni, 32, k, max_groups=3), st.V
    else:
        lay, F = build_bucketed(i, u, r, ni, nu, 32, k, max_groups=3), st.U
    F_g = F.to(torch.bfloat16)
    blocks = 0
    for g, g16 in zip(bp.device_bucketed(lay, torch.float32, "cpu"),
                      bp.device_bucketed(lay, torch.float32, "cpu",
                                         rating_dtype=torch.bfloat16)):
        for j in range(g.other_idx.shape[0]):
            oi, rr, cnt = g.other_idx[j], g.rating[j], g.entity_cnt[j]
            got = bp.bucket_fused_rows(F_g, oi, g16.rating[j], cnt, 0.05)
            want = bp.bucket_solve_rows(F_g, oi, rr, cnt, 0.05, None, None,
                                        torch.float32, True)
            assert got.dtype == torch.float32
            assert torch.equal(got, want)
            blocks += 1
    assert blocks > 0


@pytest.mark.parametrize("k", [192, 256])
def test_ooc_block_working_set_at_the_wide_fill(k):
    """The out-of-core memory model sizes the fused branch's parts of A
    for the body that runs at k: at k 192 / 256 the wide fill's parts."""
    from ycnr_tpu_torch.models import ooc

    class G:  # a wire group's shape: NE entities, R slots, one block
        cnt = np.zeros((1, 8))
        R = 129_872
        n_blocks = 1

    NE, R = 8, G.R
    s = fg._parts(NE, R, fg._FILL_BLOCKS_WIDE)[0]
    assert s == 33 and s < fg._parts(NE, R)[0]
    decode = 48 * NE * R * min(ooc._decode_per(NE, R), 1)
    sp, sr = ooc._split_plan(NE, R, k, 2)
    gathered = (NE // sp) * (R // sr) * k * 2 + 4 * (NE // sp) * k * k * 4
    fused = (s + 2) * NE * k * k * 4
    assert ooc._block_working_set(G, k, 2) == decode + max(gathered, fused)
