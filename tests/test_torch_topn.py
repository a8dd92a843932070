"""Port's top-n serving (exact scorer, K2's plain version and the fused
select) vs ycnr_tpu.eval.recommend and ycnr_tpu.ops.pallas_topn (Pallas
interpreter), on the same NumPy factors and layouts."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ycnr_tpu.eval import recommend as jrec
from ycnr_tpu.models.base import MFState as JState
from ycnr_tpu.models.base import device_layout
from ycnr_tpu.ops.layout import build_blocked_csr
from ycnr_tpu.ops.pallas_topn import fused_topn_blocks as j_fused
from ycnr_tpu_torch.eval import recommend as trec
from ycnr_tpu_torch.models.base import device_layout as t_device_layout
from ycnr_tpu_torch.models.base import state_from_numpy
from ycnr_tpu_torch.ops import fused_topn as tft

torch.set_num_threads(1)


def _problem(seed=0, n_users=300, n_items=2000, nnz=6000, k=8, ints=True,
             dtype=np.float32):
    """Factors/biases are small integers when ``ints``: every score is then
    exact in bf16 and f32, so all paths return the same value sequences."""
    rng = np.random.default_rng(seed)
    u = rng.integers(0, n_users, nnz)
    i = rng.integers(0, n_items, nnz)
    pairs = np.unique(np.stack([u, i], 1), axis=0)
    u, i = pairs[:, 0], pairs[:, 1]
    r = rng.integers(1, 6, len(u)).astype(np.float32)
    lay = build_blocked_csr(u, i, r, n_users, n_items, 8)
    draw = ((lambda s: rng.integers(-2, 3, s)) if ints
            else (lambda s: rng.normal(0, 1, s)))
    U, V = draw((n_users + 1, k)), draw((n_items + 1, k))
    bu, bi = draw(n_users + 1), draw(n_items + 1)
    U[-1] = V[-1] = 0
    bu[-1] = bi[-1] = 0
    arrs = [x.astype(dtype) for x in (U, V, bu, bi)] + [dtype(1.0)]
    js = JState(*[jnp.asarray(x) for x in arrs])
    ts = state_from_numpy(*arrs, dtype=torch.from_numpy(arrs[0]).dtype,
                          device="cpu")
    return js, ts, lay, (u, i)


def _per_user(vals):
    return np.asarray(vals).reshape(-1, vals.shape[-1])


def test_build_rated_bits_bitwise():
    _, _, lay, _ = _problem()
    np.testing.assert_array_equal(trec.build_rated_bits(lay, 2000),
                                  jrec.build_rated_bits(lay, 2000))


def _assert_same_up_to_ties(ids_a, vals_a, ids_b, vals_b, atol):
    """Same value sequences; id sets equal except at the n-th value."""
    np.testing.assert_allclose(vals_a, vals_b, rtol=0, atol=atol)
    for ia, ib, va in zip(ids_a, ids_b, vals_a):
        for x in set(ia.tolist()) ^ set(ib.tolist()):
            where = np.flatnonzero(ia == x)
            v = va[where[0]] if len(where) else None
            assert v is None or abs(v - va[-1]) <= atol
        live = va > jrec.NEG_INF / 2
        assert len(set(ia[live].tolist())) == live.sum()  # no duplicates


@pytest.mark.parametrize("bits", [True, False])
def test_exact_scorer_matches_jax_f64(bits):
    js, ts, lay, _ = _problem(ints=False, dtype=np.float64)
    n = 10
    jb = jnp.asarray(jrec.build_rated_bits(lay, 2000)) if bits else None
    tb = trec.bits_tensor(trec.build_rated_bits(lay, 2000), "cpu") \
        if bits else None
    ij, vj = jrec._topn_blocks(js, device_layout(lay, jnp.float64), n, jb)
    it, vt = trec._topn_blocks(ts, t_device_layout(lay, device="cpu"), n, tb)
    _assert_same_up_to_ties(_per_user(it.numpy()), _per_user(vt.numpy()),
                            _per_user(ij), _per_user(vj), atol=1e-9)


def test_recommend_users_matches_jax_f64():
    js, ts, _, (u, i) = _problem(seed=1, ints=False, dtype=np.float64)
    users = [0, 5, 17, 299]
    ij, vj = jrec.recommend_users(js, u, i, users, 10)
    it, vt = trec.recommend_users(ts, u, i, users, 10)
    _assert_same_up_to_ties(it, vt, ij, vj, atol=1e-9)


@pytest.mark.parametrize("score_bf16", [True, False])
def test_fused_matches_pallas_interpret_and_exact(score_bf16):
    js, ts, lay, _ = _problem(seed=2)
    n = 10
    bits = jrec.build_rated_bits(lay, 2000)
    ij, vj = j_fused(js, jnp.asarray(lay.entity_ids), jnp.asarray(bits), n,
                     tu=8, score_bf16=score_bf16, interpret=True)
    it, vt = tft.fused_topn_blocks(ts, torch.as_tensor(lay.entity_ids),
                                   trec.bits_tensor(bits, "cpu"), n,
                                   score_bf16=score_bf16)
    assert it.dtype == torch.int32 and it.shape == (*lay.entity_ids.shape, n)
    real = (lay.entity_ids < 300).reshape(-1)
    got_i, got_v = _per_user(it.numpy())[real], _per_user(vt.numpy())[real]
    _assert_same_up_to_ties(got_i, got_v, _per_user(ij)[real],
                            _per_user(vj)[real], atol=0)
    # and == the exact scorer (integer scores: exact in bf16)
    ie, ve = trec._topn_blocks(ts, t_device_layout(lay, device="cpu"), n,
                               trec.bits_tensor(bits, "cpu"))
    _assert_same_up_to_ties(got_i, got_v, _per_user(ie.numpy())[real],
                            _per_user(ve.numpy())[real], atol=0)


def test_fused32_equals_exact_through_recommend_all():
    _, ts, lay, (u, i) = _problem(seed=3)
    ue, ie, ve = trec.recommend_all(ts, lay, 10, method="exact")
    uf, if_, vf = trec.recommend_all(ts, lay, 10, method="fused32")
    np.testing.assert_array_equal(ue, uf)
    _assert_same_up_to_ties(if_, vf, ie, ve, atol=0)
    rated = set(zip(u.tolist(), i.tolist()))
    assert not any((int(a), int(b)) in rated
                   for a, row in zip(uf, if_) for b in row)


def test_neg_inf_tail_for_users_with_few_unrated_items():
    """User 0 rated all but item 297 of 300; with n = 2 every path returns
    one real pick and one NEG_INF-scored tail entry, whose id lies within
    the padded score width (the contract of pallas_topn.py:209-215)."""
    n_items, n = 300, 2
    rng = np.random.default_rng(4)
    keep = np.arange(n_items) != 297
    u = np.concatenate([np.zeros(n_items - 1, int), rng.integers(1, 20, 200)])
    i = np.concatenate([np.arange(n_items)[keep],
                        rng.integers(0, n_items, 200)])
    pairs = np.unique(np.stack([u, i], 1), axis=0)
    u, i = pairs[:, 0], pairs[:, 1]
    lay = build_blocked_csr(u, i, np.ones(len(u)), 20, n_items, 8)
    U = rng.normal(size=(21, 4)).astype(np.float32)
    V = rng.normal(size=(n_items + 1, 4)).astype(np.float32)
    U[-1] = V[-1] = 0
    z = np.zeros
    ts = state_from_numpy(U, V, z(21), z(n_items + 1), 0.0, device="cpu")
    js = JState(jnp.asarray(U), jnp.asarray(V), jnp.zeros(21, jnp.float32),
                jnp.zeros(n_items + 1, jnp.float32), jnp.float32(0.0))
    bits = trec.build_rated_bits(lay, n_items)
    assert tft.fused_supported(n_items, n)
    ij, vj = j_fused(js, jnp.asarray(lay.entity_ids), jnp.asarray(bits), n,
                     tu=8, score_bf16=False, interpret=True)
    j0 = np.asarray(ij).reshape(-1, n)[lay.entity_ids.reshape(-1) == 0][0]
    assert j0[0] == 297
    for method in ("exact", "fused", "fused32"):
        users, ids, vals = trec.recommend_all(ts, lay, n, method=method)
        row, v = ids[users == 0][0], vals[users == 0][0]
        live = v > trec.NEG_INF / 2
        assert row[live].tolist() == [297] and (~live).sum() == 1
        assert 0 <= row[~live][0] < bits.shape[-1] * 32


def test_fused_plain_version_masks_pad_and_trash_columns():
    _, ts, lay, _ = _problem(seed=5, n_items=300)
    bits = trec.build_rated_bits(lay, 300)
    m = bits.shape[-1] * 32
    vp = torch.zeros(m, 8, dtype=torch.bfloat16)
    vp[:301] = ts.V.bfloat16()
    seg, s3 = tft.fused_scores_reference(
        ts.U[:16].bfloat16(), vp, torch.zeros(m),
        trec.bits_tensor(bits, "cpu")[0, :16], score_bf16=False)
    assert torch.all(s3.reshape(16, -1)[:, 300:] == tft.NEG_INF)
    assert torch.equal(seg, s3.amax(2))


def test_fused_gives_way_to_exact_only_on_the_cpu():
    """A catalog too small for the two-level select: the exact scorer on
    CPU factors (as the JAX package), an error where the factors are on
    the card; a large enough catalog goes through K2's path on either."""
    assert not tft.fused_supported(120, 10)
    assert trec.use_fused("fused", 120, 10, torch.device("cpu")) is False
    for method in ("fused", "fused32"):
        with pytest.raises(ValueError, match="too few"):
            trec.use_fused(method, 120, 10, torch.device("cuda", 0))
        assert trec.use_fused(method, 1400, 10, "cuda")
        assert trec.use_fused(method, 1400, 10, "cpu")
    assert trec.use_fused("exact", 1400, 10, "cuda") is False
    # through recommend_all on the CPU: exact's answer, bit for bit
    _, ts, lay, _ = _problem(seed=6, n_items=120)
    for a, b in zip(trec.recommend_all(ts, lay, 20, method="fused"),
                    trec.recommend_all(ts, lay, 20, method="exact")):
        np.testing.assert_array_equal(a, b)
