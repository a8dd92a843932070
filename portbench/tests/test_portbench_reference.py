"""The plain reference held to the port at small sizes on the CPU (the
tests may import the port; the reference may not)."""

import numpy as np
import pytest
import torch

from portbench.gen import ratings as gen
from portbench.reference import mf
from portbench.reference import topn as ref_topn
from ycnr_tpu_torch.eval.recommend import recommend_all
from ycnr_tpu_torch.models.base import state_from_numpy, zero_cold_entities
from ycnr_tpu_torch.models.bucketed_phase import (als_epoch_fn,
                                                  device_bucketed,
                                                  ials_epoch_fn)
from ycnr_tpu_torch.ops.bucketed import build_bucketed
from ycnr_tpu_torch.ops.layout import build_blocked_csr

NU, NI, K = 300, 260, 16


@pytest.fixture(scope="module")
def data():
    return gen.make_ratings(NU, NI, 9000, 16, 0.3, 0.05, 1.0, 21, "cpu")


def lists(d):
    return (mf.entity_lists(d.train_u, d.train_i, d.train_r, NU, NI),
            mf.entity_lists(d.train_i, d.train_u, d.train_r, NI, NU))


def port_epoch(d, alpha, bf16):
    tu, ti = d.train_u.numpy(), d.train_i.numpy()
    tr = d.train_r.numpy()
    dul = device_bucketed(build_bucketed(tu, ti, tr, NU, NI, 32, K,
                                         max_groups=4), device="cpu")
    dil = device_bucketed(build_bucketed(ti, tu, tr, NI, NU, 32, K,
                                         max_groups=4), device="cpu")
    U0 = gen.start_factors(NU, K, 0.1, 1, "cpu", 1)
    V0 = gen.start_factors(NI, K, 0.1, 1, "cpu", 2)
    st = zero_cold_entities(state_from_numpy(
        U0.numpy(), V0.numpy(), np.zeros(NU + 1), np.zeros(NI + 1), 0.0,
        device="cpu"), tu, ti)
    fn = (als_epoch_fn(dul, dil, 0.05, bf16) if alpha is None
          else ials_epoch_fn(dul, dil, 0.1, alpha, bf16))
    return V0, fn(st)


def test_entity_lists_group_the_coo(data):
    lu, _ = lists(data)
    for e in (0, 7, int(torch.argmax(lu.counts))):
        s, c = int(lu.starts[e]), int(lu.counts[e])
        want = torch.sort(data.train_i[data.train_u == e]).values
        assert torch.equal(torch.sort(lu.other[s:s + c]).values, want)


@pytest.mark.parametrize("alpha", [None, 40.0], ids=["als_wr", "ials"])
@pytest.mark.parametrize("bf16,limit", [(False, 1e-4), (True, 5e-3)],
                         ids=["f32_gathers", "bf16_gathers"])
def test_one_epoch_matches_the_port(data, alpha, bf16, limit):
    V0, st = port_epoch(data, alpha, bf16)
    lu, li = lists(data)
    U, V = mf.epoch(mf.zero_cold(V0, li.counts), lu, li,
                    0.05 if alpha is None else 0.1, alpha,
                    "bfloat16" if bf16 else "float32")
    assert mf.row_gap(st.U, U) < limit
    assert mf.row_gap(st.V, V) < limit
    # only f32 rounding separates the two, far below what fp8 gathers do
    U8, V8 = mf.epoch(mf.zero_cold(V0, li.counts), lu, li,
                      0.05 if alpha is None else 0.1, alpha,
                      "float8_e4m3fn")
    assert mf.row_gap(U8, U) > 3 * limit


def test_rmse_matches_a_loop(data):
    U = torch.randn(NU + 1, K, dtype=torch.float64)
    V = torch.randn(NI + 1, K, dtype=torch.float64)
    u, i, r = data.test_u[:50], data.test_i[:50], data.test_r[:50]
    err = [float(r[j]) - float(U[u[j]] @ V[i[j]]) for j in range(50)]
    assert mf.rmse(U, V, u, i, r) == pytest.approx(
        float(np.sqrt(np.mean(np.square(err)))), rel=1e-12)


def test_row_gap_floors_small_rows():
    R = torch.tensor([[1.0, 0.0], [0.0, 1.0], [1e-9, 0.0], [0.0, 0.0]])
    P = R.clone()
    P[2, 0] += 1e-3
    assert mf.row_gap(P, R) == pytest.approx(1e-3)


def test_round_to_tf32_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2**-10, 1.0 + 2**-11 + 2**-13, -3.0])
    assert mf.round_to(x, "tf32").tolist() == [1.0 + 2**-10,
                                                1.0 + 2**-10, -3.0]


def served(d, method):
    tu, ti = d.train_u.numpy().astype(np.int32), d.train_i.numpy().astype(
        np.int32)
    U = gen.served_factors(d.P, K, 0.02, 3, "cpu", 3)
    V = gen.served_factors(d.Q, K, 0.02, 3, "cpu", 4)
    st = state_from_numpy(U.numpy(), V.numpy(), np.zeros(NU + 1),
                          np.zeros(NI + 1), 0.0, device="cpu")
    lay = build_blocked_csr(tu, ti, d.train_r.numpy(), NU, NI, rank_hint=K)
    users, items, scores = recommend_all(st, lay, 10, method=method)
    items = np.where(scores > -1e29, items, -1)
    return U, V, torch.as_tensor(users).long(), torch.as_tensor(items).long()


def test_exact_lists_pass_and_faults_are_caught(data):
    U, V, users, items = served(data, "exact")
    index = ref_topn.rated_index(data.train_u, data.train_i)
    r = ref_topn.check_lists(U, V, users, items, 10, index)
    assert r["gap"] < 1e-6 and r["lists"] == users.numel()
    assert r["rated"] == r["unknown"] == r["dup"] == r["short"] == 0
    bad = items.clone()
    lu, _ = lists(data)
    u0 = int(users[0])
    s = int(lu.starts[u0])
    bad[0, 0] = lu.other[s]  # a rated item
    bad[1, 1] = bad[1, 0]  # a duplicate
    bad[2, 2] = NI + 5  # no such item
    bad[3, 3] = -1  # a short list
    r = ref_topn.check_lists(U, V, users, bad, 10, index)
    assert (r["rated"], r["dup"], r["unknown"], r["short"]) == (1, 1, 1, 1)
    # a list from another user's scores lies far below the cut
    swap = items.clone()
    swap[0] = items[1]
    assert ref_topn.check_lists(U, V, users, swap, 10, index)["gap"] > 1e-2


def test_reference_lists_judge_themselves_exact(data):
    U, V, users, _ = served(data, "exact")
    index = ref_topn.rated_index(data.train_u, data.train_i)
    own = ref_topn.top_lists(U, V, users, 10, index, "float64")
    assert ref_topn.check_lists(U, V, users, own, 10, index)["gap"] == 0.0
    fp8 = ref_topn.top_lists(U, V, users, 10, index, "float8_e4m3fn")
    assert ref_topn.check_lists(U, V, users, fp8, 10, index)["gap"] > 1e-3
