"""A rank-256 ALS-WR epoch of the port's plain path on the CPU and the
checks that hold the wide reference (``reference/als_wr_wide.py``) to it
and to ``als_wr.py``; shared by ``test_portbench_wide.py`` and the tier-1
``tests/test_torch_split_path.py`` (the tests may import the port; the
reference may not)."""

import os

import numpy as np

from portbench import harness
from portbench.gen import ratings as gen
from portbench.reference import als_wr, mf
from ycnr_tpu_torch.models.base import state_from_numpy, zero_cold_entities
from ycnr_tpu_torch.models.bucketed_phase import als_epoch_fn, device_bucketed
from ycnr_tpu_torch.ops.bucketed import build_bucketed

NU, NI, K = 300, 260, 256
CONFIG = {"lam": 0.065}
# (bf16 gathers, limit): test_one_epoch_matches_the_port's
GATHERS = [(False, 1e-4), (True, 5e-3)]
GATHER_IDS = ["f32_gathers", "bf16_gathers"]


def wide():
    return harness.load_module(os.path.join(harness.HERE, "reference",
                                            "als_wr_wide.py"))


def make_data():
    return gen.make_ratings(NU, NI, 9000, 16, 0.3, 0.05, 1.0, 21, "cpu")


def lists(d):
    return (mf.entity_lists(d.train_u, d.train_i, d.train_r, NU, NI),
            mf.entity_lists(d.train_i, d.train_u, d.train_r, NI, NU))


def port_epoch(d, bf16):
    """``(V0, state)``: one rank-K ALS-WR epoch of the port's bucketed
    path on the CPU from seeded start factors."""
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
    return V0, als_epoch_fn(dul, dil, CONFIG["lam"], bf16)(st)


def check_one_epoch(d, bf16, limit):
    """The port's epoch within ``limit`` of the wide reference's, and the
    reference with fp8 gathers more than three times that away."""
    V0, st = port_epoch(d, bf16)
    lu, li = lists(d)
    V = mf.zero_cold(V0, li.counts)
    U, V = wide().epoch(V, lu, li, CONFIG,
                        "bfloat16" if bf16 else "float32")
    assert mf.row_gap(st.U, U) < limit
    assert mf.row_gap(st.V, V) < limit
    U8, _ = wide().epoch(mf.zero_cold(V0, li.counts), lu, li, CONFIG,
                         "float8_e4m3fn")
    assert mf.row_gap(U8, U) > 3 * limit


def check_blocks_change_nothing(d, monkeypatch):
    """``als_wr_wide.epoch`` equals ``als_wr.epoch`` in float64 with
    blocks cut far smaller than either's defaults: blocking changes which
    entities are solved together, not their equations."""
    ref = wide()
    monkeypatch.setattr(ref, "MAX_BATCH", 16)
    monkeypatch.setattr(ref, "BUDGET", 512)
    lu, li = lists(d)
    V0 = mf.zero_cold(gen.start_factors(NI, K, 0.1, 1, "cpu", 2), li.counts)
    assert len(list(mf._blocks(lu.counts, ref.BUDGET, ref.MAX_BATCH))) > \
        2 * len(list(mf._blocks(lu.counts, 1 << 22, 1 << 15)))
    U, V = ref.epoch(V0, lu, li, CONFIG, "float64")
    U1, V1 = als_wr.epoch(V0, lu, li, CONFIG, "float64")
    assert mf.row_gap(U, U1) < 1e-10 and mf.row_gap(V, V1) < 1e-10

