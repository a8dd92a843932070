"""Whole runs of each cell on the CPU at a size a test run holds (the
harness's look for a card skipped), sound and with the timed path broken
underneath: a sound run is correct, the control (the plain reference in
the next lower precision, in the program's place) fails the cell's
limits, and each fault the cell can have makes ``correct`` false. The
exchange between chips has no fault here: every cell runs on one card.
"""

import os
import time

import numpy as np
import pytest
import torch

import ycnr_tpu_torch.eval.recommend as recommend
import ycnr_tpu_torch.models.bucketed_phase as bp
import ycnr_tpu_torch.ops.bucketed as bk
import ycnr_tpu_torch.serve.engine as engine
from portbench import harness

SIZES = {"ml20m-als.train": dict(n_users=3000, n_items=1200,
                                 n_ratings=120000),
         "ml20m-ials.train": dict(n_users=3000, n_items=1200,
                                  n_ratings=120000),
         "ml20m-als.topn": dict(n_users=400, n_items=3000, n_ratings=12000),
         # enough users and the whole catalog, so that the control's TF32
         # products move some list past the cut
         "ml20m-als.online": dict(n_users=5000, n_items=26744,
                                  n_ratings=100000)}
SECONDS = {"ml20m-als.online": 2.0}


@pytest.fixture(params=["cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
def device(request):
    """The CPU, and the card where there is one: the card runs the
    port's kernels (fused_gram, K1, K2) under the same checks."""
    if request.param == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return request.param


# the online cell is kept on file for a later benchmark PR (PERF.md, open
# questions); its runs here name it as BENCHMARK.json would
ONLINE = {"name": "ml20m-als.online", "config": "ml20m-als",
          "traffic": "poisson-by-degree", "chips": 1}


def bench():
    b = harness.load_json(os.path.join(harness.ROOT, "BENCHMARK.json"))
    if ONLINE["name"] not in {w["name"] for w in b["workloads"]}:
        b["workloads"].append(ONLINE)
    return b


def spec(cell):
    s = harness.cell_spec(cell, bench())
    s.config.update(SIZES[cell])
    if cell.endswith(".online"):
        s.cell["rate_per_s"] = 1000
    return s


def run(cell, device, seed=7):
    return harness.run_cell(spec(cell), seed, SECONDS.get(cell, 0.3), False,
                            device, time.perf_counter())


def limits_failed(cell, readings):
    return [n for n, v, lim, ok in harness.compare(
        readings, spec(cell).cell["limits"]) if not ok]


@pytest.mark.parametrize("cell", sorted(SIZES))
def test_sound_run_is_correct(cell, device):
    out = run(cell, device)
    assert out["correct"], out["compared"]
    assert out["attempted"] > 0 and out["failed"] == 0


@pytest.mark.parametrize("cell", sorted(SIZES))
def test_control_fails_the_limits(cell, device):
    s = spec(cell)
    r = s.kind.Run(s, 11, device, harness.Phases(time.perf_counter()), False)
    r.setup()
    r.window(SECONDS.get(cell, 0.3))
    r.release()
    assert limits_failed(cell, r.control_readings())


def unchanged(*a, **k):
    return lambda st: st


def altered(make):
    def build(*a, **k):
        fn = make(*a, **k)

        def one(st):
            st = fn(st)
            st.U[3] = st.U[4]  # one user's answer taken from another
            return st
        return one
    return build


def half(build):
    def build_half(e, o, r, *a, **k):
        keep = np.arange(len(r)) % 2 == 0
        return build(np.asarray(e)[keep], np.asarray(o)[keep],
                     np.asarray(r)[keep], *a, **k)
    return build_half


@pytest.mark.parametrize("cell,fn", [("ml20m-als.train", "als_epoch_fn"),
                                     ("ml20m-ials.train", "ials_epoch_fn")])
@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "altered"])
def test_training_faults_are_not_correct(monkeypatch, cell, fn, fault,
                                        device):
    if fault == "unchanged":
        monkeypatch.setattr(bp, fn, unchanged)
    elif fault == "altered":
        monkeypatch.setattr(bp, fn, altered(getattr(bp, fn)))
    else:
        monkeypatch.setattr(bk, "build_bucketed", half(bk.build_bucketed))
    assert not run(cell, device)["correct"]


def test_topn_answer_altered_is_not_correct(monkeypatch, device):
    real = recommend.recommend_all

    def wrong(*a, **k):
        users, items, scores = real(*a, **k)
        items = items.copy()
        items[5] = np.roll(items[5], 1)
        items[5, 0] = (items[5, 0] + 1) % 3000
        return users, items, scores
    monkeypatch.setattr(recommend, "recommend_all", wrong)
    assert not run("ml20m-als.topn", device)["correct"]


def test_topn_half_the_users_left_out_is_not_correct(monkeypatch, device):
    real = recommend.recommend_all

    def halved(*a, **k):
        users, items, scores = real(*a, **k)
        return users[::2], items[::2], scores[::2]
    monkeypatch.setattr(recommend, "recommend_all", halved)
    assert not run("ml20m-als.topn", device)["correct"]


def test_online_answer_altered_is_not_correct(monkeypatch, device):
    real = engine.Recommender.recommend_batch

    def wrong(self, user_ids, n=10):
        out = real(self, user_ids, n)
        return [np.concatenate([r[1:], r[:1] * 0 + (r[0] + 7) % 26744])
                for r in out]
    monkeypatch.setattr(engine.Recommender, "recommend_batch", wrong)
    assert not run("ml20m-als.online", device)["correct"]


def test_online_half_the_requests_unanswered_is_not_correct(monkeypatch,
                                                            device):
    real = engine.Recommender.recommend_batch

    def half_fail(self, user_ids, n=10):
        if int(user_ids[0]) % 2:
            raise ValueError("dropped")
        return real(self, user_ids, n)
    monkeypatch.setattr(engine.Recommender, "recommend_batch", half_fail)
    out = run("ml20m-als.online", device)
    assert not out["correct"] and out["failed"] > 0


def test_training_fault_readings_exceed_the_limits(device):
    s = spec("ml20m-als.train")
    r = s.kind.Run(s, 13, device, harness.Phases(time.perf_counter()), False)
    r.setup()
    r.window(0.2)
    r.release()
    for name, readings in r.fault_readings().items():
        assert limits_failed("ml20m-als.train", readings), name
    assert torch.is_tensor(r.final[0])
