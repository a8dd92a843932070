"""The port's tracing / profiling hooks (``ycnr_tpu_torch/utils``) on the
CPU: the span recorder (nesting, ids, off, cap, drain, threads), the spans
of a bucketed epoch and of a serving pass, their clock against
``torch.profiler``'s, the Chrome trace, and the checksum held to the JAX
package's ``device_sync`` on the same arrays."""

import json
import os
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ycnr_tpu.utils import profiling as jprof
from ycnr_tpu_torch.data.synthetic import synthetic_ratings
from ycnr_tpu_torch.eval import recommend as trec
from ycnr_tpu_torch.models import base as tbase
from ycnr_tpu_torch.models import bucketed_phase as tbp
from ycnr_tpu_torch.ops.bucketed import build_bucketed
from ycnr_tpu_torch.ops.layout import build_blocked_csr
from ycnr_tpu_torch.utils import profiling as prof
from ycnr_tpu_torch.utils.profiling import (SpanRecorder, device_sync,
                                            trace)

torch.set_num_threads(1)


@pytest.fixture
def spans_on():
    """The program's recorder switched on for one test, and left off and
    empty after it."""
    prof.drain()
    prof.enable()
    try:
        yield prof.RECORDER
    finally:
        prof.disable()
        prof.drain()


def test_spans_nest_with_parent_and_root_ids():
    rec = SpanRecorder()
    rec.enable()
    with rec.span("epoch") as a:
        with rec.span("phase.user"):
            with rec.span("solve"):
                pass
        with rec.span("phase.item"):
            pass
    with rec.span("epoch"):
        pass
    got = rec.drain()
    assert got.dropped == 0
    assert [s.name for s in got.spans] == [
        "solve", "phase.user", "phase.item", "epoch", "epoch"]
    by = {s.name: s for s in got.spans[:4]}
    ep = by["epoch"]
    assert ep.parent is None and ep.root == ep.id and a is not None
    assert by["phase.user"].parent == ep.id
    assert by["phase.item"].parent == ep.id
    assert by["solve"].parent == by["phase.user"].id
    assert {s.root for s in got.spans[:4]} == {ep.id}
    second = got.spans[4]
    assert second.parent is None and second.root == second.id != ep.id
    assert len({s.id for s in got.spans}) == 5
    for s in got.spans:
        assert s.start_ns <= s.end_ns
    assert ep.start_ns <= by["solve"].start_ns <= by["solve"].end_ns \
        <= ep.end_ns


def test_each_thread_records_its_own_tree():
    rec = SpanRecorder()
    rec.enable()
    start = threading.Barrier(3)

    idents = {"main": prof.thread_id()}

    def work(tag):
        idents["pass." + tag] = prof.thread_id()
        start.wait(timeout=10)
        for _ in range(50):
            with rec.span("pass." + tag):
                with rec.span("select." + tag):
                    pass

    threads = [threading.Thread(target=work, args=(t,)) for t in "ab"]
    for t in threads:
        t.start()
    start.wait(timeout=10)
    with rec.span("main"):
        pass
    for t in threads:
        t.join(timeout=30)
        assert not t.is_alive()
    spans = rec.drain().spans
    assert len(spans) == 201
    by_id = {s.id: s for s in spans}
    for s in spans:
        if s.name.startswith("select."):
            parent = by_id[s.parent]
            assert parent.name == "pass." + s.name[-1]
            assert parent.thread == s.thread and s.root == parent.id
        else:
            assert s.parent is None and s.root == s.id
    threads_of = {s.name: s.thread for s in spans}
    assert {n: threads_of[n] for n in idents} == idents
    assert len(set(idents.values())) == 3


@pytest.mark.parametrize("ident,want", [
    (0x7F3A_3432_1D00, 0x3432_1D00),
    (0x7F3A_A3E0_0000, (1 << 32) - 0xA3E0_0000)])
def test_thread_id_is_the_profilers(monkeypatch, ident, want):
    """The id under which ``torch.profiler`` files a thread's CUDA calls:
    ``pthread_self``'s low 32 bits, their sign dropped."""
    monkeypatch.setattr(prof.threading, "get_ident", lambda: ident)
    assert prof.thread_id() == want
    rec = SpanRecorder()
    rec.enable()
    with rec.span("epoch"):
        pass
    assert rec.drain().spans[0].thread == want


def test_off_records_nothing_and_returns_one_shared_object():
    rec = SpanRecorder()
    a, b = rec.span("epoch"), rec.span("solve")
    assert a is b and a is prof.span("normal_eq")
    with a as x:
        with b:
            pass
    assert x is a
    assert rec.drain() == ([], 0)
    assert not prof.RECORDER.on
    with prof.span("epoch"):
        pass
    assert prof.drain() == ([], 0)


def test_disable_lets_open_spans_close_and_stops_new_ones():
    rec = SpanRecorder()
    rec.enable()
    with rec.span("epoch"):
        rec.disable()
        with rec.span("solve"):
            pass
    assert [s.name for s in rec.drain().spans] == ["epoch"]


def test_cap_keeps_the_first_spans_and_counts_the_rest():
    rec = SpanRecorder(cap=5)
    rec.enable()
    for j in range(12):
        with rec.span(f"s{j}"):
            pass
    got = rec.drain()
    assert [s.name for s in got.spans] == [f"s{j}" for j in range(5)]
    assert got.dropped == 7


def test_drain_clears_spans_and_the_dropped_count():
    rec = SpanRecorder(cap=1)
    rec.enable()
    for _ in range(3):
        with rec.span("a"):
            pass
    assert len(rec.drain().spans) == 1
    assert rec.drain() == ([], 0)
    with rec.span("b"):
        pass
    got = rec.drain()
    assert [s.name for s in got.spans] == ["b"] and got.dropped == 0


def test_a_span_closes_when_its_block_raises():
    rec = SpanRecorder()
    rec.enable()
    with pytest.raises(ValueError):
        with rec.span("epoch"):
            with rec.span("solve"):
                raise ValueError("inside")
    with rec.span("next"):
        pass
    spans = rec.drain().spans
    assert [s.name for s in spans] == ["solve", "epoch", "next"]
    assert spans[2].parent is None


NU, NI, NNZ, K = 240, 160, 5000, 8


@pytest.fixture(scope="module")
def layouts():
    u, i, r = synthetic_ratings(NU, NI, NNZ, true_rank=4, noise=0.3, seed=5)
    # small blocks, so each group holds several
    kw = dict(max_groups=3, target_bytes=4096)
    ul = build_bucketed(u, i, r, NU, NI, 32, K, **kw)
    il = build_bucketed(i, u, r, NI, NU, 32, K, **kw)
    return (tbp.device_bucketed(ul, torch.float32, "cpu"),
            tbp.device_bucketed(il, torch.float32, "cpu"))


def _blocks(groups):
    return sum(g.other_idx.shape[0] for g in groups)


def _children(spans, parent):
    return [s for s in spans if s.parent == parent.id]


@pytest.mark.parametrize("alpha", [None, 2.0], ids=["als", "ials"])
def test_epoch_spans_form_the_layer_tree_and_change_no_factor(layouts,
                                                              alpha):
    dul, dil = layouts
    assert _blocks(dul) > len(dul) and _blocks(dil) > len(dil)
    fn = (tbp.als_epoch_fn(dul, dil, 0.05, True) if alpha is None
          else tbp.ials_epoch_fn(dul, dil, 0.05, alpha, True))
    st0 = tbase.init_state(NU, NI, K, seed=1, device="cpu")

    def epoch():
        st = st0._replace(U=st0.U.clone(), V=st0.V.clone())
        return fn(st)

    off = epoch()
    assert prof.drain() == ([], 0)
    prof.enable()
    try:
        on = epoch()
    finally:
        prof.disable()
    got = prof.drain()
    assert got.dropped == 0
    torch.testing.assert_close(on.U, off.U, rtol=0, atol=0)
    torch.testing.assert_close(on.V, off.V, rtol=0, atol=0)

    spans = got.spans
    (ep,) = [s for s in spans if s.name == "epoch"]
    assert ep.parent is None and {s.root for s in spans} == {ep.id}
    phases = _children(spans, ep)
    assert [p.name for p in phases] == ["phase.user", "phase.item"]
    base = [] if alpha is None else ["normal_eq"]  # iALS's base Gram
    for phase, groups in zip(phases, (dul, dil)):
        names = [s.name for s in sorted(_children(spans, phase),
                                        key=lambda s: s.start_ns)]
        assert names == base + ["normal_eq", "solve"] * _blocks(groups)
    assert len(spans) == 3 + 2 * len(base) + 2 * (_blocks(dul)
                                                  + _blocks(dil))


def _pass_problem():
    rng = np.random.default_rng(4)
    n_users, n_items = 200, 2000
    pairs = np.unique(np.stack([rng.integers(0, n_users, 4000),
                                rng.integers(0, n_items, 4000)], 1), axis=0)
    u, i = pairs[:, 0], pairs[:, 1]
    r = rng.integers(1, 6, len(u)).astype(np.float32)
    lay = build_blocked_csr(u, i, r, n_users, n_items, 8, block_chunks=32)
    st = tbase.init_state(n_users, n_items, 8, seed=2, device="cpu")
    return u, lay, st


def test_recommend_all_spans_a_pass_by_block(spans_on):
    u, lay, st = _pass_problem()
    assert lay.entity_ids.shape[0] > 1
    assert trec.use_fused("fused", st.n_items, 10, "cpu")
    users, items, _ = trec.recommend_all(st, lay, 10, method="fused")
    assert len(users) == len(np.unique(u)) and items.shape[1] == 10
    spans = spans_on.drain().spans
    (ps,) = [s for s in spans if s.name == "pass"]
    assert ps.parent is None and {s.root for s in spans} == {ps.id}
    kids = sorted(_children(spans, ps), key=lambda s: s.start_ns)
    names = [s.name for s in kids]
    nb = lay.entity_ids.shape[0]
    # the upload, the scoring's set-up, a score / select pair a block, the
    # lists stacked and brought to the host
    assert names == (["upload", "score"] + ["score", "select"] * nb
                     + ["to_host", "to_host"])
    assert len(spans) == len(kids) + 1


class _Dispatched(TorchDispatchMode):
    """The aten operations dispatched inside the mode, in order."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("run", ["als epoch", "ials epoch", "pass"])
def test_spans_dispatch_and_wait_for_nothing(monkeypatch, layouts, run):
    """Spans on, an epoch or a pass dispatches the same operations in the
    same order as spans off (a read back, such as ``.item()``, would add
    ``_local_scalar_dense``), and the recorder itself dispatches nothing
    and never waits for the device."""
    def refuse(*a, **k):
        raise AssertionError("a span waited for the device")

    dul, dil = layouts
    if run == "pass":
        _, lay, st = _pass_problem()

        def body():
            return trec.recommend_all(st, lay, 10, method="fused")
    else:
        fn = (tbp.als_epoch_fn(dul, dil, 0.05, True) if run == "als epoch"
              else tbp.ials_epoch_fn(dul, dil, 0.05, 2.0, True))
        st = tbase.init_state(NU, NI, K, seed=1, device="cpu")

        def body():
            return fn(st._replace(U=st.U.clone(), V=st.V.clone()))

    seen = []
    for on in (False, True):
        prof.drain()
        if on:
            prof.enable()
        try:
            with _Dispatched() as d:
                body()
        finally:
            prof.disable()
        seen.append(d.ops)
        assert bool(prof.drain().spans) == on
    assert seen[0] and seen[0] == seen[1]
    for target, name in ((torch.cuda, "synchronize"),
                         (torch.cuda.Event, "synchronize"),
                         (torch.cuda.Stream, "synchronize")):
        monkeypatch.setattr(target, name, refuse)
    prof.enable()
    try:
        with _Dispatched() as d:
            with prof.span("epoch"):
                with prof.span("solve"):
                    pass
    finally:
        prof.disable()
    assert d.ops == [] and len(prof.drain().spans) == 2


def _mm_events(events):
    return [e for e in events
            if e.get("name") == "aten::mm" and e.get("ph") == "X"]


def _inside(ev, start_us, end_us):
    return start_us <= ev["ts"] and ev["ts"] + ev["dur"] <= end_us


@pytest.mark.parametrize("route", ["trace file", "benchmark alignment"])
def test_span_clock_is_the_profilers(tmp_path, route):
    """Each ``aten::mm`` of a span-wrapped ``torch.mm`` lies inside its
    span, read from ``trace()``'s file or aligned by the benchmark's
    ``portbench/spans.align`` on a profiler's own Chrome trace."""
    a = torch.randn(96, 96)
    if route == "trace file":
        d = str(tmp_path / "prof")
        with trace(d):
            for j in range(5):
                with prof.span(f"mm{j}"):
                    torch.mm(a, a)
        (name,) = os.listdir(d)
        with open(os.path.join(d, name)) as f:
            events = json.load(f)["traceEvents"]
        spans = sorted([(e["ts"], e["ts"] + e["dur"], e["name"])
                        for e in events if e.get("cat") == prof.SPAN_CATEGORY])
    else:
        from portbench import spans as pspans

        path = str(tmp_path / "t.json")
        prof.drain()
        prof.enable()
        try:
            with torch.profiler.profile(
                    activities=[torch.profiler.ProfilerActivity.CPU]) as p:
                for j in range(5):
                    with prof.span(f"mm{j}"):
                        torch.mm(a, a)
        finally:
            prof.disable()
        p.export_chrome_trace(path)
        with open(path) as f:
            doc = json.load(f)
        events = doc["traceEvents"]
        spans = sorted((s[1] * 1e6, s[2] * 1e6, s[0]) for s in pspans.align(
            prof.drain().spans, int(doc.get("baseTimeNanoseconds", 0))))
    mms = sorted(_mm_events(events), key=lambda e: e["ts"])
    assert [s[2] for s in spans] == [f"mm{j}" for j in range(5)]
    assert len(mms) == 5
    for ev, (s0, s1, _) in zip(mms, spans):
        # the clocks' rounding: microseconds with three decimals
        assert _inside(ev, s0 - 1e-3, s1 + 1e-3), (ev, s0, s1)


def test_trace_writes_the_epochs_spans(tmp_path, layouts):
    dul, dil = layouts
    st = tbase.init_state(NU, NI, K, seed=1, device="cpu")
    d = str(tmp_path / "prof")
    with trace(d):
        tbp.als_epoch_fn(dul, dil, 0.05)(st)
    assert not prof.RECORDER.on and prof.drain() == ([], 0)
    (name,) = os.listdir(d)
    with open(os.path.join(d, name)) as f:
        events = json.load(f)["traceEvents"]
    ours = [e for e in events if e.get("cat") == prof.SPAN_CATEGORY]
    (ep,) = [e for e in ours if e["name"] == "epoch"]
    assert ep["ph"] == "X" and ep["args"]["parent"] is None
    assert {e["args"]["root"] for e in ours} == {ep["args"]["id"]}
    assert {e["name"] for e in ours} == {
        "epoch", "phase.user", "phase.item", "normal_eq", "solve"}
    # the kernels' plain versions ran inside the epoch, on the same base
    # and on the same thread's row
    mms = [e for e in events if e.get("cat") == "cpu_op"
           and e.get("name", "").startswith("aten::")]
    assert mms and all(_inside(e, ep["ts"] - 1e-3,
                               ep["ts"] + ep["dur"] + 1e-3) for e in mms)
    assert {e["tid"] for e in mms} == {e["tid"] for e in ours} == {
        threading.get_native_id()}


@pytest.mark.parametrize("x", [np.ones(4), np.arange(10.0) - 3.5,
                               np.float32([[1.5, 2.25], [-7.0, 0.125]])])
def test_device_sync_returns_the_jax_checksum(x):
    assert device_sync(torch.as_tensor(x)) == jprof.device_sync(
        jnp.asarray(x))


def test_device_sync_returns_checksum():
    assert device_sync(torch.ones(4)) == 4.0


def test_trace_writes_profile(tmp_path):
    d = str(tmp_path / "prof")
    with trace(d):
        device_sync(torch.ones(16) @ torch.ones((16, 4)))
    files = [os.path.join(r, f) for r, _, fs in os.walk(d) for f in fs]
    assert files, "no profiler output written"
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in str(e.get("name", "")) for e in events)


def test_trace_no_op_on_bad_dir():
    # unwritable dir: trace must swallow the failure, not raise
    with trace("/proc/definitely/not/writable"):
        device_sync(torch.ones(2))
    assert not prof.RECORDER.on
