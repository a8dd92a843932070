"""The program's spans joined to the device trace (``portbench/spans.py``)
and the six readers on it, on hand-made traces; nothing read where the
program has no spans; and, on the card, every ``fused_gram`` and K1
launch of a traced ALS-WR epoch inside its span."""

import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from portbench import harness, spans
from ycnr_tpu_torch.utils.profiling import SpanRecord

HERE = harness.HERE
NEW = ("issue_ms.train", "idle_host.train", "launches.train",
       "device_ms.normal_eq", "device_ms.spd_solve", "device_ms.select")


def reader(name):
    return harness.load_module(os.path.join(HERE, "metrics", name + ".py"))


def ev(name, cat, ts, dur, corr=None, tid=7):
    e = {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
         "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def launch(ts, corr, name="cudaLaunchKernel", tid=7):
    return ev(name, "cuda_runtime", ts, 0.5, corr, tid)


def rec(name, start_us, end_us, sid, parent=None, root=None, thread=7):
    """A closed span, its times in microseconds (base 0)."""
    return SpanRecord(name, int(start_us * 1e3), int(end_us * 1e3), sid,
                      parent, root or sid, thread)


# two epochs in a window of [1000, 1100] us, with a synchronize's copy
# between them that no span launched
EPOCH_SPANS = [rec("epoch", 1004, 1060, 1),
               rec("phase.user", 1005, 1058, 2, 1, 1),
               rec("normal_eq", 1005.5, 1010, 3, 2, 1),
               rec("solve", 1011, 1014, 4, 2, 1),
               rec("solve", 1015, 1016, 5, 2, 1),
               rec("epoch", 1080, 1095, 6),
               rec("normal_eq", 1081, 1083, 7, 6, 6)]
EPOCH_EVENTS = [
    ev("cudaStreamSynchronize", "cuda_runtime", 1000.0, 2.0),
    launch(1007, 1), ev("fused_gram_kernel<4, long>", "kernel", 1012, 20, 1),
    launch(1012, 2), ev("spd_solve_warp_kernel<64>", "kernel", 1032, 10, 2),
    launch(1013, 3), ev("elementwise_kernel", "kernel", 1042, 5, 3),
    launch(1015.2, 4), ev("index_put_kernel", "kernel", 1047, 3, 4),
    launch(1070, 5, "cudaMemcpyAsync"),
    ev("Memcpy DtoH", "gpu_memcpy", 1075, 5, 5),
    launch(1082, 6), ev("row_gather_kernel", "kernel", 1085, 5, 6)]


def joined_ctx(span_recs, events, dropped=0):
    tr = harness.read_trace(events, 100e-6)
    j = spans.Joined(spans.align(span_recs, 0), spans.read_links(events),
                     dropped)
    return SimpleNamespace(trace=tr, spans=j, units=2)


def test_operations_go_to_the_span_their_launch_lies_in():
    ctx = joined_ctx(EPOCH_SPANS, EPOCH_EVENTS)
    got = {name: sid for name, _, _, sid, _ in ctx.spans.ops}
    assert got == {"fused_gram_kernel<4, long>": 3,
                   "spd_solve_warp_kernel<64>": 4, "elementwise_kernel": 4,
                   "index_put_kernel": 5, "Memcpy DtoH": None,
                   "row_gather_kernel": 7}
    assert ctx.spans.within(3, "epoch") and ctx.spans.within(3, "phase.user")
    assert not ctx.spans.within(7, "phase.user")
    assert [o[0] for o in ctx.spans.ops_in("epoch")] == [
        "fused_gram_kernel<4, long>", "spd_solve_warp_kernel<64>",
        "elementwise_kernel", "index_put_kernel", "row_gather_kernel"]


def test_the_train_readers():
    ctx = joined_ctx(EPOCH_SPANS, EPOCH_EVENTS)
    # epochs of 56 and 15 us
    assert reader("issue_ms.train").read(ctx) == pytest.approx(0.0355)
    # idle inside the epochs: 1004-1012, 1050-1060, 1080-1085, 1090-1095
    assert reader("idle_host.train").read(ctx) == pytest.approx(28.0)
    assert reader("idle.train").read(ctx) == pytest.approx(52.0)
    assert reader("launches.train").read(ctx) == 2.5
    # (20 + 5) and (10 + 5 + 3) us over two epochs
    assert reader("device_ms.normal_eq").read(ctx) == pytest.approx(0.0125)
    assert reader("device_ms.spd_solve").read(ctx) == pytest.approx(0.009)
    assert reader("device_ms.select").read(ctx) is None


def test_the_select_reader():
    recs = [rec("pass", 1000, 1050, 10), rec("select", 1010, 1020, 11, 10),
            rec("score", 1021, 1025, 12, 10)]
    events = [launch(1011, 7), ev("topk", "kernel", 1030, 8, 7),
              launch(1022, 8), ev("fused_scores_kernel", "kernel", 1040, 4, 8)]
    ctx = joined_ctx(recs, events)
    assert reader("device_ms.select").read(ctx) == pytest.approx(0.008)
    assert reader("device_ms.normal_eq").read(ctx) is None


def test_launches_go_to_the_spans_of_their_own_thread():
    """A launch goes to the spans of the thread that issued it (the trace
    and the spans name threads alike, ``profiling.thread_id``); an open
    span of another thread takes none of its launches."""
    recs = [rec("epoch", 1000, 1050, 1, thread=7),
            rec("solve", 1010, 1020, 2, 1, 1, thread=7),
            rec("pass", 1005, 1030, 3, thread=8),
            rec("select", 1012, 1016, 4, 3, 3, thread=8),
            rec("pass", 1052, 1060, 5, thread=8)]
    events = [launch(1004, 1, tid=7), ev("a", "kernel", 1030, 5, 1),
              launch(1013, 2, tid=7), ev("b", "kernel", 1036, 5, 2),
              launch(1014, 3, tid=8), ev("c", "kernel", 1042, 5, 3),
              launch(1055, 4, tid=8), ev("d", "kernel", 1057, 1, 4),
              launch(1070, 5, tid=97), ev("e", "kernel", 1072, 1, 5),
              ev("orphan", "kernel", 1080, 1, 6)]
    j = joined_ctx(recs, events).spans
    assert [(o[0], o[3], o[4] is None) for o in j.ops] == [
        ("a", 1, False), ("b", 2, False), ("c", 4, False), ("d", 5, False),
        ("e", None, False), ("orphan", None, True)]


@pytest.mark.parametrize("name", NEW)
@pytest.mark.parametrize("program", ["no spans", "spans dropped"])
def test_nothing_is_read_without_every_span(name, program):
    """A program without spans (the parent's), or one that dropped some at
    its cap, gives no reading rather than a short one."""
    if program == "no spans":
        ctx = SimpleNamespace(trace=harness.read_trace(EPOCH_EVENTS, 100e-6),
                              units=2)
        assert reader(name).read(ctx) is None
        ctx.spans = None
    else:
        ctx = joined_ctx(EPOCH_SPANS, EPOCH_EVENTS, dropped=3)
    assert reader(name).read(ctx) is None


def test_breakdown_names_gaps_by_span():
    ctx = joined_ctx(EPOCH_SPANS, EPOCH_EVENTS)
    want = [["host: no CUDA call", pytest.approx(25e-6)],  # between epochs
            ["span:normal_eq", pytest.approx(12e-6)],
            ["span:epoch", pytest.approx(10e-6)],
            ["cudaLaunchKernel", pytest.approx(5e-6)]]
    assert spans.breakdown(ctx.trace, ctx.spans)["idle_gaps"] == want
    plain = harness.breakdown(ctx.trace)
    assert [g[0] for g in plain["idle_gaps"]] == [
        "host: no CUDA call", "host: no CUDA call", "host: no CUDA call",
        "cudaLaunchKernel"]
    assert spans.breakdown(ctx.trace, None) == plain


@pytest.mark.parametrize("program", ["with spans", "without spans"])
def test_traced_reads_the_trace_as_the_harness_does(monkeypatch, program):
    from ycnr_tpu_torch.utils import profiling

    if program == "without spans":
        monkeypatch.setattr(spans, "recorder", lambda: None)

    def body():
        with profiling.span("epoch"):
            return torch.ones(64, 64) @ torch.ones(64, 64)

    out, tr, j = spans.traced(body, "cpu")
    assert float(out[0, 0]) == 64.0 and tr.window_s > 0
    assert not profiling.RECORDER.on
    if program == "with spans":
        assert [s[0] for s in j.spans] == ["epoch"] and j.dropped == 0
        assert profiling.drain() == ([], 0)
    else:
        assert j is None


@pytest.mark.cuda
def test_every_gram_and_solve_launch_lies_in_its_span():
    """On the card: the launches of a traced bucketed ALS-WR epoch (the
    fused branch) fall inside ``normal_eq`` and ``solve`` spans on the
    trace's clock."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import ycnr_tpu_torch.models.bucketed_phase as bp
    from ycnr_tpu_torch.data.synthetic import synthetic_ratings
    from ycnr_tpu_torch.models.base import init_state
    from ycnr_tpu_torch.ops.bucketed import build_bucketed

    dev = torch.device("cuda", 0)
    nu, ni, k = 3000, 1200, 64
    u, i, r = synthetic_ratings(nu, ni, 120000, seed=3)
    assert bp.uses_fused(dev, torch.float32, None, True, k)
    ul = bp.device_bucketed(build_bucketed(u, i, r, nu, ni, 32, k), device=dev,
                            rating_dtype=torch.bfloat16)
    il = bp.device_bucketed(build_bucketed(i, u, r, ni, nu, 32, k), device=dev,
                            rating_dtype=torch.bfloat16)
    fn = bp.als_epoch_fn(ul, il, 0.05, gather_bf16=True)
    st = fn(init_state(nu, ni, k, seed=1, device=dev))
    torch.cuda.synchronize()

    def epochs():
        s = st
        for _ in range(3):
            s = fn(s)
        return s

    _, _, j = spans.traced(epochs, dev)
    assert j is not None and j.dropped == 0
    assert len(j.named("epoch")) == 3
    want = {"fused_gram": "normal_eq", "spd_solve": "solve"}
    seen = {key: 0 for key in want}
    for name, _, _, sid, la in j.ops:
        key = next((key for key in want if key in name), None)
        if key is None:
            continue
        seen[key] += 1
        assert la is not None, name
        assert sid is not None and j.by_id[sid][0] == want[key], name
    assert all(seen.values()), seen
    blocks = sum(g.other_idx.shape[0] for g in ul + il)
    assert seen["spd_solve"] == 3 * blocks
    assert np.isfinite(spans._alignment(j)["shift_us_all"]).all()
