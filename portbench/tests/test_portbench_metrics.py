"""Trace reading, the idle share, the per-layer readers' work counts on
hand-made traces, and the import boundary of the benchmark."""

import ast
import os
from types import SimpleNamespace

import pytest

from portbench import harness

HERE = harness.HERE


def reader(name):
    return harness.load_module(os.path.join(HERE, "metrics", name + ".py"))


def ev(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


def trace(events):
    """A trace whose window is [1000, 1100] us: a host call opens it."""
    return harness.read_trace(
        [ev("cudaLaunchKernel", "cuda_runtime", 1000.0, 2.0)] + events,
        100e-6)


def test_union_and_gaps():
    assert harness.union_length([(0, 2), (1, 3), (5, 6)]) == 4
    assert harness.union_length([]) == 0
    assert harness.idle_gaps([(1, 2), (1.5, 3), (5, 6)], 0, 7) == [
        (0, 1), (3, 5), (6, 7)]


def test_read_trace_counts_copies_as_busy_and_names_the_gaps():
    tr = trace([ev("spd_solve_warp_kernel<64>", "kernel", 1010, 20),
                ev("fused_gram_kernel<4, long>", "kernel", 1020, 20),
                ev("Memcpy DtoD", "gpu_memcpy", 1060, 10),
                ev("last", "kernel", 1090, 5),
                ev("cudaStreamSynchronize", "cuda_runtime", 1070, 20)])
    assert tr.window_s == pytest.approx(100e-6)
    # union: 1010-1040, 1060-1070, 1090-1095
    assert tr.busy_s == pytest.approx(45e-6)
    assert [k[0] for k in tr.kernels] == ["spd_solve_warp_kernel<64>",
                                         "fused_gram_kernel<4, long>",
                                         "last"]
    b = harness.breakdown(tr)
    assert b["device_ops"][0][0] in ("spd_solve_warp_kernel<64>",
                                     "fused_gram_kernel<4, long>")
    # gaps: 1000-1010 (the launch, then no call), 1040-1060, 1070-1090,
    # 1095-1100
    assert b["idle_gaps"][0] == ["host: no CUDA call", pytest.approx(20e-6)]
    assert b["idle_gaps"][1] == ["cudaStreamSynchronize",
                                 pytest.approx(20e-6)]
    idle = reader("idle.train").read(SimpleNamespace(trace=tr))
    assert idle == pytest.approx(55.0)


COUNTS = {"nnz": 1000, "users": 90, "items": 40, "n_users": 100,
          "n_items": 50, "rank": 8}
PEAKS = harness.PEAKS


def test_train_work_counts():
    k, nnz, ents = 8, 1000, 130
    als = {"alpha": None}
    ials = {"alpha": 40.0}
    mfu = reader("mfu.train")
    want = 2 * nnz * (2 * k * k + 2 * k) + ents * (k ** 3 / 3 + 2 * k * k)
    assert mfu.ops_per_epoch(als, COUNTS) == pytest.approx(want)
    extra = 2 * nnz * 2 * k + 2 * k * k * 150 + ents * k * k
    assert mfu.ops_per_epoch(ials, COUNTS) == pytest.approx(want + extra)
    ne = reader("roofline.normal_eq")
    assert ne.bytes_per_epoch(als, COUNTS) == (
        2 * nnz * 6 + 150 * k * 2 + ents * (36 + 8) * 4)
    ctx = SimpleNamespace(config=als, counts=COUNTS, epoch_ms=1.0)
    assert mfu.read(ctx) == pytest.approx(
        100 * want / 1e-3 / PEAKS["bf16_flops_per_s"])


def test_rooflines_split_k1_from_the_rest():
    tr = trace([ev("spd_solve_warp_kernel<64>", "kernel", 1000, 10),
                ev("fused_gram_kernel<4, long>", "kernel", 1010, 30),
                ev("Memcpy DtoD", "gpu_memcpy", 1050, 10)])
    ctx = SimpleNamespace(trace=tr, config={"alpha": None}, counts=COUNTS,
                          units=2)
    k1 = reader("roofline.spd_solve")
    assert k1.read(ctx) == pytest.approx(
        100 * k1.least_per_epoch(COUNTS) * 2 / 10e-6)
    ne = reader("roofline.normal_eq")
    least = max(ne.ops_per_epoch({"alpha": None}, COUNTS)
                / PEAKS["bf16_flops_per_s"],
                ne.bytes_per_epoch({"alpha": None}, COUNTS)
                / PEAKS["hbm_bytes_per_s"])
    assert ne.read(ctx) == pytest.approx(100 * least * 2 / 30e-6)
    # no K1 kernel traced: the reader reads nothing rather than 0
    ctx.trace = trace([ev("fused_gram_kernel", "kernel", 1000, 10)])
    assert k1.read(ctx) is None


def test_topn_readers():
    counts = {"users": 100, "n_items": 1000, "rank": 64, "n": 10}
    tr = trace([ev("fused_scores_kernel", "kernel", 1000, 40),
                ev("topk", "kernel", 1040, 20),
                ev("Memcpy HtoD", "gpu_memcpy", 1060, 30)])
    ctx = SimpleNamespace(trace=tr, counts=counts, units=3,
                          traced_wall_s=1e-3)
    ops = 2.0 * 100 * 1000 * 64
    nbytes = 1100 * 64 * 2 + 100 * 125 + 100 * 80
    least = max(ops / PEAKS["bf16_flops_per_s"],
                nbytes / PEAKS["hbm_bytes_per_s"])
    assert reader("roofline.topn").read(ctx) == pytest.approx(
        100 * least * 3 / 60e-6)
    assert reader("mfu.topn").read(ctx) == pytest.approx(
        100 * ops * 3 / 1e-3 / PEAKS["bf16_flops_per_s"])
    assert reader("recs_per_s.topn").read(ctx) is None
    ctx.recs_per_s = 1.25e6
    assert reader("recs_per_s.topn").read(ctx) == 1.25e6


class KinetoEvent:
    """The profiler's own event, as far as ``kernel_seconds`` reads it:
    with its category, as newer torch gives it."""

    def __init__(self, e):
        self.e = e

    def activity_type(self):
        return self.e["cat"]

    def start_ns(self):
        return int(self.e["ts"] * 1000)

    def duration_ns(self):
        return int(self.e["dur"] * 1000)


class OlderKinetoEvent:
    """As older torch gives it: a device and a name, no category."""

    def __init__(self, e):
        self.e = e

    def device_type(self):
        gpu = self.e["cat"] in ("kernel", "gpu_memcpy", "gpu_memset")
        return "DeviceType.CUDA" if gpu else "DeviceType.CPU"

    def name(self):
        return self.e["name"]

    def start_ns(self):
        return int(self.e["ts"] * 1000)

    def duration_ns(self):
        return int(self.e["dur"] * 1000)


@pytest.mark.parametrize("route", ["profiler events", "older profiler events",
                                   "chrome trace"])
def test_topn_window_reports_the_kernels_time_a_pass(monkeypatch, route):
    """The pass's kernels, as a union, over the passes; the pageable
    upload's copy is left out and the rate goes to ``recs_per_s``."""
    kind = harness.load_module(os.path.join(HERE, "traffic", "passes.py"))
    events = [ev("cudaLaunchKernel", "cuda_runtime", 1000.0, 2.0),
              ev("fused_scores_kernel", "kernel", 1000, 40),
              ev("topk", "kernel", 1030, 20),
              ev("Memcpy HtoD (Pageable -> Device)", "gpu_memcpy", 1050, 40),
              ev("Memset (Device)", "gpu_memset", 1095, 20)]
    prof = None
    if route != "chrome trace":
        cls = KinetoEvent if route == "profiler events" else OlderKinetoEvent
        res = SimpleNamespace(events=lambda: [cls(e) for e in events])
        prof = SimpleNamespace(profiler=SimpleNamespace(kineto_results=res))
    monkeypatch.setattr(harness, "_profiled",
                        lambda fn, device: (fn(), prof, 100e-6))
    monkeypatch.setattr(harness, "_chrome_events", lambda prof: events)
    run = kind.Run.__new__(kind.Run)
    run.device = "cpu"
    run._passes = lambda seconds: (2, 600, 0.5)
    out = run.window(1.0)
    # kernels cover 1000-1050 us: 50 us over 2 passes
    assert out["metrics"] == {"pass_kernel_ms": pytest.approx(0.025)}
    assert out["attempted"] == 2 and out["failed"] == 0
    assert run.recs_per_s == 1200.0


def test_server_readers():
    stats = {"batches": 40, "batched_requests": 100,
             "latency": {"p99_ms": 12.5}}
    ctx = SimpleNamespace(stats=stats)
    assert reader("server_p99_ms.online").read(ctx) == 12.5
    assert reader("batch_size.online").read(ctx) == 2.5
    assert reader("batch_size.online").read(
        SimpleNamespace(stats={"batches": 0})) is None


def test_every_per_layer_metric_has_a_reader_and_moves_a_reported_metric():
    bench = harness.load_json(os.path.join(harness.ROOT, "BENCHMARK.json"))
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    for m in bench["per_layer"]:
        assert os.path.exists(os.path.join(HERE, "metrics",
                                           m["name"] + ".py"))
        moved = e2e[m["moves"]]
        for w in m["workloads"]:
            assert w in moved.get("workloads", [w])


def imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_import_boundary():
    banned = {"jax", "jaxlib", "flax", "ycnr_tpu"}
    for dirpath, _, files in os.walk(HERE):
        for f in files:
            if not f.endswith(".py"):
                continue
            path = os.path.join(dirpath, f)
            tops = {m.split(".")[0] for m in imports(path)}
            assert not tops & banned, path
            if os.path.relpath(dirpath, HERE).startswith("reference"):
                assert "ycnr_tpu_torch" not in tops, path
