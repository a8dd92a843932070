"""The benchmark's driver: finds a cell's files by the names in
``BENCHMARK.json``, runs it (set-up, the measured window, the traced
segment, the check against the plain reference) and prints the result.

Everything that belongs to one cell lives in files of its own:

* ``configs/<config>.json``: the configuration (sizes, settings, the
  generator assumed for the ratings, the plain reference beside it);
* ``traffic/<traffic>.json``: the traffic mix's parameters, naming the
  traffic kind, ``traffic/<kind>.py``, that drives and checks it;
* ``workloads/<cell>.json``: the cell's own numbers (rates, samples, the
  limits of its check);
* ``metrics/<metric>.py``: one reader for each per-layer metric.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import math
import os
import sys
import tempfile
import time
from types import SimpleNamespace

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
BANNED = ("jax", "jaxlib", "flax", "ycnr_tpu")


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def load_json(path: str):
    with open(path) as f:
        return json.load(f)


# the card's published peaks, which the rooflines and mfu metrics read
PEAKS = load_json(os.path.join(HERE, "peaks.json"))


def load_module(path: str):
    """A module loaded from a file of the benchmark by its path (metric
    readers carry dots in their names)."""
    name = "portbench_" + os.path.relpath(path, HERE).replace(
        os.sep, "_").replace(".", "_").replace("-", "_")
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def cell_spec(workload: str, bench=None) -> SimpleNamespace:
    """Everything a cell's run reads, found by name."""
    bench = bench or load_json(os.path.join(ROOT, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; BENCHMARK.json "
                         f"has {sorted(cells)}")
    w = cells[workload]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = load_json(os.path.join(ROOT, conf["file"]))
    mix = load_json(os.path.join(HERE, "traffic", w["traffic"] + ".json"))

    def reported(metrics):
        return [m for m in metrics
                if workload in m.get("workloads", [workload])]

    return SimpleNamespace(
        name=workload, chips=w["chips"], config=config, mix=mix,
        cell=load_json(os.path.join(HERE, "workloads", workload + ".json")),
        kind=load_module(os.path.join(HERE, "traffic", mix["kind"] + ".py")),
        end_to_end=reported(bench["end_to_end"]),
        per_layer=reported(bench["per_layer"]))


class Phases:
    """Named host-clock phases of set-up, printed on an earlier line."""

    def __init__(self, start: float):
        self.start = start
        self.last = start
        self.done = {}

    def mark(self, name: str):
        t = time.perf_counter()
        self.done[name] = self.done.get(name, 0.0) + t - self.last
        self.last = t

    def total(self) -> float:
        return self.last - self.start


def sync(device):
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


# -- the device trace ------------------------------------------------------

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cuda_runtime", "cuda_driver", "cpu_op", "user_annotation",
             "python_function")


def union_length(intervals) -> float:
    """Length of the union of ``(start, end)`` intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def idle_gaps(intervals, lo: float, hi: float):
    """The gaps ``(start, end)`` inside ``[lo, hi]`` that no interval
    covers."""
    gaps, at = [], lo
    for s, e in sorted(intervals):
        if s > at:
            gaps.append((at, min(s, hi)))
        at = max(at, e)
        if at >= hi:
            break
    if at < hi:
        gaps.append((at, hi))
    return [(s, e) for s, e in gaps if e > s]


def read_trace(events, window_s: float) -> SimpleNamespace:
    """Device operations and host calls of a Chrome trace, in seconds.
    The traced window is ``window_s`` long (the host's clock around the
    traced body, which ends in a synchronize) and starts at the trace's
    first event. ``kernels`` are ``(name, start, dur)`` of device kernels;
    ``busy_s`` is the union of every device operation (kernels, copies,
    fills); ``gaps`` are the window's stretches with none."""
    dev, host = [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        s, d = float(e["ts"]), float(e["dur"])
        if e.get("cat") in DEVICE_CATS:
            dev.append((e["name"], s, s + d, e["cat"]))
        elif e.get("cat") in HOST_CATS:
            host.append((e["name"], s, s + d))
    us = 1e-6
    lo = min([s for _, s, _, _ in dev] + [s for _, s, _ in host],
             default=0.0)
    hi = lo + window_s / us
    busy = union_length([(s, e) for _, s, e, _ in dev])
    gaps = idle_gaps([(s, e) for _, s, e, _ in dev], lo, hi)
    return SimpleNamespace(
        window_s=window_s, busy_s=busy * us,
        kernels=[(n, s * us, (e - s) * us) for n, s, e, c in dev
                 if c == "kernel"],
        ops=[(n, s * us, (e - s) * us) for n, s, e, _ in dev],
        gaps=[(s * us, (e - s) * us) for s, e in gaps],
        host=[(n, s * us, e * us) for n, s, e in host])


def breakdown(tr, top: int = 10) -> dict:
    """The device operations that took most time, and the longest idle
    gaps named by the innermost host op running at each gap's middle."""
    by = {}
    for name, _, d in tr.ops:
        key = name if len(name) <= 160 else name[:157] + "..."
        by[key] = by.get(key, 0.0) + d
    ops = sorted(by.items(), key=lambda kv: -kv[1])[:top]
    gaps = sorted(tr.gaps, key=lambda g: -g[1])[:top]
    named = []
    for s, d in gaps:
        mid = s + d / 2
        inner = [h for h in tr.host if h[1] <= mid <= h[2]]
        label = (max(inner, key=lambda h: h[1])[0] if inner
                 else "host: no CUDA call")
        named.append([label[:160], d])
    return {"device_ops": [[n, v] for n, v in ops], "idle_gaps": named}


def _profiled(fn, device, all_threads: bool = False):
    """Run ``fn()`` under ``torch.profiler``: ``(fn's result, the
    profiler, the host-clock seconds of the body and its final
    synchronize)``. On the card only device activity is recorded
    (kernels, copies, and the CUDA calls that issue them): recording every
    host op would slow the host several-fold and make the device look
    idle. ``all_threads`` also records the work that other threads issue
    (a server's)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.device(device).type == "cuda"
    kw = {"activities": [ProfilerActivity.CUDA if cuda
                         else ProfilerActivity.CPU]}
    if all_threads:
        kw["experimental_config"] = torch._C._profiler._ExperimentalConfig(
            profile_all_threads=True)
    with profile(**kw) as prof:
        t0 = time.perf_counter()
        out = fn()
        sync(device)
        window = time.perf_counter() - t0
    return out, prof, window


def _chrome_events(prof) -> list:
    """The profiler's Chrome trace, through a temporary file that is read
    and deleted."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        return load_json(path).get("traceEvents", [])
    finally:
        os.remove(path)


def traced(fn, device, all_threads: bool = False):
    """Run ``fn()`` under ``torch.profiler``; returns ``(fn's result, the
    read trace)`` (see ``_profiled`` and ``read_trace``)."""
    out, prof, window = _profiled(fn, device, all_threads)
    t = time.perf_counter()
    tr = read_trace(_chrome_events(prof), window)
    log(f"trace read in {time.perf_counter() - t:.2f} s")
    return out, tr


COPY_NAMES = ("Memcpy", "Memset")


def _kernel_spans(events):
    """``(start, end)`` in seconds of the device kernels among the
    profiler's own events, or None where this torch does not say which
    events are kernels. Newer torch names each event's category
    (``activity_type``); older torch gives the device, on which kernels,
    copies and fills run, and copies and fills are named so."""
    if not events:
        return None
    e0 = events[0]
    if not all(hasattr(e0, a) for a in ("start_ns", "duration_ns")):
        return None
    if hasattr(e0, "activity_type"):
        keep = [e for e in events if e.activity_type() == "kernel"]
    elif hasattr(e0, "device_type") and hasattr(e0, "name"):
        keep = [e for e in events if str(e.device_type()).endswith("CUDA")
                and not e.name().startswith(COPY_NAMES)]
    else:
        return None
    return [(e.start_ns() * 1e-9, (e.start_ns() + e.duration_ns()) * 1e-9)
            for e in keep]


def kernel_seconds(fn, device):
    """Run ``fn()`` under ``torch.profiler``; returns ``(fn's result, the
    length of the union of the device kernels' intervals in seconds)``.
    The kernels are read from the profiler's own events, without writing
    a Chrome trace (a window of some 10^6 events takes tens of seconds to
    write and read back), and from the Chrome trace where those events do
    not tell kernels apart."""
    out, prof, window = _profiled(fn, device)
    t = time.perf_counter()
    res = getattr(getattr(prof, "profiler", None), "kineto_results", None)
    spans = _kernel_spans(res.events() if res is not None else [])
    if spans is None:
        spans = [(s, s + d) for _, s, d in
                 read_trace(_chrome_events(prof), window).kernels]
    total = union_length(spans)
    log(f"kernels read in {time.perf_counter() - t:.2f} s")
    return out, total


# -- checks and the result line -------------------------------------------

def compare(readings: dict, limits: dict) -> list:
    """``[name, value, limit, ok]`` for each limited reading; a missing
    or non-finite reading fails."""
    rows = []
    for name, limit in limits.items():
        v = readings.get(name)
        ok = v is not None and math.isfinite(v) and v <= limit
        rows.append([name, v, limit, ok])
    return rows


def banned_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(BANNED))


def device_info(device, chips: int) -> dict:
    import torch

    return {"platform": "gpu",
            "kind": torch.cuda.get_device_name(device),
            "count": chips,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))}


def power_limit() -> str:
    """``name, power.limit`` of the card, as nvidia-smi reads them."""
    import subprocess

    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"not read ({e})"


def run_cell(spec, seed: int, seconds: float, trace: bool, device,
             t_start: float) -> dict:
    """One run of a cell: set-up, the window, with ``trace`` the traced
    segment and its per-layer metrics, then the check; returns the result
    object that ``main`` prints."""
    import torch

    phases = Phases(t_start)
    phases.mark("interpreter, torch, CUDA context")
    run = spec.kind.Run(spec, seed, device, phases, trace)
    run.setup()
    sync(device)
    phases.mark("warm-up")
    setup_s = phases.total()
    log("setup phases (s): " + json.dumps(
        {k: round(v, 4) for k, v in phases.done.items()}))
    e2e = run.window(seconds)
    values = dict(e2e["metrics"], setup_s=setup_s)
    units = {m["name"]: m["unit"] for m in spec.end_to_end + spec.per_layer}
    out = {"correct": False, "attempted": e2e["attempted"],
           "failed": e2e["failed"]}
    if trace:
        ctx = run.trace()
        tr = ctx.trace
        metrics = {}
        for m in spec.per_layer:
            reader = load_module(os.path.join(HERE, "metrics",
                                              m["name"] + ".py"))
            v = reader.read(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": units[m["name"]]}
        out["metrics"] = metrics
        out["breakdown"] = breakdown(tr)
        extra = {"busy_s": tr.busy_s, "window_s": tr.window_s}
    else:
        out["metrics"] = {m["name"]: {"value": values[m["name"]],
                                      "unit": m["unit"]}
                          for m in spec.end_to_end}
        extra = {}
    log("end-to-end: " + json.dumps(values))
    out["device"] = extra
    if torch.device(device).type == "cuda":
        out["device"] = dict(device_info(device, spec.chips), **extra)
    run.release()
    t = time.perf_counter()
    readings = run.check()
    log(f"check: {time.perf_counter() - t:.2f} s")
    rows = compare(readings, spec.cell["limits"])
    out["correct"] = all(ok for *_, ok in rows)
    # the compared numbers come last in the result line
    out["compared"] = {name: {"value": v, "limit": limit, "ok": ok}
                       for name, v, limit, ok in rows}
    return out


def main(argv=None):
    t_start = time.perf_counter()
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    spec = cell_spec(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < spec.chips:
        log(f"{args.workload} needs {spec.chips} CUDA device(s); "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
            f" available")
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    torch.zeros(1, device=device)  # the CUDA context, timed on its own
    out = run_cell(spec, args.seed, args.seconds, bool(args.trace), device,
                   t_start)
    log(f"card: {power_limit()}")
    found = banned_modules()
    if found:
        log(f"modules of JAX or of the JAX package are loaded: {found}")
        return 3
    # the compared numbers come last, on stderr and in the result line
    for name, c in out["compared"].items():
        log(f"compared {name}: {c['value']!r} limit {c['limit']!r} "
            f"{'ok' if c['ok'] else 'FAILED'}")
    print(json.dumps(out), flush=True)
    return 0
