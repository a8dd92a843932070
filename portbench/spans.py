"""The program's spans joined to the device trace.

The port marks its layers with spans (``ycnr_tpu_torch/utils/profiling``:
``epoch``, ``phase.user`` / ``phase.item``, ``normal_eq``, ``solve``;
``pass``, ``upload``, ``score``, ``select``, ``to_host``),
timed by ``time.time_ns()``. ``torch.profiler`` writes its events on the
same clock less the trace's ``baseTimeNanoseconds``, so a span lands on
the trace's time base by subtracting that base (``align``). Each device
operation is then given the span in which its launch was issued: the
``cuda_runtime`` / ``cuda_driver`` event with the same correlation id,
placed inside the innermost span of its thread open at its start
(``Joined``). A layer's device time is then what it launched, whatever
the kernels are named.

``traced`` is the traced segment with the program's spans on; the
per-layer readers ``metrics/issue_ms.train.py``, ``idle_host.train.py``,
``launches.train.py``, ``device_ms.normal_eq.py``,
``device_ms.spd_solve.py`` and ``device_ms.select.py`` read its ``Joined``
from ``ctx.spans`` (None where the program has no spans: they then read
nothing). Run as a script, it drives one cell's traced segment with the
spans off and on, in turns, and prints every reading::

    python3 portbench/spans.py --workload ml20m-als.train --seed 5301
"""

from __future__ import annotations

import argparse
import bisect
import json
import os
import sys
import time
from types import SimpleNamespace

if __package__ in (None, ""):  # run as a script, as portbench/run.py is
    _ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, _ROOT)
    for _var, _sub in (("TRITON_CACHE_DIR", "triton"),
                       ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[_var] = os.path.join(_ROOT, ".portbench_cache", _sub)

from portbench import harness  # noqa: E402

LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
NO_CALL = "host: no CUDA call"  # harness.breakdown's label


def recorder():
    """The program's span recorder, or None where the program has none."""
    try:
        from ycnr_tpu_torch.utils import profiling
    except ImportError:
        return None
    rec = getattr(profiling, "RECORDER", None)
    if not all(hasattr(rec, a) for a in ("enable", "disable", "drain")):
        return None
    return rec


def align(spans, base_ns: int) -> list:
    """Spans (``SpanRecord``s) on ``harness.read_trace``'s time base:
    ``(name, start_s, end_s, id, parent, thread)``, seconds since
    ``base_ns``, which is the Chrome trace's ``baseTimeNanoseconds``."""
    return [(s.name, (s.start_ns - base_ns) * 1e-9,
             (s.end_ns - base_ns) * 1e-9, s.id, s.parent, s.thread)
            for s in spans]


def read_links(events) -> SimpleNamespace:
    """The launches and the device operations of a Chrome trace, with
    their correlation ids, in seconds: ``launches`` maps an id to
    ``(start, end, thread)``; ``ops`` are ``(name, start, dur, id)``."""
    launches, ops = {}, []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        corr = (e.get("args") or {}).get("correlation")
        if corr is None:
            continue
        s, d = float(e["ts"]) * 1e-6, float(e["dur"]) * 1e-6
        if e.get("cat") in harness.DEVICE_CATS:
            ops.append((e["name"], s, d, corr))
        elif e.get("cat") in LAUNCH_CATS:
            launches[corr] = (s, s + d, e.get("tid"))
    return SimpleNamespace(launches=launches, ops=ops)


class Joined:
    """Aligned spans and the device operations each one launched.

    ``spans``: ``align``'s tuples; ``dropped``: spans the program dropped
    at its cap (the readers read nothing then: counts would be short);
    ``ops``: ``(name, start, dur, span id or None, launch or None)``, the
    span being the innermost of the launching thread open when the launch
    began, the launch ``read_links``'s ``(start, end, thread)``."""

    def __init__(self, spans, links, dropped: int = 0):
        self.spans = sorted(spans, key=lambda s: (s[1], s[3]))
        self.dropped = dropped
        self.by_id = {s[3]: s for s in self.spans}
        never = (float("inf"),)
        self.ops = []
        stacks, nxt = {}, 0
        for name, start, dur, corr in sorted(
                links.ops, key=lambda o: links.launches.get(o[3], never)[0]):
            launch = links.launches.get(corr)
            sid = None
            if launch is not None:
                t = launch[0]
                while nxt < len(self.spans) and self.spans[nxt][1] <= t:
                    s = self.spans[nxt]
                    stacks.setdefault(s[5], []).append(s)
                    nxt += 1
                stack = stacks.get(launch[2], [])
                while stack and stack[-1][2] < t:
                    stack.pop()
                sid = stack[-1][3] if stack else None
            self.ops.append((name, start, dur, sid, launch))

    def named(self, name: str) -> list:
        return [s for s in self.spans if s[0] == name]

    def within(self, sid, name: str) -> bool:
        """Whether span ``sid`` or one of its ancestors is ``name``."""
        while sid is not None:
            s = self.by_id.get(sid)
            if s is None:
                return False
            if s[0] == name:
                return True
            sid = s[4]
        return False

    def ops_in(self, name: str) -> list:
        """The device operations launched inside spans called ``name``."""
        return [o for o in self.ops if self.within(o[3], name)]

    def at(self, t: float):
        """The innermost span open at ``t`` on any thread, or None."""
        inner = [s for s in self.spans if s[1] <= t <= s[2]]
        return max(inner, key=lambda s: s[1]) if inner else None


def per_unit(joined, unit: str):
    """The number of complete ``unit`` spans (epochs, passes), or None
    where there are none or spans were dropped."""
    if joined is None or joined.dropped:
        return None
    return len(joined.named(unit)) or None


def device_s(joined, layer: str, unit: str):
    """Device seconds a ``unit`` of the operations launched in ``layer``
    spans, or None."""
    n = per_unit(joined, unit)
    if n is None:
        return None
    ops = joined.ops_in(layer)
    return sum(o[2] for o in ops) / n if ops else None


def overlap(gaps, spans) -> float:
    """Seconds of the ``(start, dur)`` gaps that lie inside the union of
    the ``spans``."""
    ivs = sorted((s[1], s[2]) for s in spans)
    merged = []
    for a, b in ivs:
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    starts = [a for a, _ in merged]
    total = 0.0
    for g0, gd in gaps:
        g1 = g0 + gd
        j = max(bisect.bisect_right(starts, g0) - 1, 0)
        while j < len(merged) and merged[j][0] < g1:
            total += max(0.0, min(g1, merged[j][1]) - max(g0, merged[j][0]))
            j += 1
    return total


def breakdown(tr, joined, top: int = 10) -> dict:
    """``harness.breakdown``, with each gap that no CUDA call covers
    named by the innermost program span at its middle, ``span:<name>``;
    ``host: no CUDA call`` is left only where no span covers it either."""
    out = harness.breakdown(tr, top)
    if joined is None:
        return out
    gaps = sorted(tr.gaps, key=lambda g: -g[1])[:top]
    for entry, (s, d) in zip(out["idle_gaps"], gaps):
        if entry[0] == NO_CALL:
            inner = joined.at(s + d / 2)
            if inner is not None:
                entry[0] = "span:" + inner[0]
    return out


def _chrome_doc(prof) -> dict:
    """The profiler's whole Chrome trace (events and base time), through a
    temporary file that is read and deleted."""
    import tempfile

    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        return harness.load_json(path)
    finally:
        os.remove(path)


def traced(fn, device):
    """``harness.traced`` with the program's spans on around ``fn()``:
    ``(fn's result, the read trace, the Joined spans or None)``."""
    rec = recorder()
    if rec is not None:
        rec.drain()
        rec.enable()
    try:
        out, prof, window = harness._profiled(fn, device)
    finally:
        if rec is not None:
            rec.disable()
    t = time.perf_counter()
    doc = _chrome_doc(prof)
    events = doc.get("traceEvents", [])
    tr = harness.read_trace(events, window)
    joined = None
    if rec is not None:
        drained = rec.drain()
        joined = Joined(align(drained.spans,
                              int(doc.get("baseTimeNanoseconds", 0))),
                        read_links(events), drained.dropped)
    harness.log(f"trace and spans read in {time.perf_counter() - t:.2f} s")
    return out, tr, joined


# -- the probe: one cell's traced segment, spans off and on ---------------

# the span readers of each traffic kind's cells
NEW_READERS = {"epochs": ["issue_ms.train", "idle_host.train",
                          "launches.train", "device_ms.normal_eq",
                          "device_ms.spd_solve"],
               "passes": ["device_ms.select"]}

def _alignment(joined, kernels=("fused_gram", "spd_solve")) -> dict:
    """Whether each launch of the named kernels lies in a ``normal_eq`` or
    ``solve`` span, and the shifts of the spans (microseconds) that keep
    every such launch inside its span, over the first and the last tenth
    of the launches' stretch: 0 inside means the clocks agree there, and
    the change between the two is the drift."""
    want = {"fused_gram": "normal_eq", "spd_solve": "solve"}
    rows = []
    for name, _, _, sid, launch in joined.ops:
        kind = next((k for k in kernels if k in name), None)
        if kind is None or launch is None:
            continue
        span = joined.by_id.get(sid)
        rows.append((launch, span, span is not None
                     and span[0] == want[kind]))
    if not rows:
        return {"kernels": 0}
    t0 = min(r[0][0] for r in rows)
    t1 = max(r[0][0] for r in rows)

    def shifts(part):
        lo = max((la[1] - sp[2] for la, sp, ok in part if ok), default=None)
        hi = min((la[0] - sp[1] for la, sp, ok in part if ok), default=None)
        return None if lo is None else [lo * 1e6, hi * 1e6]

    tenth = (t1 - t0) / 10
    return {"kernels": len(rows), "inside": sum(ok for *_, ok in rows),
            "shift_us_first_tenth": shifts(
                [r for r in rows if r[0][0] <= t0 + tenth]),
            "shift_us_last_tenth": shifts(
                [r for r in rows if r[0][0] >= t1 - tenth]),
            "shift_us_all": shifts(rows), "stretch_s": t1 - t0}


def _span_cost(on: bool, n: int = 250, repeats: int = 200) -> float:
    """Seconds for ``n`` spans, nested two deep, with the program's spans
    off or on (the median of ``repeats`` timings; on, each timing drains
    what it recorded)."""
    from ycnr_tpu_torch.utils import profiling

    rec, span = profiling.RECORDER, profiling.span
    times = []
    for _ in range(repeats):
        if on:
            rec.enable()
        t = time.perf_counter()
        for _ in range(n // 2):
            with span("phase.user"):
                with span("normal_eq"):
                    pass
        times.append(time.perf_counter() - t)
        rec.disable()
        rec.drain()
    return sorted(times)[len(times) // 2]


def _gap_spans(tr, joined, top: int = 10) -> list:
    """The longest gaps with the innermost span at a tenth, the middle
    and nine tenths of each: ``[ms, [names]]``."""
    out = []
    for s, d in sorted(tr.gaps, key=lambda g: -g[1])[:top]:
        names = []
        for f in (0.1, 0.5, 0.9):
            inner = joined.at(s + f * d)
            names.append(inner[0] if inner else None)
        out.append([1e3 * d, names])
    return out


def _untraced(run, kind: str, seconds: float, turns: int) -> list:
    """Untraced stretches of ``seconds`` with the program's spans off and
    on, in turns: each unit's wall (ms), and with spans the mean ``epoch``
    or ``pass`` span (the host's issuing, ms)."""
    rec = recorder()
    unit = "epoch" if kind == "epochs" else "pass"
    rows = []
    for r in range(2 * turns):
        on = r % 2 == 1 and rec is not None
        if on:
            rec.drain()
            rec.enable()
        try:
            if kind == "epochs":
                n, t = run._epochs(seconds)
            else:
                n, _, t = run._passes(seconds)
        finally:
            if rec is not None:
                rec.disable()
        row = {"spans": on, "units": n, "unit_ms": 1e3 * t / n}
        if on:
            ns = [x.end_ns - x.start_ns for x in rec.drain().spans
                  if x.name == unit]
            row["issue_ms"] = 1e-6 * sum(ns) / len(ns)
        rows.append(row)
    return rows


def probe(spec, seed: int, device, window_s: float, repeats: int) -> dict:
    """One cell's set-up and a short window, then ``repeats`` traced
    segments with the program's spans off and as many on, in turns, each
    read by the cell's per-layer readers and its span readers. The
    traffic's own ``trace()`` runs as it is; with spans, its call of
    ``harness.traced`` goes to ``traced`` instead, and its context gets
    the ``Joined`` spans as ``ctx.spans``. Then untraced stretches with
    spans off and on, and the cost of 250 spans off and on."""
    import torch

    run = spec.kind.Run(spec, seed, device,
                        harness.Phases(time.perf_counter()), True)
    run.setup()
    harness.sync(device)
    run.window(window_s)
    readers = {m["name"]: harness.load_module(os.path.join(
        harness.HERE, "metrics", m["name"] + ".py")) for m in spec.per_layer}
    for name in NEW_READERS[spec.mix["kind"]]:
        readers[name] = harness.load_module(os.path.join(
            harness.HERE, "metrics", name + ".py"))
    plain = harness.traced
    rows = []
    for r in range(2 * repeats):
        on = r % 2 == 1
        got = {}
        if on:
            def with_spans(fn, dev, all_threads=False):
                out, tr, got["joined"] = traced(fn, dev)
                return out, tr
            harness.traced = with_spans
        try:
            ctx = run.trace()
        finally:
            harness.traced = plain
        ctx.spans = got.get("joined")
        row = {"spans": on, "units": ctx.units,
               "traced_wall_s": ctx.traced_wall_s,
               "unit_ms": 1e3 * ctx.traced_wall_s / ctx.units,
               "busy_s": ctx.trace.busy_s, "window_s": ctx.trace.window_s}
        row["metrics"] = {n: rd.read(ctx) for n, rd in readers.items()}
        row["breakdown"] = breakdown(ctx.trace, ctx.spans)
        if on:
            j = ctx.spans
            row["n_spans"] = len(j.spans)
            row["dropped"] = j.dropped
            row["ops"] = len(j.ops)
            row["ops_unattributed"] = sum(o[3] is None for o in j.ops)
            row["ops_unlinked"] = sum(o[4] is None for o in j.ops)
            row["span_counts"] = {}
            for s in j.spans:
                row["span_counts"][s[0]] = row["span_counts"].get(
                    s[0], 0) + 1
            row["alignment"] = _alignment(j)
            row["gap_spans"] = _gap_spans(ctx.trace, j)
        rows.append(row)
    untraced = _untraced(run, spec.mix["kind"], max(window_s / 2, 0.1),
                         repeats)
    cost = {"off": _span_cost(False), "on": _span_cost(True)}
    return {"workload": spec.name, "seed": seed,
            "card": (harness.power_limit()
                     if torch.device(device).type == "cuda" else "cpu"),
            "window_unit_ms": getattr(run, "epoch_ms", None),
            "cost_s_per_250_spans": cost, "rows": rows,
            "untraced": untraced}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--window", type=float, default=5.0,
                    help="seconds of untraced window before the traces")
    ap.add_argument("--repeats", type=int, default=3,
                    help="traced segments with the spans off, and as many "
                    "on, in turns")
    ap.add_argument("--out", default=None, help="also write the JSON here")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        harness.log("the probe measures the card; none is available")
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    res = probe(harness.cell_spec(args.workload), args.seed, device,
                args.window, args.repeats)
    text = json.dumps(res)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            f.write(text)
    print(text, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
