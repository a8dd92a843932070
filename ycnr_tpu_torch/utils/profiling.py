"""Tracing / profiling hooks (counterpart of ``ycnr_tpu/utils/profiling.py``).

``span`` marks a layer of the program (an epoch, a phase, a block's normal
equations, a serving pass's scoring) on the host's clock. Spans are off
unless ``enable`` turns them on: then each one records its name, its start
and end (``time.time_ns()``, the clock of the profiler's own events), its
id, its parent's id (the innermost span open on the same thread) and the id
of its root, so every span of one epoch or one pass shares an identifier.
``drain`` hands over what was recorded. A span neither synchronizes the
device nor launches anything, so turning spans on changes no launch, only
the host's time between launches.

``trace`` writes a ``torch.profiler`` Chrome trace (open it in Perfetto or
``chrome://tracing``) with the block's spans in it, on the trace's own time
base; ``device_sync`` waits for a tensor and returns its sum, as the JAX
package's does.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import threading
import time
from typing import List, NamedTuple, Optional

import torch

SPAN_CAP = 1 << 18  # spans kept between two drains; the rest are counted
SPAN_CATEGORY = "ycnr_span"  # the Chrome trace category of spans


def device_sync(x) -> float:
    """Wait for everything producing ``x`` (``torch.cuda.synchronize`` on
    its device) and return its sum as a float, the JAX package's
    checksum."""
    t = torch.as_tensor(x)
    if t.is_cuda:
        torch.cuda.synchronize(t.device)
    return float(t.sum())


def thread_id() -> int:
    """The calling thread's id as ``torch.profiler`` files the CUDA calls
    of a thread whose operators it does not record: the low 32 bits of
    its ``pthread_self`` (CPython's ``threading.get_ident``) read as a
    signed number, without the sign."""
    low = threading.get_ident() & 0xFFFFFFFF
    return low if low < 1 << 31 else (1 << 32) - low


class SpanRecord(NamedTuple):
    """One closed span. Times are ``time.time_ns()``; ``parent`` is None
    for a root, whose ``root`` is its own ``id``; ``thread`` is
    ``thread_id()``."""

    name: str
    start_ns: int
    end_ns: int
    id: int
    parent: Optional[int]
    root: int
    thread: int


class Drained(NamedTuple):
    """What ``drain`` hands over: the spans closed since the last drain,
    in the order they closed, and how many more were dropped at the
    cap."""

    spans: List[SpanRecord]
    dropped: int


class _NoSpan:
    """The one object ``span`` returns while spans are off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return False


_NO_SPAN = _NoSpan()


class _Opener:
    """A thread's context manager for its spans: ``span(name)`` hands it
    the name, and the ``with`` statement opens and closes the span. One
    object a thread, reused, keeps the recording path free of
    allocations but the record itself."""

    __slots__ = ("_rec", "_open", "_thread", "name")

    def __init__(self, rec):
        self._rec = rec
        self._open = []  # (id, root, name, start_ns) of the open spans
        self._thread = thread_id()
        self.name = None

    def __enter__(self):
        sid = next(self._rec._ids)
        opened = self._open
        root = opened[-1][1] if opened else sid
        opened.append((sid, root, self.name, time.time_ns()))
        return self

    def __exit__(self, exc_type, exc, tb):
        end = time.time_ns()
        opened = self._open
        sid, root, name, start = opened.pop()
        rec = self._rec
        if len(rec._closed) < rec.cap:
            rec._closed.append((name, start, end, sid,
                                opened[-1][0] if opened else None, root,
                                self._thread))
        else:
            rec._dropped += 1
        return False


class SpanRecorder:
    """Spans of one process, kept in memory until drained.

    ``span(name)`` is a context manager, to be entered where it is made
    (``with rec.span("solve"): ...``). Off (the default), it returns one
    shared object that does nothing: no allocation, no clock read. On, it
    records a ``SpanRecord`` when the block closes; about ``cap`` are kept
    between two drains (threads that close spans at the same moment may
    each add one more), and the rest are counted as dropped."""

    def __init__(self, cap: int = SPAN_CAP):
        self.cap = int(cap)
        self.on = False
        self._ids = itertools.count(1)
        self._local = threading.local()
        self._closed = []
        self._dropped = 0

    def span(self, name: str):
        if not self.on:
            return _NO_SPAN
        try:
            op = self._local.opener
        except AttributeError:
            op = self._local.opener = _Opener(self)
        op.name = name
        return op

    def enable(self):
        self.on = True

    def disable(self):
        """Stop recording new spans; a span open now still records when
        it closes."""
        self.on = False

    def drain(self) -> Drained:
        """The spans closed since the last drain, and the count dropped at
        the cap; both start again from nothing."""
        closed, self._closed = self._closed, []
        dropped, self._dropped = self._dropped, 0
        return Drained([SpanRecord(*r) for r in closed], dropped)


RECORDER = SpanRecorder()  # the program's spans


# ``with span("normal_eq"): ...`` marks a layer on the program's recorder
span = RECORDER.span
enable = RECORDER.enable
disable = RECORDER.disable
drain = RECORDER.drain


def chrome_span_events(spans, base_ns: int = 0, tids=None) -> list:
    """Spans as Chrome trace ``"X"`` events of category ``ycnr_span``, in
    microseconds since ``base_ns`` (a trace's ``baseTimeNanoseconds``:
    ``torch.profiler`` writes its events' ``time.time_ns()`` less that
    base), each on its thread's row (``tids`` maps a span's ``thread`` to
    another row)."""
    pid, tids = os.getpid(), tids or {}
    return [{"ph": "X", "cat": SPAN_CATEGORY, "name": s.name,
             "ts": (s.start_ns - base_ns) / 1e3,
             "dur": (s.end_ns - s.start_ns) / 1e3,
             "pid": pid, "tid": tids.get(s.thread, s.thread),
             "args": {"id": s.id, "parent": s.parent, "root": s.root}}
            for s in spans]


def _add_spans(path: str, spans) -> None:
    """Append ``spans`` to the Chrome trace at ``path``. The profiler
    records the operators of the thread that runs it, and files that
    thread's CUDA calls under its native id, so its spans go there too."""
    with open(path) as f:
        doc = json.load(f)
    doc.setdefault("traceEvents", []).extend(chrome_span_events(
        spans, int(doc.get("baseTimeNanoseconds", 0)),
        {thread_id(): threading.get_native_id()}))
    with open(path, "w") as f:
        json.dump(doc, f)


@contextlib.contextmanager
def trace(log_dir: str):
    """``torch.profiler`` trace of the block (the CPU, and the card when
    there is one), written as a Chrome trace into ``log_dir``, with the
    program's spans recorded in the block as events of category
    ``ycnr_span``. A profiler that cannot start, or a directory that
    cannot be written, leaves the block running untraced, as the JAX
    package's trace does."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = None
    try:
        os.makedirs(log_dir, exist_ok=True)
        prof = torch.profiler.profile(activities=acts)
        prof.__enter__()
    except (OSError, RuntimeError):
        prof = None
    was_on = RECORDER.on
    if prof is not None:
        RECORDER.enable()
    try:
        yield
    finally:
        if prof is not None:
            if not was_on:
                RECORDER.disable()
            spans = RECORDER.drain().spans
            path = os.path.join(log_dir, f"trace-{os.getpid()}.json")
            try:
                prof.__exit__(None, None, None)
                prof.export_chrome_trace(path)
                _add_spans(path, spans)
            except (OSError, RuntimeError, ValueError):
                pass
