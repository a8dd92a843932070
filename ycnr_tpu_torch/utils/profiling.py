"""Tracing / profiling hooks (counterpart of ``ycnr_tpu/utils/profiling.py``).

``trace`` writes a ``torch.profiler`` Chrome trace (open it in Perfetto or
``chrome://tracing``); ``phase_timer`` times a phase with a real device
sync at its end: on the card by CUDA events around the phase, on the CPU
by the host clock; ``device_sync`` waits for a tensor and returns its sum,
as the JAX package's does.
"""

from __future__ import annotations

import contextlib
import os
import sys
import time
from typing import Optional

import torch


def device_sync(x) -> float:
    """Wait for everything producing ``x`` (``torch.cuda.synchronize`` on
    its device) and return its sum as a float, the JAX package's
    checksum."""
    t = torch.as_tensor(x)
    if t.is_cuda:
        torch.cuda.synchronize(t.device)
    return float(t.sum())


@contextlib.contextmanager
def phase_timer(name: str, result_holder: Optional[dict] = None,
                sync_on=None, echo: bool = True):
    """Time a phase, in seconds, into ``result_holder[name]``.

    with phase_timer("u_phase", stats, sync_on=lambda: state.U):
        state = u_phase(state, ...)

    ``sync_on`` (a tensor, or a callable giving one at the phase's end)
    names what the phase produces. On the card the phase is timed by CUDA
    events on the current stream, the end event waited for; on the CPU,
    and without ``sync_on``, by the host clock (with ``device_sync``)."""
    t0 = time.time()
    start = None
    if sync_on is not None and torch.cuda.is_available():
        start = torch.cuda.Event(enable_timing=True)
        start.record()
    yield
    target = None
    if sync_on is not None:
        target = sync_on() if callable(sync_on) else sync_on
    if start is not None and isinstance(target, torch.Tensor) \
            and target.is_cuda:
        end = torch.cuda.Event(enable_timing=True)
        end.record()
        end.synchronize()
        dt = start.elapsed_time(end) / 1e3
    else:
        if target is not None:
            device_sync(target)
        dt = time.time() - t0
    if result_holder is not None:
        result_holder[name] = dt
    if echo:
        print(f"[phase] {name}: {dt * 1000:.1f} ms", file=sys.stderr)


@contextlib.contextmanager
def trace(log_dir: str):
    """``torch.profiler`` trace of the block (the CPU, and the card when
    there is one), written as a Chrome trace into ``log_dir``. A profiler
    that cannot start, or a directory that cannot be written, leaves the
    block running untraced, as the JAX package's trace does."""
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
    try:
        yield
    finally:
        if prof is not None:
            try:
                prof.__exit__(None, None, None)
                prof.export_chrome_trace(
                    os.path.join(log_dir, f"trace-{os.getpid()}.json"))
            except (OSError, RuntimeError):
                pass
