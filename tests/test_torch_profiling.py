"""The port's tracing / profiling hooks (``ycnr_tpu_torch/utils``) on the
CPU: the cases of ``tests/test_profiling.py``, and the checksum held to the
JAX package's ``device_sync`` on the same arrays."""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ycnr_tpu.utils import profiling as jprof
from ycnr_tpu_torch.utils.profiling import device_sync, phase_timer, trace


def test_phase_timer_records_and_syncs(capsys):
    stats = {}
    x = torch.arange(8.0)
    with phase_timer("p1", stats, sync_on=lambda: x, echo=False):
        y = x * 2
    assert "p1" in stats and stats["p1"] >= 0.0
    with phase_timer("p2", stats, sync_on=y):
        pass
    assert "p2" in stats
    assert "[phase] p2" in capsys.readouterr().err


def test_phase_timer_without_a_target_times_the_host(capsys):
    stats = {}
    with phase_timer("host", stats, echo=False):
        torch.ones(4).sum()
    assert stats["host"] >= 0.0 and capsys.readouterr().err == ""


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
