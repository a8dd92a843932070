"""fused_gram's split path on the CPU: the bytes its counters give for the
Netflix-like rungs at w 256, the wrapper's counters and ``part_sum`` span
through a stand-in for the kernel, the ``part_sum_mb.normal_eq`` reader on
a hand-built trace, and a rank-256 ALS-WR epoch of the port's plain path
with bf16 gathers against the benchmark's wide reference
(``portbench/reference/als_wr_wide.py``; its f32-gather case and its
float64 equality with ``als_wr.py`` are ``portbench/tests/
test_portbench_wide.py``'s). The kernel itself runs on the card
(``test_torch_cuda.py``)."""

import ctypes
import os
from types import SimpleNamespace

import pytest
import torch

from portbench import harness
from portbench.tests import wide_epoch
from ycnr_tpu_torch.ops import fused_gram as fg
from ycnr_tpu_torch.utils import profiling as prof

torch.set_num_threads(1)

W = 256


@pytest.mark.parametrize("ne,R,parts,r_part,moved", [
    # a long-list item block: 8 entities cut into 33 parts of 3,031 slots,
    # each part's f32 A and b (263,168 bytes at w 256) written and read
    (8, 100_000, 33, 3031, 138_952_704),
    # a mid rung: 192 entities, two parts of 512
    (192, 1024, 2, 512, 202_113_024),
    # at the fill, or lists too short to cut: no partials
    (264, 100_000, 1, 100_000, 0),
    (8, 511, 1, 511, 0),
])
def test_part_bytes_of_the_netflix_rungs(ne, R, parts, r_part, moved):
    assert fg.fill_blocks(W) == 264
    assert fg._parts(ne, R, fg.fill_blocks(W)) == (parts, r_part)
    assert fg.part_bytes_of(ne, parts, W) == moved


class _Kernel:
    """Stands in for ``ycnr_fused_gram``: zeroes every partial A and b it
    is given, so the wrapper's sum and ridge are all that is left."""

    def __init__(self):
        self.calls = []

    def ycnr_fused_gram(self, table, idx, rat, reg, A, b, ne, R, s, r_part,
                        w, n, is64, stream):
        ctypes.memset(A, 0, ne * s * w * w * 4)
        ctypes.memset(b, 0, ne * s * w * 4)
        self.calls.append((ne, R, s, reg is not None))
        return 0


@pytest.fixture
def stand_in(monkeypatch):
    lib = _Kernel()
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda t: True))
    monkeypatch.setattr(fg._build, "load_library", lambda: lib)
    monkeypatch.setattr(fg._build, "stream", lambda dev: 0)
    for name in ("launches", "split_launches", "part_bytes"):
        monkeypatch.setattr(fg, name, 0)
    prof.drain()
    prof.enable()
    try:
        yield lib
    finally:
        prof.disable()
        prof.drain()


def _call(ne, R, n=40):
    table = torch.zeros(n + 1, W, dtype=torch.bfloat16)
    idx = torch.full((ne, R), n, dtype=torch.int64)
    rat = torch.zeros(ne, R, dtype=torch.bfloat16)
    reg = torch.arange(1, ne + 1, dtype=torch.float32)
    with prof.span("normal_eq"):
        A, b = fg.fused_gram_cuda(table, idx, rat, reg)
    return reg, A, b


@pytest.mark.parametrize("ne,R", [(8, 3000), (3, 600), (264, 3000),
                                  (8, 300)])
def test_split_calls_count_their_partials_and_span_the_sum(stand_in, ne, R):
    """A call cut into s > 1 parts counts one split launch and its
    partials' bytes, and sums them inside a ``part_sum`` span nested in
    the block's ``normal_eq``, the ridge added once after the sum; a call
    of one part counts neither and opens no span."""
    s = fg._parts(ne, R, fg.fill_blocks(W))[0]
    reg, A, b = _call(ne, R)
    assert stand_in.calls == [(ne, R, s, s == 1)]
    assert fg.launches == 1
    assert fg.split_launches == int(s > 1)
    assert fg.part_bytes == fg.part_bytes_of(ne, s, W)
    spans = prof.drain().spans
    sums = [x for x in spans if x.name == "part_sum"]
    (outer,) = [x for x in spans if x.name == "normal_eq"]
    assert len(sums) == int(s > 1)
    assert all(x.parent == outer.id for x in sums)
    if s > 1:  # the kernel took no ridge: the wrapper adds it once
        assert torch.equal(A, reg[:, None, None] * torch.eye(W))
        assert not b.any()


def _reader(name):
    return harness.load_module(os.path.join(harness.HERE, "metrics",
                                            name + ".py"))


def _ev(name, ts, dur, cat="kernel"):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


def _trace():
    """Two traced epochs of three fused_gram launches (both bodies'
    names), K1 and a sum between them."""
    ev = [_ev("cudaLaunchKernel", 1000.0, 1.0, "cuda_runtime")]
    for e in range(2):
        t = 1000.0 + 40 * e
        ev += [_ev("void fused_gram_wide_kernel<4, long>", t, 5),
               _ev("void fused_gram_wide_kernel<4, long>", t + 5, 5),
               _ev("void reduce_kernel<128, 4>", t + 10, 3),
               _ev("void fused_gram_kernel<4, long, false>", t + 13, 5),
               _ev("void spd_solve_tiled_kernel<8>", t + 18, 10)]
    return harness.read_trace(ev, 100e-6)


@pytest.mark.parametrize("counters,units,traced,want", [
    # 3 launches an epoch at 1.5e6 partial bytes a launch
    ({"launches": 40, "part_bytes": 60_000_000}, 2, True, 4.5),
    ({"launches": 40, "part_bytes": 0}, 2, True, 0.0),
    # no launch yet, no traced epoch, no trace, or a program without the
    # counter (an older program)
    ({"launches": 0, "part_bytes": 0}, 2, True, None),
    ({"launches": 40, "part_bytes": 60_000_000}, 0, True, None),
    ({"launches": 40, "part_bytes": 60_000_000}, 2, False, None),
    ({"launches": 40}, 2, True, None),
])
def test_part_sum_reader_on_a_hand_built_trace(monkeypatch, counters, units,
                                               traced, want):
    monkeypatch.setattr(fg, "launches", counters["launches"])
    if "part_bytes" in counters:
        monkeypatch.setattr(fg, "part_bytes", counters["part_bytes"])
    else:
        monkeypatch.delattr(fg, "part_bytes")
    ctx = SimpleNamespace(trace=_trace() if traced else None, units=units)
    got = _reader("part_sum_mb.normal_eq").read(ctx)
    assert got == (None if want is None else pytest.approx(want))


@pytest.mark.parametrize("bf16,limit", wide_epoch.GATHERS[1:],
                         ids=wide_epoch.GATHER_IDS[1:])
def test_rank256_epoch_matches_the_wide_reference(bf16, limit):
    """portbench's rank-256 case of ``test_one_epoch_matches_the_port``
    with the main path's bf16 gathers: one ALS-WR epoch of the port's
    plain path within the limit of the wide reference, fp8 gathers more
    than three times away."""
    wide_epoch.check_one_epoch(wide_epoch.make_data(), bf16, limit)
