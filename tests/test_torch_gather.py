"""The port's row gather (``ops/row_gather.py``) against the JAX package's
five TPU gathers T1-T3, T5 and T6 (``tools/probe_gather.py``,
``tools/bench_pallas_gather.py``), run in Pallas interpret mode on the CPU.

The probes return f32 sums of what they gathered; the port's gather is
held to each sum within the f32 summation bound N 2^-24 sum|x| (the two
sum in different orders), and elementwise, exactly, to JAX's own
``table[idx]``. For T5 and T6 the TPU kernels' bodies are also called
directly (as the bench's ``--check`` does), and their rows must equal the
port's bit for bit. The bench's B is patched to 1,024 rows.
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from ycnr_tpu_torch.ops import row_gather as rg

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, W, M = 300, 64, 1024
DTYPES = {"bf16": (jnp.bfloat16, torch.bfloat16),
          "f32": (jnp.float32, torch.float32)}


def _load(name, rel):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, rel))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def probe():
    return _load("tpu_probe_gather", "tools/probe_gather.py")


@pytest.fixture
def bench(monkeypatch):
    mod = _load("tpu_bench_pallas_gather", "tools/bench_pallas_gather.py")
    monkeypatch.setattr(mod, "B", M)
    return mod


def _inputs(dname, seed=0, n=N, w=W, m=M):
    jdt, tdt = DTYPES[dname]
    rng = np.random.default_rng(seed)
    base = rng.normal(0, 1, (n, w)).astype(np.float32)
    idx = rng.integers(0, n, m).astype(np.int32)
    jt = jnp.asarray(base, jdt)
    tt = torch.as_tensor(base).to(tdt)
    np.testing.assert_array_equal(np.asarray(jt, np.float32),
                                  tt.float().numpy())  # same rounding
    return jt, jnp.asarray(idx), tt, torch.as_tensor(idx)


def _assert_sum(jax_sum, rows: torch.Tensor):
    """|JAX's f32 sum - the exact sum| <= N 2^-24 sum|x| (N terms)."""
    x = rows.double()
    exact = x.sum().item()
    tol = x.numel() * 2.0 ** -24 * x.abs().sum().item()
    assert abs(float(jax_sum) - exact) <= tol


@pytest.mark.parametrize("dname", ["bf16", "f32"])
@pytest.mark.parametrize("kernel", ["pallas_loop_gather",
                                    "pallas_take_gather"])
def test_row_gather_matches_t1_t2(probe, kernel, dname):
    jt, ji, tt, ti = _inputs(dname)
    with pltpu.force_tpu_interpret_mode():
        s = getattr(probe, kernel)(jt, ji, 512)()
    got = rg.row_gather(tt, ti)
    _assert_sum(s, got)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(jt[ji], np.float32))


@pytest.mark.parametrize("dname", ["bf16", "f32"])
def test_take_along_rows_matches_t3(probe, dname):
    jt, ji, tt, ti = _inputs(dname, seed=1)
    with pltpu.force_tpu_interpret_mode():
        s = probe.pallas_taa_gather(jt, ji, 512)()
    idx2 = ti[:, None].expand(M, W).contiguous()
    got = rg.take_along_rows(tt, idx2)
    _assert_sum(s, got)
    want = np.take_along_axis(np.asarray(jt, np.float32),
                              np.asarray(idx2), axis=0)
    np.testing.assert_array_equal(got.float().numpy(), want)


def _t5_t6_rows(bench, variant, jt, ji):
    """One launch of a T5/T6 kernel body, as the bench's --check runs it."""
    w = jt.shape[1]
    out_spec = pl.BlockSpec((bench.TILE, w), lambda t, *_: (t, 0),
                            memory_space=pltpu.VMEM)
    if variant == "vmem_take":
        grid_spec = pl.GridSpec(
            grid=(bench.B // bench.TILE,),
            in_specs=[pl.BlockSpec((bench.TILE,), lambda t: (t,),
                                   memory_space=pltpu.VMEM),
                      pl.BlockSpec(memory_space=pltpu.VMEM)],
            out_specs=out_spec)
        body = bench._vmem_take_kernel
    elif variant == "vmem_slice":
        grid_spec = pltpu.PrefetchScalarGridSpec(
            num_scalar_prefetch=1, grid=(bench.B // bench.TILE,),
            in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM)],
            out_specs=out_spec)
        body = bench._vmem_slice_kernel
    else:
        grid_spec = pltpu.PrefetchScalarGridSpec(
            num_scalar_prefetch=1, grid=(bench.B // bench.TILE,),
            in_specs=[pl.BlockSpec(memory_space=pl.ANY)],
            out_specs=out_spec,
            scratch_shapes=[pltpu.SemaphoreType.DMA((bench._DMA_K,))])
        body = bench._hbm_dma_kernel
    call = pl.pallas_call(body, grid_spec=grid_spec,
                          out_shape=jax.ShapeDtypeStruct((bench.B, w),
                                                         jt.dtype))
    return np.asarray(call(ji, jt), np.float32)


@pytest.mark.parametrize("variant", ["vmem_slice", "vmem_take", "hbm_dma"])
def test_row_gather_matches_t5_t6(bench, variant):
    steps = 2
    jt, ji, tt, ti = _inputs("bf16", seed=2)
    with pltpu.force_tpu_interpret_mode():
        if variant == "hbm_dma":
            s = bench.pallas_hbm_dma_gather(jt, ji, steps)
        else:
            s = bench.pallas_vmem_gather(jt, ji, steps,
                                         take=variant == "vmem_take")
        rows = _t5_t6_rows(bench, variant, jt, ji)
    # the probes gather (idx + k) % n at scan step k
    got = torch.cat([rg.row_gather(tt, (ti + k) % N) for k in range(steps)])
    _assert_sum(s, got)
    np.testing.assert_array_equal(rg.row_gather(tt, ti).float().numpy(),
                                  rows)
    np.testing.assert_array_equal(rg.row_gather(tt, ti).float().numpy(),
                                  np.asarray(jt[ji], np.float32))


@pytest.mark.parametrize("idx_dtype", [torch.int32, torch.int64])
def test_row_gather_takes_any_index_shape(idx_dtype):
    rng = np.random.default_rng(3)
    table = torch.as_tensor(rng.normal(size=(50, 6)))
    idx = torch.as_tensor(rng.integers(0, 50, (4, 3, 5))).to(idx_dtype)
    got = rg.row_gather(table, idx)
    assert got.shape == (4, 3, 5, 6)
    assert torch.equal(got, table[idx.long()])


def test_cuda_entries_refuse_cpu_tensors():
    """No fallback: the kernel entries raise for a CPU tensor."""
    table = torch.zeros(8, 4)
    idx = torch.zeros(3, dtype=torch.int32)
    with pytest.raises(ValueError):
        rg.row_gather_cuda(table, idx)
    with pytest.raises(ValueError):
        rg.take_along_rows_cuda(table, idx[:, None].expand(3, 4))
