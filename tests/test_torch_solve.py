"""Port's guarded batched solve (K1's plain version on the CPU) vs the JAX
package's solve paths, on the same NumPy systems."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ycnr_tpu.ops.gram import guarded_batched_solve as j_solve
from ycnr_tpu.ops.pallas_solve import pallas_spd_solve
from ycnr_tpu_torch.ops import spd_solve as sp
from ycnr_tpu_torch.ops.gram import guarded_batched_solve as t_solve

torch.set_num_threads(1)


def _normal_eqs(B, n, seed):
    """Gram of a few gathered rows (rank-deficient) + counts, with some
    empty (cnt == 0) padding slots: A = 0, b = 0."""
    rng = np.random.default_rng(seed)
    R = 6
    cnt = rng.integers(0, R + 1, B)
    cnt[:3] = 0
    F = rng.normal(size=(B, R, n))
    F[np.arange(R)[None, :] >= cnt[:, None]] = 0
    r = rng.normal(3, 1, (B, R)) * (np.arange(R)[None, :] < cnt[:, None])
    A = np.einsum("brk,brm->bkm", F, F)
    b = np.einsum("brk,br->bk", F, r)
    return A, b, cnt.astype(np.float64)


@pytest.mark.parametrize("n", [4, 10, 64])
def test_guarded_solve_matches_jax_xla_f64(n):
    A, b, cnt = _normal_eqs(40, n, seed=n)
    reg = 0.05 * cnt + (cnt == 0)
    xj = np.asarray(j_solve(jnp.asarray(A), jnp.asarray(b),
                            jnp.asarray(reg), method="xla"))
    xt = t_solve(torch.as_tensor(A), torch.as_tensor(b),
                 torch.as_tensor(reg)).numpy()
    np.testing.assert_allclose(xt, xj, rtol=1e-9, atol=1e-9)
    assert np.all(xt[cnt == 0] == 0)  # guard rows solve to exactly 0


@pytest.mark.parametrize("n", [8, 10, 16])
def test_plain_solve_matches_pallas_interpret_f32(n):
    rng = np.random.default_rng(n)
    M = rng.normal(size=(24, n, n))
    A = (np.einsum("bij,bkj->bik", M, M) / n + 0.1 * np.eye(n)).astype(
        np.float32)
    b = rng.normal(size=(24, n)).astype(np.float32)
    xp = np.asarray(pallas_spd_solve(jnp.asarray(A), jnp.asarray(b),
                                     batch_tile=8, interpret=True))
    xt = sp.spd_solve(torch.as_tensor(A), torch.as_tensor(b)).numpy()
    np.testing.assert_allclose(xt, xp, rtol=1e-4, atol=1e-4 * np.abs(xp).max())


def test_identity_rows_exactly_zero_and_no_launch_on_cpu():
    before = sp.launches
    n = 16
    A = torch.eye(n).repeat(8, 1, 1)
    b = torch.zeros(8, n)
    x = sp.spd_solve(A, b)
    assert torch.all(x == 0)
    x = t_solve(torch.zeros(8, n, n), b, torch.ones(8))  # guard rows
    assert torch.all(x == 0)
    assert sp.launches == before  # the CPU never reaches K1


def test_cuda_wrapper_refuses_cpu_tensors():
    A = torch.eye(4).repeat(2, 1, 1)
    with pytest.raises(ValueError):
        sp.spd_solve_cuda(A, torch.zeros(2, 4))
