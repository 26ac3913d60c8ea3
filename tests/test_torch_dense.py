"""The port's dense device solve (adjust --tpu) against the JAX package's.

parallel/dense_device.py::dense_solve_device of both packages on the CPU,
on a seeded SPD system with n = 300 whose diagonal spans six orders of
magnitude (the range station constraints give the normals), with and
without unity scaling: the Newton-refined inverse within 1e-10 relative
and the corrections within 1e-10 relative.  An indefinite system raises.
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from dynadjust_tpu.parallel.dense_device import dense_solve_device as jsolve
from dynadjust_tpu_torch.ops.chol_inv import batched_cholesky_inverse
from dynadjust_tpu_torch.parallel.dense_device import dense_solve_device


def _system(n, seed=0):
    rng = np.random.default_rng(seed)
    G = rng.normal(size=(2 * n, n))
    A = G.T @ G / (2 * n) + 0.5 * np.eye(n)
    d = 10.0 ** rng.uniform(-3, 3, n)
    return A * d[:, None] * d[None, :], rng.normal(size=n) * d


@pytest.mark.parametrize("scale", [True, False], ids=["unity", "unscaled"])
def test_dense_solve_matches_jax(scale):
    N, rhs = _system(300)
    if not scale:                    # unscaled Newton needs a tame system
        N, rhs = _system(300, seed=1)
        d = 1.0 / np.sqrt(np.diag(N))
        N = N * d[:, None] * d[None, :]
    launches = batched_cholesky_inverse.launches
    Xt, dxt = dense_solve_device(N, rhs, scale, device="cpu")
    assert batched_cholesky_inverse.launches == launches   # CPU: plain
    Xj, dxj = jsolve(N, rhs, scale)
    assert Xt.dtype == dxt.dtype == np.float64
    assert np.abs(Xt - Xj).max() / np.abs(Xj).max() < 1e-10
    assert np.abs(dxt - dxj).max() / np.abs(dxj).max() < 1e-10
    # and both are the float64 inverse
    Xref = np.linalg.inv(N)
    assert np.abs(Xt - Xref).max() / np.abs(Xref).max() < 1e-10
    assert np.abs(Xt - Xt.T).max() / np.abs(Xt).max() < 1e-15


def test_indefinite_system_raises():
    N, rhs = _system(130, seed=2)
    N[5, 5] = -N[5, 5]
    with pytest.raises(torch.linalg.LinAlgError):
        dense_solve_device(N, rhs, True, device="cpu")
