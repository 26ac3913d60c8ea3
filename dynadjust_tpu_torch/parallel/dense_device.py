"""Dense normal-equation solve on the device with a Newton-refined inverse.

The CLI's simultaneous mode (``adjust --tpu``) needs the full inverse of
the (unity-scaled) normals for variance propagation — the reference's
dpotrf+dpotri (Solve, dnaadjust.cpp:6586).  mm-level geodesy demands
float64-quality results; this module factors in float32 with the
Cholesky-inverse kernel (ops/chol_inv.py, one (1, n) system) and then
runs Newton iterations for the inverse in float64,

    X <- X (2I - N X),

which squares the relative error each step: ~kappa*1e-7 after the f32
inverse, ~1e-13 after two steps for unity-scaled normals.  N crosses to
the device once; the inverse and the corrections come back.

Port of the JAX package's ``parallel/dense_device.py::dense_solve_device``.
The JAX package factors this system with its jnp tiled recursion; here it
is the same hand-written kernel as the blocked path's level 1 on a CUDA
tensor, and its plain PyTorch version on a CPU tensor.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.profiler import record_function

from ..ops.chol_inv import batched_cholesky_inverse


def dense_solve_device(N, rhs, scale_to_unity: bool = True,
                       newton: int = 2, device="cuda"):
    """Solve N dx = rhs and return (Ninv, dx) as float64 numpy arrays,
    both f64-quality, computed on `device`.  Raises
    torch.linalg.LinAlgError when the float32 factor meets a pivot that
    is not positive."""
    dev = torch.device(device)
    N64 = torch.as_tensor(np.asarray(N, dtype=np.float64), device=dev)
    rhs64 = torch.as_tensor(np.asarray(rhs, dtype=np.float64), device=dev)
    n = N64.shape[0]
    with record_function("dta.dense_solve"):
        if scale_to_unity:
            s = 1.0 / torch.sqrt(torch.diagonal(N64))
            Ns = N64 * s[:, None] * s[None, :]
        else:
            s = None
            Ns = N64
        with record_function("dta.chol_inv"):
            Linv, status = batched_cholesky_inverse(
                Ns.to(torch.float32)[None])
        if int(status[0]):
            raise torch.linalg.LinAlgError(
                f"dense solve: the float32 Cholesky factor of the {n}x{n} "
                f"normals met a pivot that is not positive")
        Linv = Linv[0]
        X = (Linv.transpose(0, 1) @ Linv).to(torch.float64)
        del Linv
        eye2 = 2.0 * torch.eye(n, dtype=torch.float64, device=dev)
        for _ in range(newton):
            # Newton-Schulz: X <- X (2I - Ns X), float64
            X = X @ (eye2 - Ns @ X)
        # symmetrise (Newton iterates drift asymmetric at roundoff level)
        X = 0.5 * (X + X.transpose(0, 1))
        if s is not None:
            X = X * s[:, None] * s[None, :]
        dx = X @ rhs64
    return (X.cpu().numpy().astype(np.float64, copy=False),
            dx.cpu().numpy().astype(np.float64, copy=False))
