"""Dense normal-equation solve on the device with a Newton-refined inverse.

The CLI's simultaneous mode (``adjust --tpu``) and the per-block solves of
the sequential phased sweeps (``adjust --block1-phased --tpu``) need the
full inverse of the (unity-scaled) normals for variance propagation — the
reference's dpotrf+dpotri (Solve, dnaadjust.cpp:6586).  mm-level geodesy
demands float64-quality results; this module factors in float32 with the
Cholesky-inverse kernel (ops/chol_inv.py, one (1, n) system) and then
runs Newton–Schulz rounds for the inverse in float64,

    X <- X (2I - N X),

which square the residual R = N X - I each round.  N crosses to the
device once; the inverse and the corrections come back.

Port of the JAX package's ``parallel/dense_device.py::dense_solve_device``.
The JAX package factors this system with its jnp tiled recursion; here it
is the same hand-written kernel as the blocked path's level 1 on a CUDA
tensor, and its plain PyTorch version on a CPU tensor.

The rounds are residual-driven where the JAX package takes two fixed
ones.  Two suffice when the float32 inverse starts near kappa * 1e-7 of
the identity and kappa is small (the dense normals of a whole network).
The block-1 normals of the phased sweeps are weakly constrained: on a
10 x 10 network their scaled condition number is near 1.5e7, and two
rounds leave the solution about 1.5e-4 m off the float64 host solve.
So the rounds are those of the blocked path's refinement
(parallel/schur.py::_newton_loop): each reads max|I - N X| off the
product N X it forms anyway, in float64, and the loop goes on while a
round still halves it, from at least the two rounds of the JAX package
(so that where two suffice the solve does not stop short of them) to
12, the cap of the device refined solve.  It stops on the residual
alone, with no fixed tolerance: the residual's floor is about
kappa * 1e-16, so a tolerance such as 1e-12 would never be met on such
a block.  Unlike the blocked path's rounds, these do not symmetrise the
iterate after each round, as the JAX package's do not: on those block-1
normals a symmetrised iterate stalls near 5e-5 where the plain rounds
reach 4e-10 (the 10 x 10 network of tests/test_torch_block1.py, on a
CPU), so X is symmetrised once, at the end.

The float32 factor is the first try, not the only one.  When the kernel
flags a pivot that is not positive, or the Newton rounds end with the
residual above RESIDUAL_BOUND, the same scaled system is solved again on
the same device in float64 with the library Cholesky
(torch.linalg.cholesky_ex + torch.cholesky_inverse), then unscaled and
applied to the rhs as before.  A simulated 6 x 6 network's 21 x 21
block 1 (scaled condition number 2.0e9) needs it: its float32 factor
meets a non-positive pivot, and with a jittered retry the Newton rounds
stall near max|I - Ns X| = 0.5.  1e-6 lies far above every residual the
kernel route has reached on a card (block 1 at most 9.4e-10, the dense
1,600-station normals 1.3e-13) and far below that stall.  The record of
each solve names its route, and every fallback raises a
Float64FallbackWarning, so a network that leaves the kernel's route is
seen in every run, not absorbed; the adjustments count the fallbacks in
their result's profile ("f64_fallbacks").
"""

from __future__ import annotations

import warnings

import numpy as np
import torch
from torch.profiler import record_function

from ..ops.chol_inv import batched_cholesky_inverse

MIN_ROUNDS = 2
MAX_ROUNDS = 12
RESIDUAL_BOUND = 1e-6


class Float64FallbackWarning(RuntimeWarning):
    """A dense device solve left the float32 kernel's route for the
    float64 library factor."""


def _f64_inverse(Ns):
    """Float64 inverse of the scaled normals from the library Cholesky;
    raises torch.linalg.LinAlgError when Ns is not positive definite."""
    L, info = torch.linalg.cholesky_ex(Ns)
    X = torch.cholesky_inverse(L)
    if int(info) or not bool(torch.isfinite(X).all()):
        raise torch.linalg.LinAlgError(
            f"dense solve: the {Ns.shape[0]}x{Ns.shape[0]} normals are not "
            f"positive definite in float64")
    return X


def dense_solve_device(N, rhs, scale_to_unity: bool = True, device="cuda",
                       record=None):
    """Solve N dx = rhs and return (Ninv, dx) as float64 numpy arrays,
    both f64-quality, computed on `device`: the float32 kernel factor and
    Newton rounds, or the float64 library factor when that route fails
    (module docstring).  Raises torch.linalg.LinAlgError when the normals
    are not positive definite in float64 either.

    record: a list that gets {"n", "rounds", "residual", "route"} of this
    call appended: the Newton rounds taken (MIN_ROUNDS to MAX_ROUNDS, 0
    when the float32 factor met a non-positive pivot), the residual
    max|I - Ns X| after the last (Ns the scaled normals; NaN without a
    float32 factor), and the route of the returned inverse, "kernel" or
    "f64"; an "f64" record also holds "f64_residual", max|I - Ns X| of
    the float64 inverse.  The "f64" route also raises a
    Float64FallbackWarning."""
    from .schur import _newton_loop
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
        entry = {"n": int(n), "rounds": 0, "residual": float("nan"),
                 "route": "kernel"}
        if not int(status[0]):
            Linv = Linv[0]
            X = (Linv.transpose(0, 1) @ Linv).to(torch.float64)
            # Newton-Schulz X <- X (2I - Ns X) in float64, symmetrised
            # below (the iterates drift asymmetric at roundoff level)
            X, entry["rounds"], entry["residual"] = _newton_loop(
                X, Ns, torch.matmul, MAX_ROUNDS, 0.0, MIN_ROUNDS,
                symmetrise=False)
        del Linv
        if not entry["residual"] <= RESIDUAL_BOUND:
            with record_function("dta.dense_f64"):
                X = _f64_inverse(Ns)
                eye = torch.eye(n, dtype=torch.float64, device=dev)
                entry["route"] = "f64"
                entry["f64_residual"] = float((eye - Ns @ X).abs().max())
            warnings.warn(
                f"dense solve: the {n}x{n} normals took the float64 "
                f"fallback (float32 kernel residual {entry['residual']:.3e} "
                f"after {entry['rounds']} Newton rounds; float64 residual "
                f"{entry['f64_residual']:.3e})", Float64FallbackWarning,
                stacklevel=2)
        X = 0.5 * (X + X.transpose(0, 1))
        if s is not None:
            X = X * s[:, None] * s[None, :]
        dx = X @ rhs64
    if record is not None:
        record.append(entry)
    return (X.cpu().numpy().astype(np.float64, copy=False),
            dx.cpu().numpy().astype(np.float64, copy=False))
