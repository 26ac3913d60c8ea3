"""Per-block inner-station elimination: the level-1 factor of the Schur
solver.

The JAX package selects its level-1 factor with a backend switch
(``DTA_FACTOR_BACKEND``, default the jnp recursion of
``ops/recursive_inv.py``); here float32 takes one route: the
Cholesky-inverse of ``ops/chol_inv.py`` — the hand-written kernel on a
CUDA tensor, its plain PyTorch version on a CPU tensor.  Like the JAX
package, ``block_reduce`` keeps a float64 caller's precision (the nested
factors built with dtype float64); float64 goes through the library
Cholesky and triangular solve, as the JAX package's float64 route is its
jnp recursion, not its Pallas kernel.

Parity: the reference factors/inverts per-block normals with LAPACK
dpotrf/dpotri (dnamatrix_contiguous.cpp:963-1006); ``Linvᵀ Linv`` is the
same explicit inverse.
"""

from __future__ import annotations

import torch

from .chol_inv import fused_block_reduce, reduce_from_linv


def _block_reduce_f64(Nii, Nij, Njj):
    L = torch.linalg.cholesky(Nii)
    eye = torch.eye(Nii.shape[-1], dtype=Nii.dtype, device=Nii.device)
    Linv = torch.linalg.solve_triangular(L, eye.expand_as(L), upper=False)
    return reduce_from_linv(Linv, Nij, Njj)


def block_reduce(Nii, Nij, Njj):
    """Per-block inner-station elimination from blocked normals:

        Ainv = Nii^-1;  Y = Ainv Nij;  S_b = Njj − Nijᵀ Y

    float64 inputs stay float64 (library Cholesky); everything else is
    factored in float32.  A float32 block whose factorization meets a
    non-positive pivot (float32 assembly noise on a nearly singular
    block) is factored again as Nii + c·I with c at the float32 noise
    floor — the policy of ``recursive_inv.spd_inverse_rec_safe``; the
    float64 residual refinement absorbs the perturbation.  A block that
    fails again raises."""
    if Nii.dtype == torch.float64:
        return _block_reduce_f64(Nii, Nij, Njj)
    Ainv, Y, S, status = fused_block_reduce(Nii, Nij, Njj)
    bad = torch.nonzero(status).flatten()
    if bad.numel():
        Nb = Nii[bad].to(torch.float32)
        n = Nb.shape[-1]
        c = (8.0 * n) * torch.finfo(torch.float32).eps * \
            Nb.abs().amax(dim=(-2, -1), keepdim=True)
        eye = torch.eye(n, dtype=Nb.dtype, device=Nb.device)
        A2, Y2, S2, st2 = fused_block_reduce(Nb + c * eye, Nij[bad],
                                             Njj[bad])
        if bool(st2.any()):
            raise torch.linalg.LinAlgError(
                f"level-1 blocks {bad.tolist()} are not positive definite")
        Ainv[bad], Y[bad], S[bad] = A2, Y2, S2
    return Ainv, Y, S
