"""Batched Cholesky factor + triangular inverse: the level-1 factor.

Port of the Pallas TPU kernel ``dynadjust_tpu/ops/pallas_schur.py``
(``_chol_inv_kernel`` via ``_chol_inverse_jit``; wrappers
``batched_cholesky_inverse`` and ``fused_block_reduce``).  For a (B, n, n)
float32 SPD batch it computes Linv = chol(Nii)^-1; ``fused_block_reduce``
then forms the explicit inverse Ainv = Linvᵀ Linv (the reference's
dpotrf+dpotri, dnamatrix_contiguous.cpp:963-1006), W = Linv Nij,
Y = Linvᵀ W and the Schur piece S = Njj − Wᵀ W as plain float32 matmuls,
as the JAX package forms them outside its kernel.

On a CUDA tensor the factorization is the hand-written kernel of
``csrc/chol_inv.cu`` (128-wide steps, 3xTF32 tensor-core tile products,
a recursive triangular inverse; see its header for the design and what
bounds it); on a CPU tensor it is ``cholesky_inverse_plain``: a
right-looking blocked Cholesky over 64-wide tiles followed by block-row
forward substitution, in PyTorch operations.  Any other device raises.
Each route pads the ragged edge to a multiple of its own tile (the
kernel reports its tile through ``dta_chol_inv_tile``) with an identity
diagonal (pallas_schur.py:157-160), so n need not be a tile multiple,
and unlike the TPU kernel (``MAX_NI = 896``) there is no size cap: the
tiles live in device memory.

Both versions also return one int32 status per block, set when a pivot is
not positive or is NaN — the signal ``blocked_chol.block_reduce`` uses
for its jittered retry.
"""

from __future__ import annotations

import ctypes

import torch
from torch.profiler import record_function

TILE = 64           # the plain version's tile; the kernel reports its own


def _pad_identity(Nii: torch.Tensor, t: int = TILE) -> torch.Tensor:
    """Fresh contiguous float32 copy padded to a multiple of t, identity on
    the padded rows (both versions overwrite it).  The padded columns of
    the first n0 rows are left unset: both versions read only the lower
    triangle."""
    B, n0 = Nii.shape[0], Nii.shape[1]
    n = -(-n0 // t) * t
    A = torch.empty((B, n, n), dtype=torch.float32, device=Nii.device)
    A[:, :n0, :n0] = Nii
    if n != n0:
        A[:, n0:, :] = 0.0
        A.diagonal(dim1=1, dim2=2)[:, n0:] = 1.0
    return A


def _factor_tile_plain(D: torch.Tensor):
    """(L, L^-1, bad) of a batch of (T, T) SPD tiles: column-by-column
    Cholesky, then forward substitution."""
    D = D.clone()
    B, T = D.shape[0], D.shape[1]
    bad = torch.zeros(B, dtype=torch.bool, device=D.device)
    for j in range(T):
        piv = D[:, j, j].clone()
        bad |= ~(piv > 0)
        d = torch.sqrt(piv)
        D[:, j, j] = d
        col = D[:, j + 1:, j] / d[:, None]
        D[:, j + 1:, j] = col
        D[:, j + 1:, j + 1:] -= col[:, :, None] * col[:, None, :]
    L = torch.tril(D)
    X = torch.zeros_like(L)
    eye = torch.eye(T, dtype=L.dtype, device=L.device)
    for i in range(T):
        acc = eye[i] - torch.einsum("bm,bmc->bc", L[:, i, :i], X[:, :i, :])
        X[:, i, :] = acc / L[:, i, i, None]
    return L, X, bad


def cholesky_inverse_plain(Nii: torch.Tensor):
    """Plain PyTorch version of the kernel: (Linv (B, n, n) f32,
    status (B,) int32)."""
    B, n0 = Nii.shape[0], Nii.shape[1]
    A = _pad_identity(Nii)
    n = A.shape[1]
    nt = n // TILE
    Linv = torch.zeros_like(A)
    status = torch.zeros(B, dtype=torch.int32, device=A.device)
    for k in range(nt):
        s = slice(k * TILE, (k + 1) * TILE)
        L, X, bad = _factor_tile_plain(A[:, s, s])
        A[:, s, s] = L
        Linv[:, s, s] = X
        status |= bad.to(torch.int32)
        if k + 1 < nt:
            r = slice((k + 1) * TILE, n)
            P = A[:, r, s] @ X.transpose(1, 2)
            A[:, r, s] = P
            A[:, r, r] -= P @ P.transpose(1, 2)
    for i in range(1, nt):
        ri = slice(i * TILE, (i + 1) * TILE)
        acc = A[:, ri, :i * TILE] @ Linv[:, :i * TILE, :i * TILE]
        Linv[:, ri, :i * TILE] = -(Linv[:, ri, ri] @ acc)
    return Linv[:, :n0, :n0], status


def _launch(Nii: torch.Tensor):
    from .kernels import library
    lib = library("chol_inv")
    lib.dta_chol_inv.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                 ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                                 ctypes.c_void_p]
    lib.dta_chol_inv.restype = ctypes.c_int
    lib.dta_chol_inv_tile.restype = ctypes.c_int
    B, n0 = Nii.shape[0], Nii.shape[1]
    with torch.cuda.device(Nii.device):
        A = _pad_identity(Nii, lib.dta_chol_inv_tile())
        Linv = torch.empty_like(A)          # the kernel writes all of it
        status = torch.zeros(B, dtype=torch.int32, device=A.device)
        stream = torch.cuda.current_stream(A.device).cuda_stream
        err = lib.dta_chol_inv(A.data_ptr(), Linv.data_ptr(),
                               status.data_ptr(), B, A.shape[1], stream)
    if err:
        raise RuntimeError(f"chol_inv kernel launch failed: CUDA error {err}")
    batched_cholesky_inverse.launches += 1
    shapes = batched_cholesky_inverse.shapes
    shapes[(B, n0)] = shapes.get((B, n0), 0) + 1
    return Linv[:, :n0, :n0], status


def batched_cholesky_inverse(Nii: torch.Tensor):
    """(B, n, n) SPD -> (Linv = chol(Nii)^-1 float32, status (B,) int32).

    CUDA tensors run the kernel (and count one launch in
    ``batched_cholesky_inverse.launches``, and one in its
    ``shapes[(B, n)]``); CPU tensors run the plain version; other devices
    raise."""
    if Nii.ndim != 3 or Nii.shape[1] != Nii.shape[2]:
        raise ValueError(f"expected a (B, n, n) batch, got {tuple(Nii.shape)}")
    if Nii.device.type == "cuda":
        return _launch(Nii)
    if Nii.device.type == "cpu":
        return cholesky_inverse_plain(Nii)
    raise ValueError(f"unsupported device {Nii.device}")


batched_cholesky_inverse.launches = 0
batched_cholesky_inverse.shapes = {}


def reduce_from_linv(Linv, Nij, Njj):
    """(Ainv, Y, S) from the triangular inverse: matmuls in Linv's dtype.
    Njj need not be positive definite (the nested level 2 passes zeros)."""
    dt = Linv.dtype
    W = Linv @ Nij.to(dt)
    Ainv = Linv.transpose(1, 2) @ Linv
    Y = Linv.transpose(1, 2) @ W
    S = Njj.to(dt) - W.transpose(1, 2) @ W
    return Ainv, Y, S


def fused_block_reduce(Nii, Nij, Njj):
    """Per-block inner-station elimination from float32 blocked normals:

        Ainv = Nii^-1;  Y = Ainv Nij;  S_b = Njj − Nijᵀ Y

    Returns (Ainv, Y, S, status); status as in batched_cholesky_inverse."""
    with record_function("dta.chol_inv"):
        Linv, status = batched_cholesky_inverse(Nii.to(torch.float32))
    with record_function("dta.reduce_from_linv"):
        return (*reduce_from_linv(Linv, Nij, Njj), status)
