"""The padding that both Cholesky-inverse versions give their input
(ops/chol_inv.py, ``_pad_identity``), on the CPU.

Each version pads n to a multiple of its own tile (the plain version 64,
the kernel its 128-wide step) and reads only the lower triangle, so the
copy holds the input in its leading block, an identity in the padded rows
and nothing defined in the padded columns of the first n rows.  The
kernel itself runs on the card (tests/test_torch_gpu.py, chip_smoke.py).
"""

import numpy as np
import pytest
import torch

from dynadjust_tpu_torch.ops.chol_inv import (TILE, _pad_identity,
                                              cholesky_inverse_plain)

torch.set_num_threads(2)

KERNEL_TILE = 128


@pytest.mark.parametrize("n0", [1, 127, 128, 129, 200])
def test_padding_is_the_input_over_an_identity(n0):
    rng = np.random.default_rng(n0)
    G = rng.normal(size=(2, 2 * n0, n0))
    N = torch.tensor(G.transpose(0, 2, 1) @ G / (2 * n0) + np.eye(n0),
                     dtype=torch.float32)
    A = _pad_identity(N, KERNEL_TILE)
    n = A.shape[1]
    assert A.shape == (2, n, n) and n % KERNEL_TILE == 0
    assert n - n0 < KERNEL_TILE
    assert torch.equal(A[:, :n0, :n0], N)
    assert torch.equal(A[:, n0:, :], torch.eye(n)[n0:].expand(2, -1, -1))
    # the unset upper columns do not reach the factor: the plain version
    # on the padded copy gives the input's inverse factor in its block
    A[:, :n0, n0:] = float("nan")
    Linv, status = cholesky_inverse_plain(A)
    ref, _ = cholesky_inverse_plain(N)
    assert status.tolist() == [0, 0] and n % TILE == 0
    assert torch.allclose(Linv[:, :n0, :n0], ref, rtol=0, atol=1e-5)
