"""Tests of the port that need a CUDA card (marker ``gpu``; they skip
without one).  The file imports nothing of JAX, so the card's machine
runs it without the repository's conftest:

    python -m pytest -p no:cacheprovider --noconftest -m gpu \\
        tests/test_torch_gpu.py
"""

import numpy as np
import pytest
import torch

from dynadjust_tpu_torch.adjust import AdjustmentOptions
from dynadjust_tpu_torch.adjust.tpu_blocked import adjust_tpu_blocked
from dynadjust_tpu_torch.ops.chol_inv import (batched_cholesky_inverse,
                                              cholesky_inverse_plain,
                                              fused_block_reduce)
from dynadjust_tpu_torch.utils.synthetic_mixed import synthetic_mixed_network

torch.set_num_threads(2)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _spd(B, n, seed):
    rng = np.random.default_rng(seed)
    G = rng.normal(size=(B, 2 * n, n))
    return G.transpose(0, 2, 1) @ G / (2 * n) + 0.5 * np.eye(n)


# sizes around the plain version's 64-wide tiles and the kernel's
# 128-wide steps, and one at a size where the inverse recursion is deep
SIZES = [(3, n) for n in (1, 63, 64, 65, 127, 128, 129, 700)] + [(2, 2048)]


@pytest.mark.gpu
@pytest.mark.parametrize("B, n", SIZES)
def test_kernel_matches_plain_version(cuda, B, n):
    """Kernel and plain version on the same card, same float32 inputs:
    the kernel's tile products are 3xTF32 and the plain version's full
    float32, and they sum in other orders (2e-5 of max|Linv|)."""
    N = torch.tensor(_spd(B, n, n), dtype=torch.float32, device=cuda)
    before = batched_cholesky_inverse.launches
    Lk, sk = batched_cholesky_inverse(N)
    Lp, sp = cholesky_inverse_plain(N)
    torch.cuda.synchronize()
    assert batched_cholesky_inverse.launches == before + 1
    assert (Lk - Lp).abs().max() <= 2e-5 * Lp.abs().max()
    assert sk.tolist() == sp.tolist() == [0] * B
    assert torch.equal(torch.triu(Lk, 1), torch.zeros_like(Lk))


@pytest.mark.gpu
@pytest.mark.parametrize("B, n", [(3, 700), (2, 2048)])
def test_kernel_residual_no_worse_than_plain(cuda, B, n):
    """The 3xTF32 tile products keep float32 accuracy: the float64
    residual max|Linv N Linvᵀ − I| of the kernel is at most twice that
    of the plain version (full float32 products) on the same input."""
    N = torch.tensor(_spd(B, n, n), dtype=torch.float32, device=cuda)
    N64 = N.double()
    eye = torch.eye(n, dtype=torch.float64, device=cuda)

    def residual(L):
        L = L.double()
        return float((L @ N64 @ L.transpose(1, 2) - eye).abs().max())

    kernel = residual(batched_cholesky_inverse(N)[0])
    plain = residual(cholesky_inverse_plain(N)[0])
    assert kernel <= 2.0 * plain, (kernel, plain)


@pytest.mark.gpu
def test_kernel_block_reduce_matches_truth(cuda):
    rng = np.random.default_rng(3)
    B, ni, nj = 3, 200, 70
    A = rng.normal(size=(B, ni, ni))
    Nii = A @ A.transpose(0, 2, 1) + ni * np.eye(ni)
    Nij = rng.normal(size=(B, ni, nj))
    Njj0 = rng.normal(size=(B, nj, nj))
    Njj = Njj0 + Njj0.transpose(0, 2, 1)
    Ainv = np.linalg.inv(Nii)
    Y = Ainv @ Nij
    truth = (Ainv, Y, Njj - Nij.transpose(0, 2, 1) @ Y)
    out = fused_block_reduce(*(torch.tensor(x, dtype=torch.float32,
                                            device=cuda)
                               for x in (Nii, Nij, Njj)))
    for got, want in zip(out[:3], truth):
        got = got.double().cpu().numpy()
        assert np.abs(got - want).max() / np.abs(want).max() < 5e-5


@pytest.mark.gpu
def test_kernel_flags_indefinite_blocks(cuda):
    N = torch.tensor(_spd(4, 150, 1), dtype=torch.float32, device=cuda)
    N[1] = -N[1]
    N[3, 7, 7] = float("nan")
    _, status = batched_cholesky_inverse(N)
    assert status.tolist() == [0, 1, 0, 1]


@pytest.mark.gpu
def test_adjustment_on_card_matches_cpu(cuda):
    """The whole two-level adjustment on the card and on the CPU (plain
    versions): the bounds of test_end_to_end_device_vs_host."""
    out = {}
    for dev in (cuda, "cpu"):
        net, seg = synthetic_mixed_network(12, 12, block_rows=6,
                                           block_cols=6)
        out[str(dev)] = adjust_tpu_blocked(net, AdjustmentOptions(),
                                           seg=seg, device=dev)
    g, c = out["cuda"], out["cpu"]
    assert g.status == c.status == "Converged"
    assert g.iterations == c.iterations
    assert np.abs(g.xyz - c.xyz).max() < 1e-7
    assert abs(g.sigma_zero - c.sigma_zero) < 1e-9
    sc = np.abs(c.cov_stn).max()
    assert np.abs(g.cov_stn - c.cov_stn).max() / sc < 1e-9


@pytest.mark.gpu
def test_kernel_at_level2_shape_with_identity_block(cuda):
    """The nested path's level-2 shape at 10,000 stations: 4 super-block
    systems of 405 slots, of which 405, 93, 93 and 0 are real and the
    rest identity padding; the last system is all identity.  Status 0
    everywhere, and the bound (2e-5 of max|Linv|) and residual gate
    (at most twice the plain version's) of the tests above."""
    n = 405
    N64 = np.tile(np.eye(n), (4, 1, 1))
    for k, m in enumerate((405, 93, 93)):
        N64[k, :m, :m] = _spd(1, m, k)[0]
    N = torch.tensor(N64, dtype=torch.float32, device=cuda)
    Lk, sk = batched_cholesky_inverse(N)
    Lp, sp = cholesky_inverse_plain(N)
    assert sk.tolist() == sp.tolist() == [0] * 4
    assert (Lk - Lp).abs().max() <= 2e-5 * Lp.abs().max()
    assert torch.equal(Lk[3], torch.eye(n, device=cuda))
    N64 = torch.tensor(N64, device=cuda)
    eye = torch.eye(n, dtype=torch.float64, device=cuda)

    def residual(L):
        L = L.double()
        return float((L @ N64 @ L.transpose(1, 2) - eye).abs().max())

    assert residual(Lk) <= 2.0 * residual(Lp)


@pytest.mark.gpu
@pytest.mark.parametrize("fuse_bytes", ["6e8", "0"],
                         ids=["one_pass", "staged"])
def test_nested_adjustment_on_card_matches_cpu(cuda, monkeypatch,
                                               fuse_bytes):
    """The nested adjustment (super_blocks=2) of the 24 x 24 network on
    the card and on the CPU, on both factor routes: the bounds of
    test_end_to_end_device_vs_host."""
    monkeypatch.setenv("DTA_NESTED_FUSE_BYTES", fuse_bytes)
    out = {}
    for dev in (cuda, "cpu"):
        net, seg = synthetic_mixed_network(24, 24, block_rows=12,
                                           block_cols=12)
        out[str(dev)] = adjust_tpu_blocked(net, AdjustmentOptions(),
                                           seg=seg, super_blocks=2,
                                           device=dev)
    g, c = out["cuda"], out["cpu"]
    assert g.status == c.status == "Converged"
    assert g.iterations == c.iterations
    assert np.abs(g.xyz - c.xyz).max() < 1e-7
    assert abs(g.sigma_zero - c.sigma_zero) < 1e-9
    sc = np.abs(c.cov_stn).max()
    assert np.abs(g.cov_stn - c.cov_stn).max() / sc < 1e-9


@pytest.mark.gpu
@pytest.mark.parametrize("route", ["staged", "host_loop"])
def test_host_routes_on_card_match_cpu(cuda, monkeypatch, route):
    """The 24 x 24 network on the card and on the CPU: staged
    (host-streamed) nested factors with super_blocks=2, and the flat host
    refinement loop (DTA_DEVICE_SOLVE=0) — the bounds of
    test_end_to_end_device_vs_host.  The staged route launches the
    kernel on the card."""
    kw = {}
    if route == "staged":
        kw = dict(staged=True, super_blocks=2)
    else:
        monkeypatch.setenv("DTA_DEVICE_SOLVE", "0")
    out = {}
    for dev in (cuda, "cpu"):
        net, seg = synthetic_mixed_network(24, 24, block_rows=12,
                                           block_cols=12)
        before = batched_cholesky_inverse.launches
        out[str(dev)] = adjust_tpu_blocked(net, AdjustmentOptions(),
                                           seg=seg, device=dev, **kw)
        launched = batched_cholesky_inverse.launches - before
        assert (launched > 0) == (str(dev) == "cuda")
    g, c = out["cuda"], out["cpu"]
    assert g.status == c.status == "Converged"
    assert g.iterations == c.iterations
    assert all("solve_rel" not in it for it in g.iteration_log)
    assert np.abs(g.xyz - c.xyz).max() < 1e-7
    assert abs(g.sigma_zero - c.sigma_zero) < 1e-9
    sc = np.abs(c.cov_stn).max()
    assert np.abs(g.cov_stn - c.cov_stn).max() / sc < 1e-9


@pytest.mark.gpu
@pytest.mark.parametrize("scale", [True, False], ids=["unity", "unscaled"])
def test_dense_solve_on_card(cuda, scale):
    """adjust --tpu's dense solve runs the kernel once at (1, n) and
    reaches the float64 inverse after its Newton steps."""
    from dynadjust_tpu_torch.parallel.dense_device import dense_solve_device
    n = 600
    N = _spd(1, n, 11)[0]
    d = 10.0 ** np.random.default_rng(12).uniform(-2, 2, n)
    if scale:
        N = N * d[:, None] * d[None, :]
    rhs = np.random.default_rng(13).normal(size=n)
    before = batched_cholesky_inverse.launches
    shapes = dict(batched_cholesky_inverse.shapes)
    X, dx = dense_solve_device(N, rhs, scale, device="cuda")
    assert batched_cholesky_inverse.launches == before + 1
    assert batched_cholesky_inverse.shapes[(1, n)] == shapes.get((1, n),
                                                                 0) + 1
    Xref = np.linalg.inv(N)
    assert np.abs(X - Xref).max() / np.abs(Xref).max() < 1e-10
    assert np.abs(dx - Xref @ rhs).max() / np.abs(Xref @ rhs).max() < 1e-10


@pytest.mark.gpu
def test_dense_solve_indefinite_raises_on_card(cuda):
    from dynadjust_tpu_torch.parallel.dense_device import dense_solve_device
    N = _spd(1, 300, 14)[0]
    N[7, 7] = -1.0
    with pytest.raises(torch.linalg.LinAlgError):
        dense_solve_device(N, np.ones(300), False, device="cuda")
