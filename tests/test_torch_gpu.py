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
@pytest.mark.parametrize("B, n", [(3, 700), (2, 2048), (16, 768)])
def test_kernel_residual_no_worse_than_plain(cuda, B, n):
    """The 3xTF32 tile products keep float32 accuracy: the float64
    residual max|Linv N Linvᵀ − I| of the kernel is at most twice that
    of the plain version (full float32 products) on the same input.
    (16, 768) is the level 1 of the GNSS-only network of bench.py's
    default (64 x 64 stations, blocks of 16)."""
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


@pytest.mark.gpu
def test_dynadjust_pipeline_on_card_matches_cpu(cuda, tmp_path):
    """The pipeline verb on a 24 x 24 network (import, reftran to
    ITRF2014 at 01.01.2024, geoid from a seeded 1' grid with
    --convert-stn-hts, segment, adjust --phased --tpu) on the card and
    with --device cpu: xyz within 1e-7 m, sigma zero within 1e-9, the
    same iterations, and the kernel launched on the card's run only."""
    import pickle
    from dynadjust_tpu_torch.cli import main
    from dynadjust_tpu_torch.geoid.gridtools import write_gsb
    from dynadjust_tpu_torch.io_formats.dna_writer import (write_dna_msr,
                                                           write_dna_stn)
    from dynadjust_tpu_torch.utils.synthetic_geoid import (
        orthometric_levelling, synthetic_geoid_grid)
    net, _ = synthetic_mixed_network(24, 24, block_rows=12, block_cols=12)
    grid = synthetic_geoid_grid(-37.5, -35.5, 142.5, 144.5)
    write_gsb(grid, str(tmp_path / "g.gsb"))
    orthometric_levelling(net, grid)
    write_dna_stn(str(tmp_path / "n.stn"), net, ellipsoidal=True)
    write_dna_msr(str(tmp_path / "n.msr"), net)
    res, launches = {}, {}
    for dev in ("cuda", "cpu"):
        out = tmp_path / dev
        out.mkdir()
        before = batched_cholesky_inverse.launches
        assert main(["dynadjust", "-n", "n", str(tmp_path / "n.stn"),
                     str(tmp_path / "n.msr"), "-r", "ITRF2014", "-e",
                     "01.01.2024", "-g", str(tmp_path / "g.gsb"),
                     "--convert-stn-hts", "--phased", "--tpu",
                     "--min-inner-stns", "100", "--max-block-stns", "200",
                     "--device", dev, "--output-folder", str(out)]) == 0
        launches[dev] = batched_cholesky_inverse.launches - before
        with open(out / "n.results.pkl", "rb") as f:
            res[dev] = pickle.load(f)
        assert (out / "dynadjust.log").read_text().count(" done ") == 5
    g, c = res["cuda"], res["cpu"]
    assert g.status == c.status == "Converged"
    assert g.pass_fail == "PASSED" and g.iterations == c.iterations
    assert np.abs(g.xyz - c.xyz).max() <= 1e-7
    assert abs(g.sigma_zero - c.sigma_zero) <= 1e-9
    assert launches["cuda"] > 0 and launches["cpu"] == 0


@pytest.mark.gpu
def test_block1_on_card_matches_cpu(cuda, tmp_path):
    """adjust --block1-phased --tpu on a 24 x 24 network on the card and
    with --device cpu: the same status, xyz within 1e-8 m, and on the
    card one kernel launch per block, each solve's Newton residual below
    1e-8."""
    import pickle
    from dynadjust_tpu_torch.cli import main
    from dynadjust_tpu_torch.io_formats.dna_writer import (write_dna_msr,
                                                           write_dna_stn)
    net, _ = synthetic_mixed_network(24, 24, block_rows=12, block_cols=12)
    write_dna_stn(str(tmp_path / "n.stn"), net)
    write_dna_msr(str(tmp_path / "n.msr"), net)
    res, launches = {}, {}
    for dev in ("cuda", "cpu"):
        out = tmp_path / dev
        out.mkdir()
        common = ["--output-folder", str(out)]
        assert main(["import", "-n", "n", str(tmp_path / "n.stn"),
                     str(tmp_path / "n.msr"), *common]) == 0
        assert main(["segment", "n", "--min-inner-stns", "100",
                     "--max-block-stns", "200", *common]) == 0
        before = batched_cholesky_inverse.launches
        assert main(["adjust", "n", "--block1-phased", "--tpu", "--device",
                     dev, *common]) == 0
        launches[dev] = batched_cholesky_inverse.launches - before
        with open(out / "n.results.pkl", "rb") as f:
            res[dev] = pickle.load(f)
    g, c = res["cuda"], res["cpu"]
    assert g.status == c.status and g.status.startswith("Estimates solved")
    assert np.abs(g.xyz - c.xyz).max() <= 1e-8
    assert launches["cuda"] == len(g.block_info) and launches["cpu"] == 0
    assert all(r["residual"] < 1e-8 for r in g.profile["newton"])


@pytest.mark.gpu
def test_dense_solve_fallback_on_card(cuda):
    """An SPD system whose float32 copy is singular takes the float64
    route on the card, once the kernel flags the pivot, and agrees with
    the CPU's run of the same route to 1e-12 relative."""
    from dynadjust_tpu_torch.parallel.dense_device import dense_solve_device
    rng = np.random.default_rng(4)
    n = 40
    N = np.zeros((n, n))
    N[2:, 2:] = _spd(1, n - 2, 15)[0]
    N[:2, :2] = [[1.0, 1.0 - 2.0 ** -25], [1.0 - 2.0 ** -25, 1.0]]
    rhs = rng.normal(size=n)
    out, rec = {}, {}
    for dev in ("cuda", "cpu"):
        rec[dev] = []
        before = batched_cholesky_inverse.launches
        out[dev] = dense_solve_device(N, rhs, device=dev, record=rec[dev])
        assert batched_cholesky_inverse.launches == before + (dev == "cuda")
        assert rec[dev][0]["route"] == "f64"
    for g, c in zip(out["cuda"], out["cpu"]):
        assert np.abs(g - c).max() <= 1e-12 * np.abs(c).max()


@pytest.mark.gpu
def test_adjust_blocked_device_on_card_matches_cpu(cuda):
    """The device-resident GNSS Gauss-Newton loop on the 12 x 12 network
    of tests/test_schur.py: the card's run against the CPU's, the same
    iterations and xyz within 1e-8 m, the kernel launched once (the
    factorization) on the card."""
    from dynadjust_tpu_torch.parallel.blocked_adjust import BlockedNetwork
    from dynadjust_tpu_torch.parallel.device_adjust import \
        adjust_blocked_device
    from dynadjust_tpu_torch.utils.synthetic import (grid_segmentation,
                                                     synthetic_grid_network)
    xyz, pairs, obs, var, x0, fixed = synthetic_grid_network(12, 12, seed=1)
    blocks, junction = grid_segmentation(12, 12, 4, 4)
    bn = BlockedNetwork(nstations=144, pairs=pairs, obs=obs,
                        weight=1.0 / var, blocks=blocks,
                        junction_stations=junction, constrained=fixed)
    before = batched_cholesky_inverse.launches
    xg, itg, mcg, _ = adjust_blocked_device(bn, x0)
    assert batched_cholesky_inverse.launches == before + 1
    xc, itc, _, _ = adjust_blocked_device(bn, x0, device="cpu")
    assert itg == itc and mcg <= 5e-4
    assert np.abs(xg - xc).max() <= 1e-8


@pytest.mark.gpu
@pytest.mark.parametrize("sb", [0, 2], ids=["two-level", "nested"])
def test_nccl_mesh_of_one_rank_equals_meshless_run(cuda, tmp_path, sb):
    """A world of one nccl rank on cuda:0 (a file store): the mesh route
    of adjust_tpu_blocked — the kernel on the rank's shard, every
    junction sum through all_reduce — lands on the meshless run: the
    same iterations, xyz within 1e-8 m, sigma zero within 1e-9."""
    import torch.distributed as dist
    from dynadjust_tpu_torch.parallel import multihost as mh
    net, seg = synthetic_mixed_network(24, 24, block_rows=12, block_cols=12)
    ref = adjust_tpu_blocked(net, AdjustmentOptions(), seg=seg,
                             super_blocks=sb, device=cuda)
    mh.init_distributed(num_processes=1, process_id=0, backend="nccl",
                        init_method=f"file://{tmp_path}/store",
                        device="cuda:0")
    try:
        mh.reset_counts()
        before = batched_cholesky_inverse.launches
        net, seg = synthetic_mixed_network(24, 24, block_rows=12,
                                           block_cols=12)
        res = adjust_tpu_blocked(net, AdjustmentOptions(), seg=seg,
                                 super_blocks=sb,
                                 mesh=mh.global_block_mesh())
    finally:
        dist.destroy_process_group()
    assert batched_cholesky_inverse.launches > before
    assert mh.COUNTS["all_reduce"] > 0
    assert res.status == ref.status == "Converged"
    assert res.iterations == ref.iterations
    assert np.abs(res.xyz - ref.xyz).max() <= 1e-8
    assert abs(res.sigma_zero - ref.sigma_zero) <= 1e-9


@pytest.mark.gpu
@pytest.mark.parametrize("tool", ["mixed", "streamed"])
def test_national_tools_on_card_match_cpu(cuda, tool):
    """The national-scale tools at a small size on the card and on the
    CPU: the mixed one at the bounds of test_adjustment_on_card_matches_cpu
    (xyz 1e-7 m, sigma zero 1e-9, station covariances 1e-9 relative),
    the streamed one within 1e-10 of the largest correction, each
    launching the kernel on the card."""
    from dynadjust_tpu_torch.tools import national_mixed, national_streamed
    before = batched_cholesky_inverse.launches
    if tool == "mixed":
        card, rec = national_mixed.run(24, 24, 6, 4, device=cuda)
        host, _ = national_mixed.run(24, 24, 6, 4, device="cpu")
        assert card.iterations == host.iterations
        assert np.abs(card.xyz - host.xyz).max() <= 1e-7
        assert abs(card.sigma_zero - host.sigma_zero) <= 1e-9
        assert (np.abs(card.cov_stn - host.cov_stn).max()
                <= 1e-9 * np.abs(host.cov_stn).max())
        assert rec["peak_device_gb"] > 0
    else:
        card, rec = national_streamed.run(24, 24, 6, 2, device=cuda)
        host, _ = national_streamed.run(24, 24, 6, 2, device="cpu")
        scale = max(np.abs(host.xi).max(), np.abs(host.xj).max())
        assert np.abs(card.xi - host.xi).max() <= 1e-10 * scale
        assert np.abs(card.xj - host.xj).max() <= 1e-10 * scale
        assert rec["relative_residual"] <= 1e-10
        assert len(rec["chunk_ms"]) == rec["blocks"] // rec["chunk_blocks"]
    assert batched_cholesky_inverse.launches > before
