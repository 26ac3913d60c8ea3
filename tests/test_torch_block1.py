"""adjust --block1-phased --tpu in the port against the JAX package's host
--block1-phased, and the residual-driven Newton stop of the dense solve.

The port's device route (the Cholesky-inverse kernel's plain version on
the CPU, --device cpu, then float64 Newton rounds) is held to the JAX
CLI's host float64 route on the 10 x 10 DNA files of
tests/test_torch_cli.py, with and without --staged-adjustment
--create-stage-files: saved xyz within 1e-8 m, the same status line, and
the .adj (below "Number of unknown parameters") and .xyz numbers within
1e-6.  The JAX package's own --tpu route takes two fixed Newton rounds,
which on these weakly constrained block-1 normals (condition number near
1.5e7) leave it about 1e-4 m off, so it is not the reference here: the
port with its rounds fixed at two (and the float64 fallback off) must be
more than 1e-6 m off, which shows that the comparison sees the hazard.

F9 (ROADMAP.md): on the simulated 6 x 6 network, whose block 1 has a
scaled condition number of 2.0e9, the float32 factor meets a
non-positive pivot; the device route then solves that block in float64
and lands within 1e-8 m of the port's host --block1-phased (the JAX CLI
writes NaN there).  A system whose float32 copy is singular takes the
same fallback and matches scipy's cho_solve to 1e-9.  Every fallback
solve raises one Float64FallbackWarning and is counted in the result's
profile; a solve on the kernel's route raises none.
"""

import pickle
import warnings

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from dynadjust_tpu.cli import main as jax_main
from dynadjust_tpu.diff import compare_files
from dynadjust_tpu.io_formats.dna_writer import write_dna_msr, write_dna_stn
from dynadjust_tpu.utils.synthetic_mixed import synthetic_mixed_network
from dynadjust_tpu_torch.cli import main as torch_main
from dynadjust_tpu_torch.ops.chol_inv import batched_cholesky_inverse
from dynadjust_tpu_torch.parallel import dense_device
from dynadjust_tpu_torch.parallel.dense_device import dense_solve_device

MARKER = "Number of unknown parameters"
SEGMENT = ["--min-inner-stns", "30", "--max-block-stns", "60"]
STAGE = ["--staged-adjustment", "--create-stage-files"]
ROUTES = {"device": [], "device-staged": STAGE}
STATUS = "Estimates solved for Block 1 only"


@pytest.fixture(scope="module")
def dna(tmp_path_factory):
    d = tmp_path_factory.mktemp("dna")
    net, _ = synthetic_mixed_network(10, 10, block_rows=5, block_cols=5,
                                     seed=0)
    write_dna_stn(str(d / "n.stn"), net)
    write_dna_msr(str(d / "n.msr"), net)
    return d


def _run(main, folder, dna, adjust_args):
    folder.mkdir(parents=True)
    common = ["--output-folder", str(folder)]
    assert main(["import", "-n", "n", str(dna / "n.stn"),
                 str(dna / "n.msr"), *common]) == 0
    assert main(["segment", "n", *SEGMENT, *common]) == 0
    assert main(["adjust", "n", *adjust_args, *common]) == 0
    with open(folder / "n.results.pkl", "rb") as f:
        return pickle.load(f)


@pytest.fixture(scope="module")
def host(dna, tmp_path_factory):
    """The JAX CLI's host --block1-phased: (folder, result)."""
    d = tmp_path_factory.mktemp("host") / "jax"
    return d, _run(jax_main, d, dna, ["--block1-phased"])


@pytest.mark.parametrize("route", list(ROUTES))
def test_block1_device_route_matches_host(dna, host, tmp_path, route):
    hdir, rh = host
    d = tmp_path / "torch"
    launches = batched_cholesky_inverse.launches
    rt = _run(torch_main, d, dna, ["--block1-phased", "--tpu", "--device",
                                   "cpu", *ROUTES[route]])
    assert batched_cholesky_inverse.launches == launches    # CPU: plain
    assert rt.status == rh.status and rt.status.startswith(STATUS)
    assert rt.iterations == rh.iterations == 1
    assert np.abs(rt.xyz - rh.xyz).max() < 1e-8
    ok, diffs = compare_files(str(d / "n.phased-block1.adj"),
                              str(hdir / "n.phased-block1.adj"), 1e-6,
                              skip_to_marker=MARKER)
    assert ok, diffs[:5]
    ok, diffs = compare_files(str(d / "n.xyz"), str(hdir / "n.xyz"), 1e-6)
    assert ok, diffs[:5]
    # one device solve per block of the reverse sweep; block 1's normals
    # need more than the JAX package's two Newton rounds
    newton = rt.profile["newton"]
    assert len(newton) == len(rt.block_info)
    assert max(r["rounds"] for r in newton) > 2
    assert all(2 <= r["rounds"] <= 12 and r["residual"] < 1e-8
               for r in newton)
    if route == "device-staged":
        assert any((d / "n.mtx").iterdir())


def test_two_rounds_are_not_enough(dna, host, tmp_path, monkeypatch):
    """The same route with the Newton rounds capped at the JAX package's
    two and the float64 fallback off lands more than 1e-6 m off the host
    route.  With the fallback on, the solves whose two rounds end above
    RESIDUAL_BOUND take the float64 route, each with a warning, and land
    within 1e-8 m."""
    monkeypatch.setattr(dense_device, "MAX_ROUNDS", 2)
    argv = ["--block1-phased", "--tpu", "--device", "cpu"]
    with monkeypatch.context() as m:
        m.setattr(dense_device, "RESIDUAL_BOUND", np.inf)
        rt = _run(torch_main, tmp_path / "off", dna, argv)
    assert all(r["rounds"] == 2 and r["route"] == "kernel"
               for r in rt.profile["newton"])
    assert rt.profile["f64_fallbacks"] == 0
    assert np.abs(rt.xyz - host[1].xyz).max() > 1e-6
    with pytest.warns(dense_device.Float64FallbackWarning) as caught:
        rt = _run(torch_main, tmp_path / "on", dna, argv)
    newton = rt.profile["newton"]
    assert all((r["route"] == "f64") == (r["residual"] > 1e-6)
               for r in newton)
    n_f64 = sum(r["route"] == "f64" for r in newton)
    assert n_f64 > 0 and rt.profile["f64_fallbacks"] == n_f64
    assert n_f64 == sum(issubclass(w.category,
                                   dense_device.Float64FallbackWarning)
                        for w in caught)
    assert np.abs(rt.xyz - host[1].xyz).max() < 1e-8


def _system(n, kappa_decades, seed=0):
    """An SPD system whose eigenvalues span kappa_decades decades."""
    rng = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(rng.normal(size=(n, n)))
    lam = 10.0 ** np.linspace(0.0, -kappa_decades, n)
    return (Q * lam) @ Q.T, rng.normal(size=n)


def _two_rounds(N, rhs, monkeypatch):
    with monkeypatch.context() as m:
        m.setattr(dense_device, "MAX_ROUNDS", 2)
        m.setattr(dense_device, "RESIDUAL_BOUND", np.inf)
        rec = []
        out = dense_solve_device(N, rhs, device="cpu", record=rec)
    assert rec[0]["rounds"] == 2
    return out


@pytest.mark.parametrize("decades", [2, 7])
def test_newton_stop(decades, monkeypatch):
    """The residual-driven stop: a well-conditioned system takes at least
    the two rounds and lands on the float64 solve as they do; an
    ill-conditioned one takes more, which reach the float64 solve where
    two do not."""
    N, rhs = _system(120, decades)
    rec = []
    with warnings.catch_warnings():
        warnings.simplefilter("error", dense_device.Float64FallbackWarning)
        X, dx = dense_solve_device(N, rhs, device="cpu", record=rec)
    r = rec[0]
    assert r["n"] == 120 and 2 <= r["rounds"] <= dense_device.MAX_ROUNDS
    X2, dx2 = _two_rounds(N, rhs, monkeypatch)
    ref = np.linalg.solve(N, rhs)
    err = np.abs(dx - ref).max() / np.abs(ref).max()
    err2 = np.abs(dx2 - ref).max() / np.abs(ref).max()
    # the last round's residual, near its float64 floor, and the kernel's
    # route kept
    assert r["residual"] < 10.0 ** decades * 1e-13
    assert r["route"] == "kernel"
    if decades == 2:
        assert err < 1e-12 and err2 < 1e-12
        np.testing.assert_allclose(X, X2, rtol=0, atol=1e-12 * np.abs(X).max())
    else:
        assert r["rounds"] > 2 and err2 > 1e3 * err
        assert err < 1e-8


def test_newton_cap(monkeypatch):
    """MAX_ROUNDS caps the rounds of an ill-conditioned solve."""
    monkeypatch.setattr(dense_device, "MAX_ROUNDS", 3)
    rec = []
    N, rhs = _system(60, 7, seed=1)
    dense_solve_device(N, rhs, device="cpu", record=rec)
    assert rec[0]["rounds"] == 3


@pytest.fixture(scope="module")
def f9_dna(tmp_path_factory):
    """ROADMAP F9's network: the 6 x 6 mixed network as DNA files, its
    simulated measurements (import --simulate) as the records."""
    d = tmp_path_factory.mktemp("f9")
    net, _ = synthetic_mixed_network(6, 6, block_rows=3, block_cols=3)
    write_dna_stn(str(d / "n.stn"), net)
    write_dna_msr(str(d / "n.msr"), net)
    assert torch_main(["import", "-n", "n", str(d / "n.stn"),
                       str(d / "n.msr"), "--simulate", "--output-folder",
                       str(d)]) == 0
    return d


def test_f9_network_takes_the_float64_route(f9_dna, tmp_path):
    """F9: block 1 of the simulated 6 x 6 network (scaled condition
    number 2.0e9) meets a non-positive float32 pivot.  The device route
    solves that block in float64 on the same device, records the route,
    and lands within 1e-8 m of the port's host --block1-phased (the JAX
    CLI writes NaN on this network)."""
    res, fallbacks = {}, {}
    for route, extra in (("host", []), ("device", ["--tpu", "--device",
                                                     "cpu"])):
        d = tmp_path / route
        d.mkdir()
        common = ["--output-folder", str(d)]
        assert torch_main(["import", "-n", "s", str(f9_dna / "n.stn"),
                           str(f9_dna / "n.simulated.msr"), *common]) == 0
        assert torch_main(["segment", "s", "--min-inner-stns", "10",
                           "--max-block-stns", "20", *common]) == 0
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            assert torch_main(["adjust", "s", "--block1-phased", *extra,
                               *common]) == 0
        fallbacks[route] = [w for w in caught if issubclass(
            w.category, dense_device.Float64FallbackWarning)]
        with open(d / "s.results.pkl", "rb") as f:
            res[route] = pickle.load(f)
    h, r = res["host"], res["device"]
    assert r.status == h.status and r.status.startswith(STATUS)
    assert np.abs(r.xyz - h.xyz).max() < 1e-8
    newton = r.profile["newton"]
    assert len(newton) == len(r.block_info)
    f64 = [x for x in newton if x["route"] == "f64"]
    assert f64 and all(x["f64_residual"] < 1e-6 for x in f64)
    assert r.profile["f64_fallbacks"] == len(fallbacks["device"]) == len(f64)
    assert not fallbacks["host"]
    assert all(x["residual"] <= dense_device.RESIDUAL_BOUND
               for x in newton if x["route"] == "kernel")


def test_non_positive_float32_pivot_takes_float64():
    """An SPD system whose float32 copy is singular (a 2 x 2 block
    [[1, 1 - 2^-25], [1 - 2^-25, 1]]: 1 - 2^-25 rounds to 1 in float32)
    takes the float64 route and matches scipy's cho_solve to 1e-9
    relative, with and without unity scaling."""
    import scipy.linalg as sla
    rng = np.random.default_rng(4)
    n = 40
    G = rng.normal(size=(2 * n, n - 2))
    N = np.zeros((n, n))
    N[2:, 2:] = G.T @ G / (2 * n) + 0.5 * np.eye(n - 2)
    N[:2, :2] = [[1.0, 1.0 - 2.0 ** -25], [1.0 - 2.0 ** -25, 1.0]]
    p = rng.permutation(n)
    N = N[np.ix_(p, p)]
    rhs = rng.normal(size=n)
    assert np.linalg.eigvalsh(N)[0] > 0
    status = batched_cholesky_inverse(
        torch.tensor(N, dtype=torch.float32)[None])[1]
    assert status.tolist() == [1]
    c = sla.cho_factor(N, lower=True)
    ref, Xref = sla.cho_solve(c, rhs), sla.cho_solve(c, np.eye(n))
    for scale in (True, False):
        rec = []
        with pytest.warns(dense_device.Float64FallbackWarning,
                          match="40x40 normals took the float64 fallback"):
            X, dx = dense_solve_device(N, rhs, scale, device="cpu",
                                       record=rec)
        assert rec[0]["route"] == "f64" and rec[0]["rounds"] == 0
        assert rec[0]["f64_residual"] < 1e-12
        assert np.abs(dx - ref).max() / np.abs(ref).max() < 1e-9
        assert np.abs(X - Xref).max() / np.abs(Xref).max() < 1e-9
