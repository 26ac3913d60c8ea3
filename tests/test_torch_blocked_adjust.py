"""The port's GNSS-only blocked adjustment (parallel/blocked_adjust.py,
assembly.py, device_adjust.py and the flat solves of schur.py) against
the JAX package's, on the CPU.

The networks are those of tests/test_schur.py: 12 x 12 stations in
blocks of 4 (seed 1) and 16 x 16 (seed 3, with the 2 x 2 super-block
grouping for the nested branch), made once by synthetic_grid_network and
fed to both packages as the same numpy arrays.  The JAX side runs as its
own tests run it on the CPU (method "inv" on its default rec backend, no
Pallas kernel).  Bounds: index arrays exactly, normals and rhs pools
1e-12 relative; solves 1e-10 m; adjustments the same iterations and xyz
within 1e-8 m (the nested branch 1e-6 m, tests/test_schur.py:258's own
bound); one Gauss-Newton step on the JAX package's factors 1e-10.
"""

import dataclasses

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import jax.numpy as jnp

from dynadjust_tpu.parallel import assembly as JA
from dynadjust_tpu.parallel import blocked_adjust as JB
from dynadjust_tpu.parallel import device_adjust as JD
from dynadjust_tpu.parallel import schur as JS
from dynadjust_tpu_torch.ops.chol_inv import batched_cholesky_inverse
from dynadjust_tpu_torch.parallel import assembly as PA
from dynadjust_tpu_torch.parallel import blocked_adjust as PB
from dynadjust_tpu_torch.parallel import device_adjust as PD
from dynadjust_tpu_torch.parallel import schur as PS
from dynadjust_tpu_torch.utils.synthetic import (grid_segmentation,
                                                 grid_super_assignment,
                                                 synthetic_grid_network)

CPU = "cpu"
FREE_WEIGHT = 0.01
NETS = {"12x12": (12, 12, 4, 1), "16x16": (16, 16, 4, 3)}


def _networks(rows, cols, blk, seed):
    xyz, pairs, obs, var, x0, fixed = synthetic_grid_network(rows, cols,
                                                             seed=seed)
    blocks, junction = grid_segmentation(rows, cols, blk, blk)
    kw = dict(nstations=rows * cols, pairs=pairs, obs=obs, weight=1.0 / var,
              blocks=blocks, junction_stations=junction, constrained=fixed)
    return JB.BlockedNetwork(**kw), PB.BlockedNetwork(**kw), x0


@pytest.fixture(scope="module", params=list(NETS))
def net(request):
    return request.param, _networks(*NETS[request.param])


@pytest.fixture(scope="module")
def small():
    return _networks(*NETS["12x12"])


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _dmax(a, b):
    return np.abs(np.asarray(a, np.float64) - np.asarray(b)).max()


def test_build_normals_matches_jax(net):
    _, (jbn, pbn, x0) = net
    assert np.array_equal(pbn.block_of_msr, jbn.block_of_msr)
    jbs = JB.build_normals(jbn, x0, FREE_WEIGHT)
    pbs = PB.build_normals(pbn, x0, FREE_WEIGHT)
    for k in ("jmap", "jmask", "imask"):
        assert np.array_equal(getattr(pbs, k), getattr(jbs, k)), k
    assert pbs.nj_global == jbs.nj_global
    for k in ("Nii", "Nij", "Njj", "bi", "bj"):
        assert _rel(getattr(pbs, k), getattr(jbs, k)) <= 1e-12, k


def test_build_plan_and_assemble_match_jax(net):
    _, (jbn, pbn, x0) = net
    jplan = JA.build_plan(jbn, FREE_WEIGHT)
    pplan = PA.build_plan(pbn, FREE_WEIGHT)
    for k in ("msr_block", "bi_idx_1", "bi_idx_2", "bj_idx_1", "bj_idx_2",
              "jmap", "jmask", "imask"):
        assert np.array_equal(getattr(pplan, k), getattr(jplan, k)), k
    assert (pplan.ni, pplan.nj, pplan.nj_global) == \
        (jplan.ni, jplan.nj, jplan.nj_global)
    for a, b in zip(pplan.N_struct, jplan.N_struct):
        assert _rel(a, b) <= 1e-12
    for x in (x0, x0 + 1e-4):
        pbs, jbs = PA.assemble(pplan, x), JA.assemble(jplan, x)
        assert _rel(pbs.bi, jbs.bi) <= 1e-12
        assert _rel(pbs.bj, jbs.bj) <= 1e-12


def _solve(pkg, name, bs):
    if name == "schur_solve":
        return pkg.schur_solve(bs) if pkg is JS else \
            pkg.schur_solve(bs, device=CPU)
    if name == "schur_solve_refined":
        return pkg.schur_solve_refined(bs, refine=2) if pkg is JS else \
            pkg.schur_solve_refined(bs, refine=2, device=CPU)
    out = pkg.schur_solve_factored(bs, refine=2) if pkg is JS else \
        pkg.schur_solve_factored(bs, refine=2, device=CPU)
    return out[:2]


@pytest.mark.parametrize("name", ["schur_solve", "schur_solve_refined",
                                  "schur_solve_factored"])
def test_flat_solves_match_jax(small, name):
    jbn, pbn, x0 = small
    jbs = JB.build_normals(jbn, x0, FREE_WEIGHT)
    pbs = PB.build_normals(pbn, x0, FREE_WEIGHT)
    xi, xj = _solve(PS, name, pbs)
    ri, rj = _solve(JS, name, jbs)
    xi64, xj64 = JS.schur_solve(jbs)
    assert xi.shape == np.shape(ri) and xj.shape == np.shape(rj)
    assert _dmax(xi, ri) < 1e-10 and _dmax(xj, rj) < 1e-10
    assert _dmax(xi, xi64) < 1e-10 and _dmax(xj, xj64) < 1e-10


@pytest.mark.parametrize("method", ["inv", "chol", "inv64"])
def test_schur_solve_device_matches_jax(small, method):
    """Each method, then its factors reused for the rhs at x0 + 1e-4 (the
    GNSS normals do not change)."""
    jbn, pbn, x0 = small
    launches = batched_cholesky_inverse.launches
    for k, x in enumerate((x0, x0 + 1e-4)):
        jbs = JB.build_normals(jbn, x, FREE_WEIGHT)
        pbs = PB.build_normals(pbn, x, FREE_WEIGHT)
        if k == 0:
            pf = PS.DeviceSchurFactors(pbs, method=method, device=CPU)
            jf = JS.DeviceSchurFactors(jbs, method=method)
            assert pf.device_f64
        xi, xj, f = PS.schur_solve_device(pbs, refine=2, factors=pf)
        ri, rj, _ = JS.schur_solve_device(jbs, refine=2, factors=jf)
        assert f is pf
        xi64, xj64 = JS.schur_solve(jbs)
        assert _dmax(xi, ri) < 1e-10 and _dmax(xj, rj) < 1e-10
        assert _dmax(xi, xi64) < 1e-10 and _dmax(xj, xj64) < 1e-10
    assert batched_cholesky_inverse.launches == launches       # CPU: plain


def test_device_f64_off_is_one_float32_apply(small):
    """device_f64=False keeps the float32 normals only: solve_device is
    one float32 apply, as the JAX package's."""
    jbn, pbn, x0 = small
    jbs = JB.build_normals(jbn, x0, FREE_WEIGHT)
    pbs = PB.build_normals(pbn, x0, FREE_WEIGHT)
    for method in ("inv", "chol"):
        pf = PS.DeviceSchurFactors(pbs, method=method, device_f64=False,
                                   device=CPU)
        jf = JS.DeviceSchurFactors(jbs, method=method, device_f64=False)
        assert pf.Nii64 is None and not pf.device_f64
        xi, xj = pf.solve_device(pbs.bi, pbs.bj)
        ri, rj = jf.solve_device(jbs.bi, jbs.bj)
        assert xi.dtype == torch.float32
        assert _rel(xi, ri) < 1e-4 and _rel(xj, rj) < 1e-4


def test_inv64_refuses_device_assembled_pools(small):
    """Tensor pools (device-assembled normals) stay float32 on the
    device, so "inv64", which factors float64 normals, refuses them;
    "inv" takes them with device_f64 off."""
    _, pbn, x0 = small
    pbs = PB.build_normals(pbn, x0, FREE_WEIGHT)
    dbs = dataclasses.replace(pbs, **{
        k: torch.as_tensor(getattr(pbs, k), dtype=torch.float32)
        for k in ("Nii", "Nij", "Njj")})
    with pytest.raises(ValueError, match="inv64"):
        PS.DeviceSchurFactors(dbs, method="inv64")
    f = PS.DeviceSchurFactors(dbs, method="inv")
    assert f.device == torch.device("cpu") and not f.device_f64
    xi, _ = f.solve_device(pbs.bi, pbs.bj)
    assert xi.dtype == torch.float32


ADJUST = {"float64": {}, "float32": {"dtype": np.float32},
          "nested": {"block_super": "grid"}}


@pytest.mark.parametrize("branch", list(ADJUST))
def test_adjust_blocked_matches_jax(branch):
    rows, cols, blk, seed = NETS["16x16" if branch == "nested" else "12x12"]
    jbn, pbn, x0 = _networks(rows, cols, blk, seed)
    kw = dict(ADJUST[branch])
    if branch == "nested":
        kw["block_super"] = grid_super_assignment(rows, cols, blk, blk, 2, 2)
    xp, itp, mcp, hp = PB.adjust_blocked(pbn, x0, device=CPU, **kw)
    xj, itj, mcj, hj = JB.adjust_blocked(jbn, x0, **kw)
    assert itp == itj and mcp <= 0.0005
    assert len(hp) == itp
    tol = 1e-6 if branch == "nested" else 1e-8
    assert _dmax(xp, xj) < tol


def test_adjust_blocked_device_matches_jax(small):
    jbn, pbn, x0 = small
    xp, itp, mcp, hp = PD.adjust_blocked_device(pbn, x0, device=CPU)
    xj, itj, mcj, _ = JD.adjust_blocked_device(jbn, x0)
    x64, it64, _, _ = PB.adjust_blocked(pbn, x0, device=CPU)
    assert itp == itj == it64 and mcp <= 0.0005
    assert _dmax(xp, xj) < 1e-8 and _dmax(xp, x64) < 1e-8


def test_gn_step_matches_jax_on_the_same_factors(small):
    """One _gn_step on the JAX package's float32 factors against its
    _gn_step_jit: the rhs scatter, the refined apply, the correction
    scatter (junction stations set) and max|dx|."""
    jbn, pbn, x0 = small
    jadj = JD.DeviceAdjustment(JA.build_plan(jbn, FREE_WEIGHT))
    padj = PD.DeviceAdjustment(PA.build_plan(pbn, FREE_WEIGHT), device=CPU)
    factors = [torch.as_tensor(np.array(f)) for f in jadj.factors]
    xr, mr = jadj.step(jnp.asarray(x0))
    xp, mp = PD._gn_step(
        torch.as_tensor(x0), *factors, padj.Nii64, padj.Nij64, padj.Njj64,
        padj.pi, padj.pj, padj.obs, padj.weight, padj.bi1, padj.bi2,
        padj.bj1, padj.bj2, padj.inner_stn, padj.junc_stn, padj.jmap,
        padj.jmask32, padj.jmask64, padj.imask64, padj.owner64,
        padj.nj_total, padj.refine, padj.B, padj.ni, padj.nj)
    assert _dmax(xp.numpy(), np.asarray(xr)) < 1e-10
    assert abs(float(mp) - float(mr)) < 1e-10
    assert float(mp) > 0.1                 # a real first correction


def test_mesh_raises(small, tmp_path):
    """mesh= on adjust_blocked, schur_solve_refined and
    DeviceSchurFactors: the three run on a 2-rank gloo mesh (spawned
    ranks, tests/_torch_mesh_ranks.py) and land where the meshless runs
    do — the same iterations and 1e-10 m."""
    import pickle
    import _torch_mesh_ranks as ranks_mod
    from dynadjust_tpu_torch.parallel import multihost as mh
    _, pbn, x0 = small
    pbs = PB.build_normals(pbn, x0, FREE_WEIGHT)
    kw = {f.name: getattr(pbn, f.name) for f in dataclasses.fields(pbn)
          if f.init}
    bs = {f.name: getattr(pbs, f.name) for f in dataclasses.fields(pbs)
          if not f.name.startswith("_")}
    with open(tmp_path / "inputs.pkl", "wb") as f:
        pickle.dump({"bn": kw, "x0": x0, "bs": bs}, f)
    mh.spawn_ranks(ranks_mod.blocked_adjust_calls, 2,
                   f"file://{tmp_path}/store", device="cpu",
                   args=(str(tmp_path),), timeout=300)
    out = ranks_mod.load_ranks(tmp_path, 2)
    x, it = out[0]["adjust_blocked"]
    x1, it1, _, _ = PB.adjust_blocked(pbn, x0, device=CPU)
    assert it == it1 and _dmax(x, x1) <= 1e-10
    xi64, xj64 = PS.schur_solve(pbs, device=CPU)
    for key in ("refined", "factors"):
        xi, xj = out[0][key]
        assert _dmax(xi, xi64) <= 1e-10 and _dmax(xj, xj64) <= 1e-10, key
    for k in out[0]:
        for a, b in zip(out[1][k], out[0][k]):
            assert np.array_equal(a, b), k