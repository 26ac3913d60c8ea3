"""The port's mesh routes against the JAX package's, on the CPU.

The test process builds the seeded inputs with the JAX package — the
GNSS systems of tests/test_schur.py (12 x 12 stations in blocks of 4,
seed 1; 16 x 16 in blocks of 4, seed 3, grouped 2 x 2 into
super-blocks) and the 24 x 24 mixed network of
__graft_entry__.py:128-142 (6 x 6 tiles, 16 blocks), carried into the
port by network/data.py::from_reference — and writes them to a folder.
W = 4 gloo ranks (spawned processes that import no JAX,
tests/_torch_mesh_ranks.py) run every mesh route of the port on them
once per module; the JAX package runs the same routes over a 4-device
mesh of the 8 virtual CPU devices of tests/conftest.py.

Bounds: schur_solve_sharded 1e-10 against the JAX package's sharded
solve and 1e-8 against the dense solution (tests/test_schur.py:69);
schur_solve_nested(mesh=) 1e-8 against both packages' flat solves
(:184), its float32-refined form 1e-7 (:202); DeviceSchurFactors(mesh=)
.solve 1e-10 against float64 (:261); adjust_blocked(mesh=) the same
iterations and 1e-8 m; adjust_tpu_blocked(mesh=), super_blocks 0 and
4, against the JAX package's mesh run and the port's single-device run:
the same status and iterations, xyz 1e-8 m and sigma zero 1e-9
(__graft_entry__.py:133-142); the same two runs with the covariance
stage past DTA_COV_DEV_BYTES (pools gathered on the host) and on the
device statistics route, against the first two (xyz bitwise, sigma
zero 1e-9, cov_stn 1e-9 of its largest entry).  Every rank's results
are bitwise rank 0's.
"""

import pickle

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import jax
from jax.sharding import Mesh

from dynadjust_tpu.adjust import AdjustmentOptions as JOptions
from dynadjust_tpu.adjust.tpu_blocked import adjust_tpu_blocked as j_adjust
from dynadjust_tpu.parallel import blocked_adjust as JB
from dynadjust_tpu.parallel import schur as JS
from dynadjust_tpu.utils.synthetic import (grid_segmentation,
                                           grid_super_assignment,
                                           synthetic_grid_network)
from dynadjust_tpu.utils.synthetic_mixed import synthetic_mixed_network
from dynadjust_tpu_torch.adjust import AdjustmentOptions
from dynadjust_tpu_torch.adjust.tpu_blocked import adjust_tpu_blocked
from dynadjust_tpu_torch.network.data import from_reference
from dynadjust_tpu_torch.parallel import multihost as mh

import _torch_mesh_ranks as ranks_mod
from test_schur import _dense_solution

W = 4
FREE_WEIGHT = 0.01
FIELDS = ("Nii", "Nij", "Njj", "bi", "bj", "jmap", "jmask", "imask",
          "nj_global")


def _bn_kw(rows, cols, blk, seed):
    xyz, pairs, obs, var, x0, fixed = synthetic_grid_network(rows, cols,
                                                             seed=seed)
    blocks, junction = grid_segmentation(rows, cols, blk, blk)
    return dict(nstations=rows * cols, pairs=pairs, obs=obs,
                weight=1.0 / var, blocks=blocks, junction_stations=junction,
                constrained=fixed), x0


def _fields(bs):
    return {k: (getattr(bs, k) if k == "nj_global"
                else np.asarray(getattr(bs, k))) for k in FIELDS}


def _mixed():
    return synthetic_mixed_network(24, 24, block_rows=6, block_cols=6)


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    """(inputs, JAX-side systems, per-rank results)."""
    d = tmp_path_factory.mktemp("mesh")
    small_kw, x0 = _bn_kw(12, 12, 4, 1)
    grid_kw, gx0 = _bn_kw(16, 16, 4, 3)
    small = JB.build_normals(JB.BlockedNetwork(**small_kw), x0, FREE_WEIGHT)
    grid = JB.build_normals(JB.BlockedNetwork(**grid_kw), gx0, FREE_WEIGHT)
    inp = {"small": _fields(small), "grid": _fields(grid),
           "grid_super": grid_super_assignment(16, 16, 4, 4, 2, 2),
           "bn": small_kw, "x0": x0, "mixed": from_reference(*_mixed())}
    with open(d / "inputs.pkl", "wb") as f:
        pickle.dump(inp, f)
    mh.spawn_ranks(ranks_mod.sharded_cases, W, f"file://{d}/store",
                   device="cpu", args=(str(d),), timeout=400)
    return (inp, {"small": small, "grid": grid,
                  "small_bn": JB.BlockedNetwork(**small_kw)},
            ranks_mod.load_ranks(d, W))


@pytest.fixture(scope="module")
def jmesh():
    return Mesh(np.array(jax.devices()[:W]), ("blocks",))


def _dmax(a, b):
    return float(np.abs(np.asarray(a, np.float64)
                        - np.asarray(b, np.float64)).max())


def _stations(bn, xi, xj):
    """Per-station corrections from blocked (xi, xj)."""
    dx = np.zeros((bn.nstations, 3))
    for b, (inner, _) in enumerate(bn.blocks):
        dx[inner] = xi[b][:3 * len(inner)].reshape(-1, 3)
    dx[bn.junction_stations] = np.asarray(xj).reshape(-1, 3)
    return dx


def test_schur_solve_sharded_matches_jax(case, jmesh):
    inp, sys_, out = case
    bs, bn = sys_["small"], sys_["small_bn"]
    xi, xj = out[0]["sharded"]
    jxi, jxj = JS.schur_solve_sharded(bs, jmesh)
    assert _dmax(xi, jxi) <= 1e-10 and _dmax(xj, jxj) <= 1e-10
    dense = _dense_solution(bn, inp["x0"], FREE_WEIGHT).reshape(-1, 3)
    assert _dmax(_stations(bn, xi, xj), dense) <= 1e-8


def test_schur_solve_nested_sharded_matches_jax(case, jmesh):
    inp, sys_, out = case
    bs = sys_["grid"]
    part = JS.build_nested_partition(bs, inp["grid_super"])
    assert part.nsj_global < bs.nj_global     # really eliminated something
    jxi, jxj = JS.schur_solve_nested(bs, part, mesh=jmesh)
    fxi, fxj = JS.schur_solve(bs)
    xi, xj = out[0]["nested"]
    for ref_i, ref_j in ((jxi, jxj), (fxi, fxj)):
        assert _dmax(xi, ref_i) <= 1e-8 and _dmax(xj, ref_j) <= 1e-8
    rxi, rxj = out[0]["nested_refined"]
    assert _dmax(rxi, fxi) <= 1e-7 and _dmax(rxj, fxj) <= 1e-7


def test_device_schur_factors_mesh_reach_f64(case, jmesh):
    _, sys_, out = case
    bs = sys_["small"]
    xi64, xj64 = JS.schur_solve(bs)
    xi, xj = out[0]["factors"]
    assert _dmax(xi, xi64) <= 1e-10 and _dmax(xj, xj64) <= 1e-10
    # the JAX package's sharded factors land in the same place
    jxi, jxj = JS.DeviceSchurFactors(bs, mesh=jmesh).solve(bs.bi, bs.bj,
                                                           refine=2)
    assert _dmax(xi, jxi) <= 1e-10 and _dmax(xj, jxj) <= 1e-10


@pytest.mark.parametrize("dtype", ["f64", "f32"])
def test_adjust_blocked_mesh_matches_jax(case, jmesh, dtype):
    inp, sys_, out = case
    key = "adjust_blocked" if dtype == "f64" else "adjust_blocked_f32"
    x, it = out[0][key]
    jx, jit_, _, _ = JB.adjust_blocked(
        sys_["small_bn"], inp["x0"], mesh=jmesh,
        dtype=np.float64 if dtype == "f64" else np.float32)
    assert it == jit_
    assert _dmax(x, jx) <= 1e-8


@pytest.mark.parametrize("sb", [0, 4])
def test_adjust_tpu_blocked_mesh_matches_jax(case, jmesh, sb):
    _, _, out = case
    r = out[0][f"tpu_blocked_{sb}"]
    net, seg = _mixed()
    rj = j_adjust(net, JOptions(), seg=seg, mesh=jmesh, super_blocks=sb)
    pnet, pseg = from_reference(*_mixed())
    r1 = adjust_tpu_blocked(pnet, AdjustmentOptions(), seg=pseg,
                            super_blocks=sb, device="cpu")
    for ref in (rj, r1):
        assert r["status"] == ref.status == "Converged"
        assert r["iterations"] == ref.iterations
        assert _dmax(r["xyz"], ref.xyz) <= 1e-8
        assert abs(r["sigma_zero"] - ref.sigma_zero) <= 1e-9
    # the junction sums rode all_reduce, the shards came back by broadcast
    assert r["counts"]["all_reduce"] > 0 and r["counts"]["broadcast"] > 0


@pytest.mark.parametrize("sb", [0, 4])
def test_mesh_covariance_on_host_past_budget(case, sb):
    """DTA_COV_DEV_BYTES below the refined level-1 pools: the ranks gather
    them on the host, shard by shard, and the device statistics run on
    them; the result is the run that kept them on the device."""
    _, _, out = case
    r, ref = out[0][f"tpu_blocked_{sb}_host"], out[0][f"tpu_blocked_{sb}"]
    assert r["status"] == ref["status"] == "Converged"
    assert r["iterations"] == ref["iterations"]
    assert np.array_equal(r["xyz"], ref["xyz"])
    assert abs(r["sigma_zero"] - ref["sigma_zero"]) <= 1e-9
    scale = np.abs(ref["cov_stn"]).max()
    assert _dmax(r["cov_stn"], ref["cov_stn"]) <= 1e-9 * scale


def _same(a, b):
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, np.ndarray):
        return a.dtype == b.dtype and np.array_equal(a, b, equal_nan=True)
    return a == b


def test_every_rank_bitwise_rank0(case):
    _, _, out = case
    assert len(out) == W
    for r in range(1, W):
        for k in out[0]:
            assert _same(out[r][k], out[0][k]), (r, k)
