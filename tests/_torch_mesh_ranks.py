"""Rank bodies of the port's mesh tests: spawned gloo ranks on the CPU.

tests/test_torch_sharded.py and tests/test_torch_blocked_adjust.py write
their seeded inputs (numpy arrays, and the port's own network objects
carried over from the JAX package's) into a folder, then start W ranks
with dynadjust_tpu_torch.parallel.multihost.spawn_ranks.  Each rank runs
the functions below on its shard and saves what it got to
rank<r>.pkl; the test process holds the files to the JAX package's mesh
runs.  This module imports no JAX, and neither do the ranks.
"""

import os
import pickle
from pathlib import Path

import numpy as np


def _load(folder, name):
    with open(Path(folder) / name, "rb") as f:
        return pickle.load(f)


def _system(d):
    from dynadjust_tpu_torch.parallel.schur import BlockSystem
    return BlockSystem(**d)


def _save(folder, mesh, out):
    with open(Path(folder) / f"rank{mesh.rank}.pkl", "wb") as f:
        pickle.dump(out, f)


def sharded_cases(mesh, folder):
    """Every mesh route of the port on the inputs of `folder`."""
    from dynadjust_tpu_torch.adjust import AdjustmentOptions
    from dynadjust_tpu_torch.adjust.tpu_blocked import adjust_tpu_blocked
    from dynadjust_tpu_torch.parallel import multihost as mh
    from dynadjust_tpu_torch.parallel import schur as PS
    from dynadjust_tpu_torch.parallel.blocked_adjust import (BlockedNetwork,
                                                             adjust_blocked)
    inp = _load(folder, "inputs.pkl")
    out = {}
    small = _system(inp["small"])
    out["sharded"] = PS.schur_solve_sharded(small, mesh)
    grid = _system(inp["grid"])
    part = PS.build_nested_partition(grid, inp["grid_super"])
    out["nested"] = PS.schur_solve_nested(grid, part, mesh=mesh)
    out["nested_refined"] = PS.schur_solve_nested_refined(grid, part,
                                                          mesh=mesh)
    f = PS.DeviceSchurFactors(small, mesh=mesh)
    out["factors"] = f.solve(small.bi, small.bj, refine=2)
    bn = BlockedNetwork(**inp["bn"])
    out["adjust_blocked"] = adjust_blocked(bn, inp["x0"], mesh=mesh)[:2]
    out["adjust_blocked_f32"] = adjust_blocked(bn, inp["x0"], mesh=mesh,
                                               dtype=np.float32)[:2]
    for sb in (0, 4):
        net, seg = inp["mixed"]
        mh.reset_counts()
        r = adjust_tpu_blocked(net, AdjustmentOptions(), seg=seg,
                               super_blocks=sb, mesh=mesh)
        out[f"tpu_blocked_{sb}"] = dict(
            xyz=r.xyz, sigma_zero=r.sigma_zero, status=r.status,
            iterations=r.iterations, cov_stn=r.cov_stn,
            counts=dict(mh.COUNTS))
        inp = _load(folder, "inputs.pkl")     # a fresh network
    # the covariance stage past DTA_COV_DEV_BYTES (the refined level-1
    # pools gathered on the host) and on the device statistics route
    # (no dense covariance)
    os.environ.update(DTA_COV_DEV_BYTES="1", DTA_DENSE_COV_MAX_STN="0")
    try:
        for sb in (0, 4):
            net, seg = inp["mixed"]
            r = adjust_tpu_blocked(net, AdjustmentOptions(), seg=seg,
                                   super_blocks=sb, mesh=mesh)
            out[f"tpu_blocked_{sb}_host"] = dict(
                xyz=r.xyz, sigma_zero=r.sigma_zero, status=r.status,
                iterations=r.iterations, cov_stn=r.cov_stn)
            inp = _load(folder, "inputs.pkl")
    finally:
        for k in ("DTA_COV_DEV_BYTES", "DTA_DENSE_COV_MAX_STN"):
            os.environ.pop(k)
    _save(folder, mesh, out)


def blocked_adjust_calls(mesh, folder):
    """The three M5 calls that take a mesh: adjust_blocked,
    schur_solve_refined and DeviceSchurFactors."""
    from dynadjust_tpu_torch.parallel import schur as PS
    from dynadjust_tpu_torch.parallel.blocked_adjust import (BlockedNetwork,
                                                             adjust_blocked)
    inp = _load(folder, "inputs.pkl")
    bn = BlockedNetwork(**inp["bn"])
    bs = _system(inp["bs"])
    out = {"adjust_blocked": adjust_blocked(bn, inp["x0"], mesh=mesh)[:2],
           "refined": PS.schur_solve_refined(bs, mesh=mesh),
           "factors": PS.DeviceSchurFactors(bs, mesh=mesh).solve(bs.bi,
                                                                 bs.bj)}
    _save(folder, mesh, out)


def failing_rank(mesh, folder):
    """Rank 1 fails before the collective its peers wait in."""
    import torch
    from dynadjust_tpu_torch.parallel import multihost as mh
    if mesh.rank == 1:
        raise RuntimeError("rank 1 fails on purpose")
    mh.psum(torch.ones(1), mesh)


def load_ranks(folder, world):
    return [_load(folder, f"rank{r}.pkl") for r in range(world)]
