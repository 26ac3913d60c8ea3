"""Card against CPU covariances of the nested path at two Newton
tolerances.

    python -m dynadjust_tpu_torch.tools.nested_newton_tol [TOL ...]

Runs the 24 x 24 mixed network (12 x 12 tiles) with super_blocks=2
through adjust_tpu_blocked on "cuda" and on "cpu" once for each
DTA_NEWTON_TOL (default: 1e-12, the port's, and 3e-9, the JAX package's
resident default) and prints one JSON line per tolerance: the largest
station-covariance difference relative to the largest covariance, the
sigma0 and xyz differences, and both runs' refinement evidence.  Needs a
CUDA card.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np
import torch

from ..adjust import AdjustmentOptions
from ..adjust.tpu_blocked import adjust_tpu_blocked
from ..utils.synthetic_mixed import synthetic_mixed_network


def compare(tol: str) -> dict:
    os.environ["DTA_NEWTON_TOL"] = tol
    out = {}
    for dev in ("cuda", "cpu"):
        net, seg = synthetic_mixed_network(24, 24, block_rows=12,
                                           block_cols=12)
        out[dev] = adjust_tpu_blocked(net, AdjustmentOptions(), seg=seg,
                                      super_blocks=2, device=dev)
    del os.environ["DTA_NEWTON_TOL"]
    g, c = out["cuda"], out["cpu"]
    return {"tol": float(tol),
            "cov_stn_rel": float(np.abs(g.cov_stn - c.cov_stn).max()
                                 / np.abs(c.cov_stn).max()),
            "sigma0": abs(g.sigma_zero - c.sigma_zero),
            "xyz_m": float(np.abs(g.xyz - c.xyz).max()),
            "evidence_cuda": g.refine_evidence,
            "evidence_cpu": c.refine_evidence}


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("nested_newton_tol: no CUDA device", file=sys.stderr)
        return 1
    for tol in argv or ["1e-12", "3e-9"]:
        print(json.dumps(compare(tol)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
