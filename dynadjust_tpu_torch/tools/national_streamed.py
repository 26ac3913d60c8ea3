"""National-scale streamed solve: one three-level Schur solve of a
synthetic GNSS network whose level-1 factors live in host RAM.

    python -m dynadjust_tpu_torch.tools.national_streamed [ROWS COLS BLOCK SUPER]
        [--seed 7] [--weight 0.01] [--out DIR] [--device cpu]

The ROWS x COLS grid network (utils/synthetic.py, GNSS baselines) in
BLOCK x BLOCK tiles, its super-blocks SUPER x SUPER tiles each, has its
normals assembled on the host (build_normals at the free-station weight
--weight) and is solved by schur_solve_nested_factored(streamed=True,
refine=0, max_refine=3): chunks of C level-1 blocks go up to the device,
are factored by the Cholesky-inverse kernel at (C, ni) and refined in
float64 there (DTA_STREAMED_F64=1, the default), and come back as
float64 pools to host RAM, where the applies run.  Then one more apply
of the same factors (the reuse apply) and the relative residual of the
solution against the float64 normals.  The defaults, 448 448 32 4, are
the 200,704-station configuration (196 blocks of 3,072 inner
parameters).

Prints one JSON record (also written to DIR/streamed_<S>stn.json): the
network's size, the refinement evidence, the factor + refined solve and
reuse-apply seconds, the relative residual, the chunk size C with each
chunk's upload / compute / download ms, the bytes that really crossed
the link, the host RSS peak, the device memory peak and MemTotal.  Runs
on the card unless --device cpu; without a card and without --device
cpu it exits 1.

Port of the JAX package's scripts/national_streamed_demo.py.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from types import SimpleNamespace

import numpy as np
import torch

from .national_mixed import check_device, log, peak_rss_gb

DEFAULTS = (448, 448, 32, 4)


def mem_total_gb():
    """MemTotal of /proc/meminfo (GB), or None where there is none."""
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemTotal:"):
                    return int(line.split()[1]) * 1024 / 1e9
    except OSError:
        pass
    return None


def build(rows, cols, block, super_tiles, seed=7, weight=0.01):
    """(bn, bs, part): the network, its host normals and its nested
    partition."""
    from ..parallel.blocked_adjust import BlockedNetwork, build_normals
    from ..parallel.schur import build_nested_partition
    from ..utils.synthetic import (grid_segmentation, grid_super_assignment,
                                   synthetic_grid_network)
    S = rows * cols
    xyz, pairs, obs, var, x0, fixed = synthetic_grid_network(rows, cols,
                                                             seed=seed)
    blocks, junction = grid_segmentation(rows, cols, block, block)
    bn = BlockedNetwork(nstations=S, pairs=pairs, obs=obs,
                        weight=1.0 / var, blocks=blocks,
                        junction_stations=junction, constrained=fixed)
    bs = build_normals(bn, x0, weight)
    part = build_nested_partition(bs, grid_super_assignment(
        rows, cols, block, block, super_tiles, super_tiles))
    return bn, bs, part


def relative_residual(bs, xi, xj) -> float:
    """max|b − N x| / max(max|bi|, 1) against the float64 host normals."""
    from ..parallel.schur import _block_matvec, _gather_rhs_junction
    yi, yj = _block_matvec(bs, xi, xj)
    ri = np.abs(bs.bi * bs.imask - yi).max()
    rj = np.abs(_gather_rhs_junction(bs) - yj).max()
    return float(max(ri, rj) / max(np.abs(bs.bi).max(), 1.0))


def run(rows=DEFAULTS[0], cols=DEFAULTS[1], block=DEFAULTS[2],
        super_tiles=DEFAULTS[3], seed=7, weight=0.01, out=None,
        device="cuda"):
    """Build, solve streamed, re-apply and check; returns (solved,
    record).  solved holds xi, xj (the refined solve), xi_reuse,
    xj_reuse (the reuse apply), the factors, bs and part."""
    from ..parallel.schur import schur_solve_nested_factored
    device = check_device(device)
    S = rows * cols
    mem_total = mem_total_gb()
    log(f"building synthetic national network: {S} stations "
        f"(MemTotal {mem_total} GB)")
    t0 = time.time()
    bn, bs, part = build(rows, cols, block, super_tiles, seed, weight)
    t_build = time.time() - t0
    B, ni = bs.Nii.shape[:2]
    nj = bs.Njj.shape[1]
    log(f"{len(bn.pairs)} baselines, {B} blocks; assembly + partition "
        f"{t_build:.1f}s  Nii{bs.Nii.shape} Njj{bs.Njj.shape}; SB="
        f"{part.SB} ni2={part.ni2} nj2={part.nj2} nsj={part.nsj_global}")

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.time()
    xi, xj, factors = schur_solve_nested_factored(
        bs, part, refine=0, streamed=True, max_refine=3, device=device)
    t_solve = time.time() - t0
    moved = dict(factors._link.bytes)
    log(f"streamed factor+refined-solve {t_solve:.1f}s (chunk C="
        f"{factors.C})")

    t0 = time.time()
    xi2, xj2 = factors.solve(bs.bi, bs.bj)
    t_apply = time.time() - t0
    log(f"streamed apply (factor reuse, no refinement) {t_apply:.1f}s")

    t0 = time.time()
    rel = relative_residual(bs, xi, xj)
    t_resid = time.time() - t0
    scale = max(float(np.abs(xi).max()), float(np.abs(xj).max()), 1e-30)
    reuse = max(float(np.abs(xi2 - xi).max()),
                float(np.abs(xj2 - xj).max())) / scale
    log(f"relative residual {rel:.2e}; reuse apply vs solve {reuse:.2e} "
        f"of the largest correction")

    f64 = os.environ.get("DTA_STREAMED_F64", "1") != "0"
    tri = ni * (ni + 1) // 2
    gb = 1e9
    rec = {
        "stations": S, "baselines": int(len(bn.pairs)),
        "blocks": int(B), "ni": int(ni), "nj": int(nj),
        "super_blocks": int(part.SB), "nsj": int(part.nsj_global),
        "streamed": True,
        "f64_refined_factors": f64,
        "refine_evidence": getattr(factors, "cov_refine_evidence", None),
        "t_build_s": round(t_build, 1),
        "t_factor_refined_solve_s": round(t_solve, 1),
        "t_reuse_apply_s": round(t_apply, 1),
        "t_residual_s": round(t_resid, 1),
        "relative_residual": rel,
        "reuse_vs_solve_rel": reuse,
        "chunk_blocks": int(factors.C),
        "chunk_ms": [{k: round(v, 2) for k, v in c.items()}
                     for c in factors.chunk_ms],
        # the bytes that crossed the link in the factor pass, counted at
        # the copies, beside what its pools account for
        "transfer_ledger": {
            "up_gb": round(moved["up"] / gb, 3),
            "down_gb": round(moved["down"] / gb, 3),
            "up_tri_Nii64_gb": round(B * tri * 8 / gb, 3) if f64 else None,
            "up_Nij64_Njj64_gb": (round(B * (ni * nj + nj * nj) * 8 / gb, 3)
                                  if f64 else None),
            "down_tri_A64_gb": round(B * tri * 8 / gb, 3) if f64 else None,
            "down_Y64_gb": round(B * ni * nj * 8 / gb, 3) if f64 else None,
            "applies": ("host float64 (no link traffic)" if f64
                        else "float32 pools streamed on every apply")},
        "peak_host_rss_gb": round(peak_rss_gb(), 2),
        "mem_total_gb": round(mem_total, 1) if mem_total else None,
        "peak_device_gb": (torch.cuda.max_memory_allocated(device) / 1e9
                           if device.type == "cuda" else None),
        "device": (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else "cpu"),
    }
    if out is not None:
        os.makedirs(out, exist_ok=True)
        with open(os.path.join(out, f"streamed_{S}stn.json"), "w") as f:
            json.dump(rec, f, indent=1)
    solved = SimpleNamespace(xi=xi, xj=xj, xi_reuse=xi2, xj_reuse=xj2,
                             factors=factors, bs=bs, part=part)
    return solved, rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("size", nargs="*", type=int,
                    help="ROWS COLS BLOCK SUPER (default 448 448 32 4)")
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--weight", type=float, default=0.01,
                    help="free-station constraint weight")
    ap.add_argument("--out", default="national_streamed",
                    help="folder of the JSON record")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    if len(args.size) > 4:
        ap.error("at most ROWS COLS BLOCK SUPER")
    size = args.size + list(DEFAULTS)[len(args.size):]
    try:
        check_device(args.device)
    except RuntimeError as e:
        print(f"national_streamed: {e}", file=sys.stderr)
        return 1
    _, rec = run(*size, seed=args.seed, weight=args.weight, out=args.out,
                 device=args.device)
    print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
