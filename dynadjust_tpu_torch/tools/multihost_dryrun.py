"""Multi-host dryrun: H "hosts" x L ranks each solve one blocked system
through the distributed Schur path and check it against the
single-device solve.

    python -m dynadjust_tpu_torch.tools.multihost_dryrun [--nproc 2]
        [--local-devices 2] [--rows 24] [--cols 24] [--block 6]
        [--out multihost.json] [--device cuda|cpu] [--backend gloo|nccl]

The ranks run on the card unless --device cpu asks for the CPU (gloo).
Parent mode (the default) spawns the W = nproc x local-devices ranks on
this machine (torch.multiprocessing, spawn; a file store in a temporary
folder): rank r on cuda:r over nccl when every rank has a card of its
own, else over gloo, ranks sharing the cards (NCCL refuses two ranks
on one card).  It waits for them with a time limit, and rank 0 writes
the summary JSON to --out.  Child mode (--process-id, with
--coordinator host:port) runs one rank of a group whose ranks are
started elsewhere, one process per card on each host (nccl).  Each rank assembles the SAME deterministic
synthetic GNSS system (utils/synthetic.py, seed 3), keeps only its block
shard, runs schur_solve_multihost over the flat one-axis mesh and the
hierarchical (hosts, blocks) mesh, and holds both to the single-device
schur_solve; then the mixed-measurement adjustment (12 x 12 stations,
4 x 4 tiles) through adjust_tpu_blocked over the flat mesh against the
same adjustment on one device.

Port of the JAX package's scripts/multihost_dryrun.py (processes x
virtual CPU devices there; ranks here, one per device).  The summary is
"ok" when both solves agree to 1e-8, the adjustment's xyz to 1e-8 m and
its sigma zero to 1e-9.
"""

import argparse
import json
import os
import sys
import tempfile

import numpy as np


def build_system(rows, cols, br, bc):
    from dynadjust_tpu_torch.parallel.blocked_adjust import (BlockedNetwork,
                                                             build_normals)
    from dynadjust_tpu_torch.utils.synthetic import (synthetic_grid_network,
                                                     grid_segmentation)
    xyz, pairs, obs, var, x0, fixed = synthetic_grid_network(rows, cols,
                                                             seed=3)
    blocks, junction = grid_segmentation(rows, cols, br, bc)
    bn = BlockedNetwork(nstations=rows * cols, pairs=pairs, obs=obs,
                        weight=1.0 / var, blocks=blocks,
                        junction_stations=junction, constrained=fixed)
    return build_normals(bn, x0, 0.01)


def run_rank(mesh, args):
    """One rank's dryrun; rank 0 writes the summary to args.out."""
    from dynadjust_tpu_torch.parallel import multihost as mh
    from dynadjust_tpu_torch.parallel.schur import schur_solve
    dev = mesh.device
    bs = build_system(args.rows, args.cols, args.block, args.block)
    # single-device reference (each rank computes it on its own device)
    xi_ref, xj_ref = schur_solve(bs, device=dev)

    results = {}
    xi, xj = mh.schur_solve_multihost(bs, mesh)
    results["flat"] = {
        "devices": int(mesh.size),
        "max_dxi": float(np.abs(xi - xi_ref).max()),
        "max_dxj": float(np.abs(xj - xj_ref).max()),
    }
    mesh_h = mh.hierarchical_block_mesh(args.local_devices, device=dev)
    xi, xj = mh.schur_solve_multihost(bs, mesh_h)
    results["hierarchical"] = {
        "mesh_shape": dict(mesh_h.shape),
        "max_dxi": float(np.abs(xi - xi_ref).max()),
        "max_dxj": float(np.abs(xj - xj_ref).max()),
    }
    mh.check_replicated(np.concatenate([xi.ravel(), xj]), mesh,
                        "the hierarchical solve")

    # the production adjustment (assembly, constraint elimination, device
    # assembly, sharded factors and refinement, statistics) across the
    # ranks, against the same adjustment on one device
    from dynadjust_tpu_torch.adjust import AdjustmentOptions
    from dynadjust_tpu_torch.adjust.tpu_blocked import adjust_tpu_blocked
    from dynadjust_tpu_torch.utils.synthetic_mixed import (
        synthetic_mixed_network)
    net1, seg1 = synthetic_mixed_network(12, 12, block_rows=4, block_cols=4)
    res_ref = adjust_tpu_blocked(net1, AdjustmentOptions(), seg=seg1,
                                 device=dev)
    net2, seg2 = synthetic_mixed_network(12, 12, block_rows=4, block_cols=4)
    res_mh = adjust_tpu_blocked(net2, AdjustmentOptions(), seg=seg2,
                                mesh=mesh)
    results["end_to_end_adjustment"] = {
        "stations": int(net1.nstations),
        "blocks": int(seg1.block_count),
        "iterations": int(res_mh.iterations),
        "iterations_single": int(res_ref.iterations),
        "max_dxyz_m": float(np.abs(res_mh.xyz - res_ref.xyz).max()),
        "d_sigma0": float(abs(res_mh.sigma_zero - res_ref.sigma_zero)),
        "max_dcov": float(np.abs(res_mh.cov_stn - res_ref.cov_stn).max()),
    }
    if mesh.rank == 0:
        e2e = results["end_to_end_adjustment"]
        out = {
            "ok": (all(r["max_dxi"] < 1e-8 and r["max_dxj"] < 1e-8
                       for k, r in results.items()
                       if k != "end_to_end_adjustment")
                   and e2e["max_dxyz_m"] < 1e-8
                   and e2e["d_sigma0"] < 1e-9
                   and e2e["iterations"] == e2e["iterations_single"]),
            "num_processes": args.nproc,
            "local_devices": args.local_devices,
            "ranks": int(mesh.size),
            "backend": mesh.backend,
            "device": str(dev),
            "blocks": int(bs.Nii.shape[0]),
            "nj_global": int(bs.nj_global),
            "results": results,
        }
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
        print(json.dumps(out))


def child(args):
    from dynadjust_tpu_torch.parallel import multihost as mh
    import torch
    import torch.distributed as dist
    world = args.nproc * args.local_devices
    torch.set_num_threads(1)
    if args.device == "cpu":
        backend, device = args.backend or "gloo", "cpu"
    else:
        ncard = torch.cuda.device_count()
        if ncard == 0:
            print("multihost dryrun: no CUDA card is present (pass "
                  "--device cpu to run on the CPU)", file=sys.stderr)
            return 1
        backend = args.backend or "nccl"
        device = f"cuda:{args.process_id % ncard}"
    mh.init_distributed(coordinator=args.coordinator, num_processes=world,
                        process_id=args.process_id, backend=backend,
                        device=device)
    try:
        run_rank(mh.global_block_mesh(), args)
    finally:
        dist.destroy_process_group()
    return 0


def parent(args):
    from dynadjust_tpu_torch.parallel import multihost as mh
    world = args.nproc * args.local_devices
    with tempfile.TemporaryDirectory() as tmp:
        try:
            mh.spawn_ranks(run_rank, world, f"file://{tmp}/store",
                           backend=args.backend,
                           device="cpu" if args.device == "cpu" else None,
                           args=(args,), timeout=args.timeout)
        except (RuntimeError, ValueError) as e:
            print(f"multihost dryrun failed: {e}", file=sys.stderr)
            return 1
    ok = json.load(open(args.out)).get("ok")
    print(f"multihost dryrun: ok={ok} -> {args.out}", file=sys.stderr)
    return 0 if ok else 1


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--nproc", type=int, default=2,
                    help="hosts (groups of ranks)")
    ap.add_argument("--local-devices", type=int, default=2,
                    help="ranks per host")
    ap.add_argument("--rows", type=int, default=24)
    ap.add_argument("--cols", type=int, default=24)
    ap.add_argument("--block", type=int, default=6)
    ap.add_argument("--process-id", type=int, default=None)
    ap.add_argument("--coordinator", default=None)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--backend", choices=("gloo", "nccl"), default=None,
                    help="default: nccl when every rank has a card of "
                         "its own, else gloo")
    ap.add_argument("--out", default="multihost.json")
    ap.add_argument("--timeout", type=float, default=600.0)
    args = ap.parse_args(argv)
    if args.process_id is not None and not args.coordinator:
        ap.error("--process-id needs --coordinator (host:port of rank 0)")
    args.out = os.path.abspath(args.out)
    if args.process_id is None:
        return parent(args)
    return child(args)


if __name__ == "__main__":
    sys.exit(main())
