"""Smoke run of dynadjust_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Phases (each prints its elapsed seconds; any failure raises, and the
script exits non-zero without printing a result):

  1. card name and power limit; build every kernel from csrc/ (nvcc, one
     process per source, all started together) and the host kernel
     library (csrc/host_kernels.cpp, g++) and print the build times;
  2. kernel check: the Cholesky-inverse kernel against its plain PyTorch
     version on the card at the main path's level-1 shapes (SPD matrices
     from a seed; its float64 residual max|Linv N Linvᵀ − I| at most
     1e-4 and at most twice the plain version's), on the unaligned
     (3, 200, 70) batch of tests/test_blocked_chol.py against float64
     truth, and on an indefinite block whose status flag must be set;
     times the kernel, the plain version and torch.linalg.cholesky +
     solve_triangular, and profiles one call of the kernel with
     torch.profiler: time and grid launches of each __global__ function;
  3. two-level path: the 10,000-station mixed network (100 x 100,
     34 x 34 tiles, 9 blocks, seed 0) through adjust_tpu_blocked on the
     card, kernel launch counts zeroed just before and read just after;
     it must converge with the last solve at <= 1e-9 relative residual;
     then the same adjustment again under torch.profiler: the device
     time and busy share of the last (warm) iteration and the split of
     its factor phase (kernel, reduce_from_linv's products, junction);
  4. card against CPU: a 24 x 24 network (12 x 12 tiles) through the same
     entry point on "cuda" and on "cpu", held to xyz 1e-7 m, sigma0 1e-9
     and station covariances 1e-9 relative;
  5. kernel at the level-2 shape: the Cholesky-inverse kernel against
     its plain version at the nested path's super-block systems (4
     super-blocks of the grid grouping below; a super-block without
     inner-junction parameters is all identity), with the gates of
     phase 2, and timed against the plain version and the library;
  6. nested path: the same 10,000-station network with super_blocks=4
     and bench.py's grid grouping (2 x 2 super-tiles), cold and then
     warm, counts zeroed before each run and read after it; it must
     converge in the two-level run's iteration count, with xyz within
     1e-6 m of it, the last solve at <= 1e-9, refinement residuals
     l1_err and l3_err < 1e-8, and the kernel launched at level 1 and at
     level 2 in every iteration; then the nested adjustment under
     torch.profiler: the warm iteration's device split of the factor
     (level-1 kernel and products, level-2 kernel and products,
     level-3 inverse);
  7. nested card against CPU: the 24 x 24 network with super_blocks=2,
     on the one-pass factor route and on the staged route
     (DTA_NESTED_FUSE_BYTES=0), with the bounds of phase 4;
  8. cli: the port's command line (dynadjust_tpu_torch.cli.main,
     in-process so that the launch counts can be read; the first import
     as a `python -m dynadjust_tpu_torch` subprocess) on DNA files
     written by the port's dna_writer.  1,600 stations (40 x 40, seed 0):
     import, segment --min-inner-stns 300 --max-block-stns 600 and one
     adjust per route, each after a fresh import and segment: host
     float64, --tpu (the dense solve: the kernel at (1, 3S) once per
     iteration), --phased --tpu, and --phased --tpu --tpu-super-blocks 2;
     all converge in the same iterations with sigma zero 0.999 (the JAX
     package's CLI on the same files) and PASSED, .xyz files within 1e-4
     of the host route's number by number and the saved xyz within
     1e-6 m of it.  10,000 stations: import, segment --min-inner-stns
     600 --max-block-stns 1200 and adjust --phased --tpu, held to the
     in-memory two-level run's iterations and to adjust_tpu_blocked
     called directly on the saved network and segmentation with
     super_blocks=4 (xyz within 1e-6 m); its .results.pkl (past the
     dense-covariance cap) loads back without torch.  Block 1 at 1,600
     stations, each after a fresh import and segment: adjust
     --block1-phased on the host, and --block1-phased --tpu with and
     without --staged-adjustment --create-stage-files, which launch the
     kernel once per block at (1, 3 n_b) and are held to the host route:
     saved xyz within 1e-6 m, .xyz numbers within 1e-4, the same status
     line.  Every device solve of the dense and block-1 routes (and of
     the pipeline's --tpu route) prints its Newton record: shape, route,
     Newton rounds and last residual; each must take the kernel's route
     (no float64 fallback on these well-conditioned systems) in 2 to 12
     rounds.  Each verb is timed, write_adj on its own;
  9. pipeline: the reftran and geoid stages and the pipeline verb, on
     DNA files whose stations carry ellipsoidal heights (LLh) and whose
     level differences are orthometric for a seeded 1' NTv2 grid (N 3-7
     m, deflections <= 1.5"), written with write_gsb.  1,600 stations
     verb by verb: import (no -r), reftran -r ITRF2014 -e 01.01.2024
     (the largest and smallest station shift printed), geoid
     --convert-stn-hts, segment --min-inner-stns 300 --max-block-stns
     600, then adjust --output-adj-msr --output-json on the host route
     and with --export-snx --export-xml too on the --tpu and --phased
     --tpu routes: each device route within 1e-6 m of the host route's
     saved xyz, its .xyz and .adj.jsonl numbers within 1e-4 of the host
     route's and its .adj.jsonl variances within PIPE_COV_TOL m^2 of
     them, the same iterations, sigma zero 1.000 (the JAX package's
     CLI on the same files) and PASSED, and the port's diff verb on the
     .adj files (-t 1e-4 --skip-to-marker "M Station 1") exiting 0; the
     blocked route's .snx and .adjusted.stn.xml numbers within 1e-4 of
     the dense route's, the .snx covariances within PIPE_COV_TOL m^2
     (its covariances of stations in different blocks
     are 0 by design, and checked to be so); the host route launches no
     kernel.  10,000 stations through dynadjust alone (-r ITRF2014 -e
     01.01.2024 -g grid --convert-stn-hts --phased --tpu
     --min-inner-stns 600 --max-block-stns 1200 --output-json; no
     --export-snx at this size, whose 2.84 GB file took 103-144 s):
     five done stages in dynadjust.log, PASSED, the
     kernel launched, the same iterations as and xyz within 1e-6 m of
     adjust_tpu_blocked(super_blocks=4) on the network that the verb's
     first four stages save (run again with --import --reftran --geoid
     --segment), and the results pickle loaded with torch classes
     refused.  Each verb and stage is timed;
 10. formats: the binary and simulated inputs through the CLI.  1,600
     stations: import --export-bst-bms, a fresh project imported from
     the .bst/.bms pair (its .dbid beside it; the saved network equal to
     the DNA import's), segment and adjust --phased --tpu, held to phase
     8's DNA import on that route (the same iterations, saved xyz within
     1e-9 m), and metadata of both files; import --simulate, the
     stations imported with <net>.simulated.msr, segment and adjust
     --phased --tpu: max_corr < 5e-4 m and sigma zero < 0.01.  10,000
     stations: import --export-bst-bms and the import of the pair, the
     same stations and records with equal coordinates and values; bytes
     and seconds printed;
 11. kernel at every (B, n) that the CLI, pipeline and formats routes of
     phases 8-10 and the F9 routes launched it at (the dense (1, 3S), the
     block-1 systems (1, 3 n_b), the level-1 blocks of the CLI's
     segmentation at 1,600 and 10,000 stations, and the level-2 systems
     of --tpu-super-blocks 2), with the gates of phase 2, each timed
     against the plain version and the library;
 12. one {"kernels": [...]} line, the card line, and the result line.

Host routes and the GNSS-only adjustment (run between phases 7 and 8;
each adjustment of the host routes prints its
DTA_PROFILE phases, the host residual operator's calls and seconds, the
device memory peak and the host RSS peak so far):

  staged: the 10,000-station network nested (super_blocks=4, the grid
     grouping) with staged=True — level-1 factors in page-locked host
     RAM, streamed through the card in chunks — on both DTA_STREAMED_F64
     routes; each prints its chunk size C, the kernel's shape and every
     chunk's upload/compute/download ms, and is held to the resident
     nested run: same iterations, xyz within 1e-6 m, sigma zero within
     1e-9, station covariances within 1e-9 relative, refinement
     residuals l1_err and l3_err < 1e-8;
  host assembly: the 10,000-station network two-level with
     DTA_HOST_ASSEMBLY=1 (the host normals, their float32 casts uploaded,
     the host refinement loop over the host residual operator), held to
     the device-assembled run likewise;
  national: 40,000 stations (200 x 200, 36 blocks) two-level in the
     default environment — its float64 design pool is past
     DTA_DEVICE_SOLVE_BYTES, so the solve takes the host refinement
     loop — held likewise to the same network with DTA_DEVICE_SOLVE=1
     (the device refined solve);
  national_mixed: tools/national_mixed.py at the JAX package's national
     configuration (320 x 320 = 102,400 stations, 420,055 records, 400
     tiles of 16, 16 super-blocks in a 4 x 4 grid, resident), the
     writers (.adj, .xyz, .apu) timed each in a temporary folder; the
     route the default rule picks is printed with its float64 design
     pool against DTA_DEVICE_SOLVE_BYTES; held to the JAX package's
     committed result (artifacts/national_run_v3, carried per station
     in tools/national_102400_ref.npz): 3 iterations, Converged, PASSED,
     sigma zero within 2e-4 of 0.9989, every station's X, Y, Z and
     SD(e, n, up) within 1e-4 m; the last solve_rel <= 1e-9 on the
     device refined solve, l1_err and l3_err < 1e-8; its pools are past
     DTA_NESTED_FUSE_BYTES, so level 1 is factored in chunks of 16
     blocks, the kernel at (16, 768) 25 times in every iteration (level
     2 through the recursive inverse, as in the JAX package); then the
     one-pass route (DTA_NESTED_FUSE_BYTES past the pools), the kernel
     at (400, 768) and at level 2 (16, n2) once in every iteration,
     held to the first run (same iterations, xyz within 1e-6 m, sigma
     zero within 1e-9, station covariances within 1e-9 relative);
  national_streamed: tools/national_streamed.py at the JAX package's
     streamed configuration (448 x 448 = 200,704 stations, 600,321
     baselines, 196 blocks of 3,072 inner parameters, 16 super-blocks,
     DTA_STREAMED_F64 at its default), host MemTotal printed first:
     relative residual <= 1e-10, the refinement evidence inline with
     l1/l2/l3 errors <= 1e-10 (the artifact's tolerance), the reuse
     apply within 1e-10 of the first solve, the kernel at (C, 3072) on
     every chunk; each chunk's upload / compute / download ms, the bytes
     that crossed the link and the host RSS peak printed;
  native: the host kernel library's blocked matvec against its numpy
     version (the host loop's operator) at the 10k network's
     host-assembly shapes, and its GNSS baseline residuals against
     theirs at the 10,000-station GNSS network's 29,601 baselines, 1e-12
     relative, seconds per call of each, each timed alone and right
     after the other;
  gnss: the GNSS-only blocked adjustment (parallel/blocked_adjust.py,
     assembly.py, device_adjust.py) on bench.py's network (BENCH_MODE=gnss
     defaults: 64 x 64 stations, 12,033 baselines, 16 blocks) and on
     100 x 100 stations in blocks of 25 (29,601 baselines, level 1 at
     (16, 1875)), seed 7: build_plan, the device-resident Gauss-Newton
     loop (DeviceAdjustment: setup = upload + one factorization, one
     kernel launch, no jittered retry; counts zeroed just before and read
     just after) held to the float64 adjust_blocked on the card (the same
     iterations, xyz within 1e-6 m, max_corr <= 5e-4 m), the kernel's
     status on the network's own scaled blocks, one step and 20 steps
     with no host sync (CUDA events), the torch.profiler split of one
     step, schur_solve_device with each DeviceSchurFactors method
     ("inv", "chol", "inv64") against the float64 schur_solve (1e-9 of
     the largest correction) with bench.py's factor + apply and
     apply-only seconds, and the kernel held at the level-1 shape; then
     ROADMAP.md F9's network (the 6 x 6 mixed network, import --simulate,
     the simulated records imported, segment --min-inner-stns 10
     --max-block-stns 20) through adjust --block1-phased on the host and
     with --tpu (± staged): block 1 on the float64 route, named in the
     Newton records, within 1e-6 m of the host route;
  cli (in phase 8): --phased --tpu --staged-adjustment
     --create-stage-files with and without --tpu-super-blocks 2, held
     also to their resident counterparts (.xyz within 1e-4, saved xyz
     within 1e-6 m), and the host sequential phased adjustment
     (--phased, and --staged-adjustment --create-stage-files
     --purge-stage-files without --tpu), which launch no kernel;
  and the kernel held at every new (B, n) these routes launched it at;
  mesh (parallel/multihost.py): the two-level and the nested runs of
     phases 3 and 6 over one nccl rank on the card (in this process) and
     over four spawned gloo ranks sharing it (9 blocks padded to 12, 3
     per rank), kernel launches and collectives zeroed just before each
     run and read just after; each rank's run held to the single-device
     run of its path (the same iterations, xyz within 1e-8 m, sigma zero
     within 1e-9, __graft_entry__.py:133-142) and bitwise to rank 0's;
     each gloo rank holds the kernel at its shard shapes (phase 2's
     gates) and times it on the shared card; each run prints its wall
     time and its all_reduce and broadcast calls and bytes per
     iteration; then the cli's 1,600-station files through adjust
     --phased --tpu --devices 1 held to --phased --tpu, and --devices 2
     on a one-card machine must exit 1 naming the visible cards.

Needs one card; exits non-zero when torch.cuda.is_available() is false.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import pickle
import re
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from dynadjust_tpu_torch import cli, project
from dynadjust_tpu_torch.adjust import AdjustmentOptions
from dynadjust_tpu_torch.adjust.tpu_blocked import (_build_partition,
                                                    adjust_tpu_blocked)
from dynadjust_tpu_torch.ops import kernels, native
from dynadjust_tpu_torch.ops.chol_inv import (batched_cholesky_inverse,
                                              cholesky_inverse_plain,
                                              fused_block_reduce)
from dynadjust_tpu_torch.io_formats.dna_writer import (write_dna_msr,
                                                       write_dna_stn)
from dynadjust_tpu_torch.adjust.device_assembly import DeviceAssembly
from dynadjust_tpu_torch.parallel import schur, streamed
from dynadjust_tpu_torch.parallel.assembly import build_plan
from dynadjust_tpu_torch.parallel.blocked_adjust import (BlockedNetwork,
                                                         adjust_blocked,
                                                         build_normals)
from dynadjust_tpu_torch.parallel.device_adjust import DeviceAdjustment
from dynadjust_tpu_torch.parallel.schur import (DeviceSchurFactors,
                                                build_nested_partition,
                                                schur_solve,
                                                schur_solve_device)
from dynadjust_tpu_torch.segment import Segmentation
from dynadjust_tpu_torch.tools import national_mixed, national_streamed
from dynadjust_tpu_torch.utils.synthetic import (grid_segmentation,
                                                 grid_super_assignment,
                                                 synthetic_grid_network)
from dynadjust_tpu_torch.utils.synthetic_mixed import synthetic_mixed_network
from dynadjust_tpu_torch.utils.synthetic_geoid import (orthometric_levelling,
                                                       synthetic_geoid_grid)
from dynadjust_tpu_torch.geoid.gridtools import write_gsb
from dynadjust_tpu_torch.geodesy.conversions import geo_to_cart

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
PEAK_FP32_FLOPS = 67e12          # non-tensor float32
PEAK_TF32_FLOPS = 495e12         # tensor cores, TF32
PEAK_BYTES = 3.35e12             # HBM3

KERNEL_REL_TOL = 2e-5    # kernel vs plain, max|dLinv| / max|Linv|: both
                         # float32, differing only in summation order
RESID_TOL = 1e-4         # max|Linv N Linvᵀ − I| in float64 (f32 factor)
TRUTH_REL_TOL = 5e-5     # tests/test_blocked_chol.py's f32 bound


def _say(*a):
    print(*a, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()


def _check(ok: bool, what: str):
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def _time_ms(fn, reps: int = 3) -> float:
    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def _global_functions(source: str) -> list:
    """Names of the __global__ functions of a csrc/ source."""
    text = (kernels.CSRC / source).read_text()
    return re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)"
                      r"\s+)?(\w+)", text)


def _kernel_split(prof, names) -> dict:
    """{function: {"ms": total device ms, "launches": grids}} of the
    device kernels in a profile whose name holds one of `names`."""
    from torch.autograd import DeviceType
    out = {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        for nm in names:
            if re.search(rf"\b{nm}\b", e.name):
                d = out.setdefault(nm, {"ms": 0.0, "launches": 0})
                d["ms"] += e.time_range.elapsed_us() / 1e3
                d["launches"] += 1
                break
    return out


def profile_kernel(fn, source: str) -> dict:
    """One call of `fn` (warm) under torch.profiler on the card: total
    time and grid launches of every __global__ function of `source`."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    split = _kernel_split(prof, _global_functions(source))
    _check(bool(split), f"the profile shows the kernels of {source}")
    _say("kernel profile (one call): " + "  ".join(
        f"{k}: {v['ms']:.3f} ms / {v['launches']} grids"
        for k, v in split.items()))
    return split


def _grid_grouping(rows, cols, tile, super_blocks):
    """bench.py's grid-aware block -> super-block assignment."""
    g = max(1, int(round(super_blocks ** 0.5)))
    tr = (rows + tile - 1) // tile
    tc = (cols + tile - 1) // tile
    return grid_super_assignment(rows, cols, tile, tile,
                                 (tr + g - 1) // g, (tc + g - 1) // g)


def _main_path_shapes(rows, cols, tile, block_super):
    """(B, ni) of the level-1 blocks the main path factors, the nested
    path's level-2 systems: (SB, ni2) and the number of real
    inner-junction parameters of each super-block, and the largest
    block's junction parameters nj."""
    net, seg = synthetic_mixed_network(rows, cols, block_rows=tile,
                                       block_cols=tile)

    class _Stations:
        def __init__(self, b):
            self.stations = seg.parameter_stations(b)

    _, part = _build_partition(
        net.nstations, [_Stations(b) for b in range(seg.block_count)])
    B = seg.block_count
    nj = max(len(p[2]) for p in part)
    njg = max(int(p[2].max()) for p in part if len(p[2])) + 1
    jmap = np.full((B, nj), njg, dtype=np.int32)
    jmask = np.zeros((B, nj))
    for b, p in enumerate(part):
        jmap[b, :len(p[2])] = p[2]
        jmask[b, :len(p[2])] = 1.0
    npart = build_nested_partition(
        type("Topology", (), {"jmap": jmap, "jmask": jmask,
                              "nj_global": njg}), block_super)
    _say(f"nested partition: {npart.SB} super-blocks of {npart.ni2} "
         f"inner-junction slots, {npart.nsj_global} super-junction "
         f"parameters of {njg} junction parameters")
    return ((B, max(len(p[0]) for p in part)),
            (npart.SB, npart.ni2, npart.i2mask.sum(axis=1).astype(int)),
            nj)


def _spd(B, n, seed=0):
    """(B, n, n) float64 SPD matrices on the card, from a seed."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    G = torch.randn(B, 2 * n, n, device="cuda", generator=g,
                    dtype=torch.float64)
    eye64 = torch.eye(n, device="cuda", dtype=torch.float64)
    return G.transpose(1, 2) @ G / (2 * n) + 0.5 * eye64


def _hold_kernel(N64):
    """The kernel against its plain version on the float32 copy of the
    SPD batch N64, with the gates of phase 2, then timed against the
    plain version and the library pair; the bound of its work."""
    dev = "cuda"
    B, n = N64.shape[0], N64.shape[1]
    eye64 = torch.eye(n, device=dev, dtype=torch.float64)
    N = N64.to(torch.float32)
    Lk, sk = batched_cholesky_inverse(N)
    Lp, sp = cholesky_inverse_plain(N)
    torch.cuda.synchronize()
    abs_err = float((Lk - Lp).abs().max())
    rel = abs_err / float(Lp.abs().max())

    def residual(L):
        L64 = L.to(torch.float64)
        return float((L64 @ N64 @ L64.transpose(1, 2) - eye64).abs().max())

    resid, resid_plain = residual(Lk), residual(Lp)
    del N64
    _say(f"kernel ({B}, {n}): max|kernel-plain| {abs_err:.3e} "
         f"(rel {rel:.3e} <= {KERNEL_REL_TOL:g}), "
         f"max|Linv N Linv^T - I| {resid:.3e} (<= {RESID_TOL:g} and <= "
         f"2 x the plain version's {resid_plain:.3e}), "
         f"status {int(sk.sum())}/{int(sp.sum())}")
    _check(rel <= KERNEL_REL_TOL, f"kernel vs plain rel {rel}")
    _check(resid <= RESID_TOL, f"kernel residual {resid}")
    _check(resid <= 2.0 * resid_plain,
           f"kernel residual {resid} against the plain {resid_plain}")
    _check(int(sk.sum()) == 0 and int(sp.sum()) == 0, "SPD status clean")

    reps = 3 if n > 1024 else 20         # small calls: more repeats
    ms = _time_ms(lambda: batched_cholesky_inverse(N), reps)
    plain_ms = _time_ms(lambda: cholesky_inverse_plain(N), reps=1)
    eye32 = torch.eye(n, device=dev).expand(B, n, n)
    library_ms = _time_ms(lambda: torch.linalg.solve_triangular(
        torch.linalg.cholesky(N), eye32, upper=False), reps)
    flops = B * 2.0 * n ** 3 / 3.0           # chol n^3/3 + tri-inverse n^3/3
    nbytes = 2.0 * B * n * n * 4             # read Nii, write Linv
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES
    bound_ms = 1e3 * max(t_ops, t_bytes)
    # the tile products as 3xTF32 tensor-core products: three TF32
    # products for each float32 one
    tc_bound_ms = 1e3 * max(3.0 * flops / PEAK_TF32_FLOPS, t_bytes)
    _say(f"kernel ms {ms:.3f}  plain ms {plain_ms:.3f}  library ms "
         f"{library_ms:.3f}  bound ms {bound_ms:.3f} (3xTF32 "
         f"{tc_bound_ms:.3f}) ({flops:.3e} flop, {nbytes:.3e} bytes)")
    return N, {"max_abs_err": abs_err, "ms": ms, "plain_ms": plain_ms,
               "library_ms": library_ms, "bound_ms": bound_ms,
               "bound_by": "operations" if t_ops >= t_bytes else "bytes",
               "tc_bound_ms": tc_bound_ms}


def phase_kernel(B, n):
    dev = "cuda"
    N, held = _hold_kernel(_spd(B, n))
    split = profile_kernel(lambda: batched_cholesky_inverse(N),
                           "chol_inv.cu")

    # the unaligned batch of tests/test_blocked_chol.py vs float64 truth
    rng = np.random.default_rng(3)
    b3, ni, nj = 3, 200, 70
    A = rng.normal(size=(b3, ni, ni))
    Nii = A @ A.transpose(0, 2, 1) + ni * np.eye(ni)
    Nij = rng.normal(size=(b3, ni, nj))
    Njj0 = rng.normal(size=(b3, nj, nj))
    Njj = Njj0 + Njj0.transpose(0, 2, 1)
    Ainv = np.linalg.inv(Nii)
    Y = Ainv @ Nij
    truth = (Ainv, Y, Njj - Nij.transpose(0, 2, 1) @ Y)
    out = fused_block_reduce(*(torch.tensor(x, dtype=torch.float32,
                                            device=dev)
                               for x in (Nii, Nij, Njj)))
    for name, got, want in zip(("Ainv", "Y", "S"), out[:3], truth):
        r = np.abs(got.double().cpu().numpy() - want).max() / \
            np.abs(want).max()
        _say(f"(3, 200, 70) {name}: rel {r:.3e} (<= {TRUTH_REL_TOL:g})")
        _check(r <= TRUTH_REL_TOL, f"(3,200,70) {name} rel {r}")

    bad = torch.tensor(Nii, dtype=torch.float32, device=dev)
    bad[1] = -torch.eye(ni, device=dev)
    st = batched_cholesky_inverse(bad)[1].tolist()
    _say(f"indefinite block 1: status {st}")
    _check(st == [0, 1, 0], f"indefinite status {st}")
    return {**held, "split": split}


def phase_kernel_level2(SB, ni2, n_real):
    """The kernel at the nested path's level-2 shape: super-block k holds
    an SPD system on its n_real[k] inner-junction slots and identity on
    the rest (all identity where n_real[k] is 0), as the factor's
    identity padding makes it."""
    N64 = torch.eye(ni2, dtype=torch.float64, device="cuda").repeat(
        SB, 1, 1)
    for k, n in enumerate(n_real):
        if n:
            N64[k, :n, :n] = _spd(1, int(n), seed=k + 1)[0]
    _say(f"level-2 systems ({SB}, {ni2}): real inner-junction "
         f"parameters {list(map(int, n_real))}")
    _check(min(n_real) == 0, "one super-block is all identity")
    return _hold_kernel(N64)[1]


@contextlib.contextmanager
def _host_route_probes():
    """Counts and times the float64 host residual operator of the host
    refinement loops (DeviceAssembly.matvec, schur._block_matvec: one
    call per refinement round plus one per solve) and keeps every
    host-streamed factor object built, for the chunk size and the
    per-chunk copy/compute times.  Measurement only: the operators and
    factors run unchanged."""
    info = {"matvec_calls": 0, "matvec_s": 0.0, "streamed": []}
    orig_da, orig_bm = DeviceAssembly.matvec, schur._block_matvec
    orig_sf = streamed.StreamedNestedSchurFactors

    def timed(fn):
        def run(*a, **k):
            t = time.perf_counter()
            out = fn(*a, **k)
            info["matvec_calls"] += 1
            info["matvec_s"] += time.perf_counter() - t
            return out
        return run

    class Recorded(orig_sf):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            info["streamed"].append(self)

    DeviceAssembly.matvec = timed(orig_da)
    schur._block_matvec = timed(orig_bm)
    streamed.StreamedNestedSchurFactors = Recorded
    try:
        yield info
    finally:
        DeviceAssembly.matvec, schur._block_matvec = orig_da, orig_bm
        streamed.StreamedNestedSchurFactors = orig_sf


def phase_main(rows, cols, tile, label="two-level", **kw):
    """One adjustment of a mixed network through the entry point, counts
    zeroed just before and read just after: (result, launches, launches
    per (B, n), host-route probes).  The device refined solve must end at
    <= 1e-9 relative residual; the host loops record no residual."""
    os.environ["DTA_PROFILE"] = "1"
    net, seg, truth = synthetic_mixed_network(rows, cols, block_rows=tile,
                                              block_cols=tile, seed=0,
                                              return_truth=True)
    _say(f"{label} path: {net.nstations} stations, "
         f"{len(net.measurements)} records, {seg.block_count} blocks")
    torch.cuda.reset_peak_memory_stats()
    batched_cholesky_inverse.launches = 0
    batched_cholesky_inverse.shapes = {}
    t0 = time.perf_counter()
    with _host_route_probes() as info:
        res = adjust_tpu_blocked(net, AdjustmentOptions(), seg=seg,
                                 device="cuda", **kw)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = batched_cholesky_inverse.launches
    shapes = dict(batched_cholesky_inverse.shapes)
    del os.environ["DTA_PROFILE"]
    log = res.iteration_log
    err = float(np.abs(res.xyz - truth).max())
    _say(f"status {res.status}, {res.iterations} iterations, sigma0 "
         f"{res.sigma_zero:.6f}, wall {wall:.2f} s; route "
         f"{res.profile['route']}")
    for e in log:
        solve = (f" solve_rel {e['solve_rel']:.3e} solve_rounds "
                 f"{e['solve_rounds']}" if "solve_rel" in e else "")
        _say(f"  iteration {e['iteration']}: max_corr {e['max_corr']:.3e} "
             f"elapsed {e['elapsed']:.3f} s{solve}")
    prev = {}
    for e in log:
        ph = e["phases"]
        _say(f"  phases it {e['iteration']}: " + "  ".join(
            f"{k}={ph[k] - prev.get(k, 0.0):.3f}" for k in ph))
        prev = ph
    _say(f"  stats sub-phases: {res.profile.get('stats_sub')}")
    _say(f"  refine evidence: {res.refine_evidence}")
    _say(f"  host residual operator: {info['matvec_calls']} calls, "
         f"{info['matvec_s']:.3f} s; device memory peak "
         f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB; host RSS peak "
         f"so far {national_mixed.peak_rss_gb():.2f} GB")
    _say(f"first iteration {log[0]['elapsed']:.3f} s, warm (last) "
         f"iteration {log[-1]['elapsed']:.3f} s; max|xyz - truth| "
         f"{err:.4f} m; chol_inv launches {launches} by (B, n) "
         f"{shapes}")
    _check(res.status == "Converged", f"status {res.status}")
    if "solve_rel" in log[-1]:
        _check(log[-1]["solve_rel"] <= 1e-9,
               f"last solve_rel {log[-1]['solve_rel']}")
    _check(np.isfinite(res.xyz).all() and np.isfinite(res.cov_stn).all(),
           "finite results")
    err0 = float(np.abs(res.initial_xyz - truth).max())
    _check(err < 0.5 * err0, f"adjusted-vs-truth {err} m against the "
           f"initial {err0} m")
    _check(launches > 0, f"chol_inv launched on the {label} path")
    info["wall"] = wall
    return res, launches, shapes, info


def _hold_to(res, ref, what, xyz_tol=1e-6):
    """Gate one adjustment against another of the same network: the same
    iterations, xyz within xyz_tol m, sigma zero within 1e-9 and station
    covariances within 1e-9 relative."""
    dx = float(np.abs(res.xyz - ref.xyz).max())
    ds = abs(res.sigma_zero - ref.sigma_zero)
    dc = float(np.abs(res.cov_stn - ref.cov_stn).max()
               / np.abs(ref.cov_stn).max())
    _say(f"{what}: {res.iterations} iterations ({ref.iterations}), xyz "
         f"{dx:.3e} m (<= {xyz_tol:g}), sigma0 {ds:.3e} (<= 1e-9), "
         f"cov_stn rel {dc:.3e} (<= 1e-9)")
    _check(res.iterations == ref.iterations, f"{what}: iterations")
    _check(dx <= xyz_tol and ds <= 1e-9 and dc <= 1e-9, f"{what}: bounds")


def phase_national(rows, cols, tile):
    """The 40,000-station network two-level in the default environment:
    its float64 design pool is past DTA_DEVICE_SOLVE_BYTES, so the solve
    takes the host refinement loop; held to the forced device solve
    (DTA_DEVICE_SOLVE=1) of the same network."""
    host, l_h, sh_h, info_h = phase_main(rows, cols, tile,
                                         label="national (host loop)")
    route = host.profile["route"]
    budget = 8e9
    _say(f"national design pool {route['pool_bytes']:.4e} B against "
         f"DTA_DEVICE_SOLVE_BYTES {budget:.0e}: solve {route['solve']}")
    _check(route["solve"] == "host loop" and route["pool_bytes"] > budget,
           f"the national network takes the host loop ({route})")
    _check(info_h["matvec_calls"] > 0, "the host loop ran its operator")
    os.environ["DTA_DEVICE_SOLVE"] = "1"
    try:
        dev, l_d, sh_d, _ = phase_main(rows, cols, tile,
                                       label="national (forced device)")
    finally:
        del os.environ["DTA_DEVICE_SOLVE"]
    _check(dev.profile["route"]["solve"] == "device", "forced device")
    _hold_to(host, dev, "national host loop vs forced device solve")
    return ({"national_host_loop": l_h, "national_device": l_d},
            {"national_host_loop": sh_h, "national_device": sh_d})


# the JAX package's committed results of the two national-scale runs
# (artifacts/national_run_v3/national_102400stn.json,
# artifacts/national_streamed/streamed_200704stn.json); the per-station
# reference of the first travels in the port (tools/national_102400_ref.npz)
MIXED_ARTIFACT = {"stations": 102400, "records": 420055, "blocks": 400,
                  "iterations": 3, "sigma0": 0.9989}
STREAMED_ARTIFACT = {"stations": 200704, "baselines": 600321, "blocks": 196,
                     "super_blocks": 16, "tol": 1e-10}


def _in_folder(fn):
    """fn(folder) in a temporary folder, removed afterwards."""
    with tempfile.TemporaryDirectory() as work:
        return fn(work)


def _zero_counts():
    batched_cholesky_inverse.launches = 0
    batched_cholesky_inverse.shapes = {}


def phase_national_mixed(work):
    """tools/national_mixed.py at the JAX package's full size (320 x 320
    stations, tiles of 16, 16 super-blocks, resident), counts zeroed just
    before and read just after, held to the JAX package's committed
    result station by station.  Its pools are past DTA_NESTED_FUSE_BYTES,
    so the default factor route is the chunked one (as the JAX package's
    run): level 1 in chunks of 16 blocks through the kernel, level 2 one
    super-block at a time through the recursive inverse.  Then the same
    run on the one-pass route (DTA_NESTED_FUSE_BYTES past the pools: the
    kernel on all 400 blocks at once and on the 16 level-2 systems), held
    to the first."""
    size = national_mixed.REF_CONFIG
    _zero_counts()
    res, rec = national_mixed.run(*size, out=work, device="cuda",
                                  cmdline="chip_smoke.py national_mixed")
    launches = batched_cholesky_inverse.launches
    shapes = dict(batched_cholesky_inverse.shapes)
    _say("national_mixed record: " + json.dumps(rec))
    route = rec["route"]
    _say(f"national_mixed route: solve {route['solve']}, design pool "
         f"{route['pool_bytes']:.4e} B against DTA_DEVICE_SOLVE_BYTES "
         f"{route['budget_bytes']:.0e}; writers {rec['t_write_s']} s; "
         f"device peak {rec['peak_device_gb']:.2f} GB, host RSS peak "
         f"{rec['peak_host_rss_gb']:.2f} GB; chol_inv launches {launches} "
         f"by (B, n) {shapes}")
    art = MIXED_ARTIFACT
    _check((rec["stations"], rec["records"], rec["blocks"]) ==
           (art["stations"], art["records"], art["blocks"]),
           f"the artifact's network ({rec['stations']}, {rec['records']}, "
           f"{rec['blocks']})")
    ds = abs(res.sigma_zero - art["sigma0"])
    _say(f"national_mixed: {res.status}, {res.iterations} iterations "
         f"({art['iterations']}), sigma0 {res.sigma_zero:.6f} (artifact "
         f"{art['sigma0']}, |d| {ds:.2e} <= 2e-4), {res.pass_fail}")
    _check(res.status == "Converged" and res.pass_fail == "PASSED",
           f"national_mixed status {res.status} {res.pass_fail}")
    _check(res.iterations == art["iterations"], "national_mixed iterations")
    _check(ds <= 2e-4, f"national_mixed sigma0 {res.sigma_zero}")
    log = res.iteration_log
    if route["solve"] == "device":
        _check(log[-1]["solve_rel"] <= 1e-9,
               f"last solve_rel {log[-1]['solve_rel']}")
    ev = res.refine_evidence
    _check(ev["l1_err"] < 1e-8 and ev["l3_err"] < 1e-8,
           f"national_mixed refinement residuals {ev}")
    cmp = national_mixed.compare(res.xyz, national_mixed.station_sd_enu(res),
                                 res.truth, list(res.net.names),
                                 national_mixed.load_reference())
    _say("national_mixed vs the JAX artifact (X, Y, Z and SD(e, n, up) of "
         "every station, <= 1e-4 m): " + json.dumps(cmp))
    _check(cmp["ok"], "national_mixed stations against the JAX artifact")
    B, ni = art["blocks"], 768
    chunk = (16, ni)
    _check(shapes == {chunk: B // 16 * res.iterations},
           f"the kernel at {chunk} on every chunk of level 1 in every "
           f"iteration ({shapes})")

    os.environ["DTA_NESTED_FUSE_BYTES"] = "1e12"
    try:
        _zero_counts()
        one, rec1 = national_mixed.run(*size, device="cuda")
    finally:
        del os.environ["DTA_NESTED_FUSE_BYTES"]
    launches1 = batched_cholesky_inverse.launches
    shapes1 = dict(batched_cholesky_inverse.shapes)
    _say(f"national_mixed one-pass route: {rec1['t_adjust_s']} s, "
         f"iterations {rec1['iter_s']} s, phases {rec1['phase_profile_s']}; "
         f"device peak {rec1['peak_device_gb']:.2f} GB; chol_inv launches "
         f"{launches1} by (B, n) {shapes1}")
    _hold_to(one, res, "national_mixed one-pass vs chunked route")
    l2 = [s for s in shapes1 if s != (B, ni)]
    _check(shapes1.get((B, ni)) == one.iterations and len(l2) == 1
           and l2[0][0] == 16 and shapes1[l2[0]] == one.iterations,
           f"the kernel at {(B, ni)} and at level 2 (16, n2) once per "
           f"iteration on the one-pass route ({shapes1})")
    return ({"national_mixed": launches, "national_mixed_one_pass": launches1},
            {"national_mixed": shapes, "national_mixed_one_pass": shapes1})


def phase_national_streamed():
    """tools/national_streamed.py at the JAX package's full size (448 x
    448 stations, tiles of 32, super-tiles of 4, DTA_STREAMED_F64 at its
    default), counts zeroed just before and read just after."""
    _say(f"host MemTotal {national_streamed.mem_total_gb():.1f} GB; host "
         f"RSS peak so far {national_mixed.peak_rss_gb():.2f} GB")
    _check("DTA_STREAMED_F64" not in os.environ, "DTA_STREAMED_F64 unset")
    _zero_counts()
    solved, rec = national_streamed.run(*national_streamed.DEFAULTS,
                                        device="cuda")
    launches = batched_cholesky_inverse.launches
    shapes = dict(batched_cholesky_inverse.shapes)
    del solved
    ms = rec.pop("chunk_ms")
    _say("national_streamed record: " + json.dumps(rec))
    C, B, ni = rec["chunk_blocks"], rec["blocks"], rec["ni"]
    _say(f"national_streamed: C {C} (kernel at ({C}, {ni})), {len(ms)} "
         f"chunks; per chunk up/compute/down ms " + ", ".join(
             f"{c['up']:.1f}/{c['compute']:.1f}/{c['down']:.1f}"
             for c in ms))
    _say(f"national_streamed: chunks up {sum(c['up'] for c in ms):.1f} ms, "
         f"compute {sum(c['compute'] for c in ms):.1f} ms, down "
         f"{sum(c['down'] for c in ms):.1f} ms; chol_inv launches "
         f"{launches} by (B, n) {shapes}")
    art = STREAMED_ARTIFACT
    _check(all(rec[k] == art[k] for k in ("stations", "baselines", "blocks",
                                          "super_blocks")),
           "the artifact's network")
    _check(rec["relative_residual"] <= 1e-10,
           f"relative residual {rec['relative_residual']}")
    _check(rec["reuse_vs_solve_rel"] <= 1e-10,
           f"reuse apply vs solve {rec['reuse_vs_solve_rel']}")
    ev = rec["refine_evidence"]
    _check(ev["inline"] and max(ev["l1_err"], ev["l2_err"], ev["l3_err"])
           <= art["tol"], f"refinement evidence {ev} (<= {art['tol']:g})")
    _check(len(ms) == B // C and shapes.get((C, ni)) == B // C,
           f"the kernel at ({C}, {ni}) on every chunk ({shapes})")
    return {"national_streamed": launches}, {"national_streamed": shapes}


def phase_staged(rows, cols, tile, super_blocks, block_super, nested):
    """The 10k network nested with staged (host-streamed) factors on both
    DTA_STREAMED_F64 routes, held to the resident nested run `nested`."""
    launches, shapes = {}, {}
    for f64, name in (("1", "staged_f64"), ("0", "staged_two_phase")):
        os.environ["DTA_STREAMED_F64"] = f64
        try:
            res, l, sh, info = phase_main(
                rows, cols, tile, label=f"staged (DTA_STREAMED_F64={f64})",
                super_blocks=super_blocks, block_super=block_super,
                staged=True)
        finally:
            del os.environ["DTA_STREAMED_F64"]
        ev = res.refine_evidence
        for k, f in enumerate(info["streamed"]):
            ms = f.chunk_ms
            _say(f"  staged factor {k + 1}: C {f.C} (kernel at "
                 f"({f.C}, {f.bs.Nii.shape[1]})), {len(ms)} chunks; per "
                 f"chunk up/compute/down ms " + ", ".join(
                     f"{c['up']:.2f}/{c['compute']:.2f}/{c['down']:.2f}"
                     for c in ms))
        _check(len(info["streamed"]) == res.iterations,
               "one streamed factorization per iteration")
        _check(ev["l1_err"] < 1e-8 and ev["l3_err"] < 1e-8,
               f"staged refinement residuals {ev}")
        _hold_to(res, nested, f"{name} vs resident nested")
        launches[name], shapes[name] = l, sh
    return launches, shapes


def phase_host_assembly(rows, cols, tile, flat):
    """The 10k network two-level with DTA_HOST_ASSEMBLY=1, held to the
    device-assembled two-level run `flat`."""
    os.environ["DTA_HOST_ASSEMBLY"] = "1"
    try:
        res, l, sh, _ = phase_main(rows, cols, tile, label="host assembly")
    finally:
        del os.environ["DTA_HOST_ASSEMBLY"]
    _check(res.profile["route"]["assembly"] == "host", "host assembly")
    _hold_to(res, flat, "host assembly vs device assembly")
    return {"host_assembly": l}, {"host_assembly": sh}


def phase_nested(rows, cols, tile, super_blocks, block_super, flat,
                 shapes_l1, shape_l2):
    """The nested path cold, then warm; each held to the two-level run
    `flat` of the same network."""
    runs = []
    for run in ("cold", "warm"):
        t = time.perf_counter()
        res, launches, shapes, _ = phase_main(
            rows, cols, tile, label=f"nested ({run})",
            super_blocks=super_blocks, block_super=block_super)
        _say(f"phase nested {run}: {time.perf_counter() - t:.2f} s")
        dx = float(np.abs(res.xyz - flat.xyz).max())
        ev = res.refine_evidence
        _say(f"nested {run}: {res.iterations} iterations (two-level "
             f"{flat.iterations}), max|xyz - two-level xyz| {dx:.3e} m "
             f"(<= 1e-6)")
        _check(res.iterations == flat.iterations,
               "nested iterations equal the two-level run's")
        _check(dx <= 1e-6, f"nested xyz vs two-level {dx}")
        _check(ev["l1_err"] < 1e-8 and ev["l3_err"] < 1e-8,
               f"nested refinement residuals {ev}")
        for shp in (shapes_l1, shape_l2):
            _check(shapes.get(shp, 0) == res.iterations,
                   f"the kernel ran at {shp} once per iteration "
                   f"({shapes})")
        runs.append(launches)
    return runs, res


# (key, trace range, enclosing range or None, part of the split): the
# split's parts add up to the factor's device time less the rest
FACTOR_PARTS = {
    "flat": [("chol_inv", "dta.chol_inv", None, True),
             ("reduce_from_linv", "dta.reduce_from_linv", None, True),
             ("junction", "dta.junction", None, True)],
    "nested": [("level1.chol_inv", "dta.chol_inv", "dta.level1", True),
               ("level1.reduce_from_linv", "dta.reduce_from_linv",
                "dta.level1", True),
               ("level2.chol_inv", "dta.chol_inv", "dta.level2", True),
               ("level2.reduce_from_linv", "dta.reduce_from_linv",
                "dta.level2", True),
               ("level3.inverse", "dta.level3", None, True),
               ("level1", "dta.level1", None, False),
               ("level2", "dta.level2", None, False)]}


def phase_trace(rows, cols, tile, **kw):
    """The same adjustment again under torch.profiler: the device time
    of the last Gauss-Newton iteration (the "dta.iteration" range, rhs
    through update), its busy share, and the split of its factor phase:
    two-level into the kernel, the four float32 products of
    reduce_from_linv and the junction inverse; nested into the level-1
    and level-2 kernels and products and the level-3 inverse (the
    "level1"/"level2" entries are the whole of each level, assembly and
    scaling included)."""
    from torch.profiler import ProfilerActivity, profile
    os.environ["DTA_PROFILE"] = "1"
    net, seg = synthetic_mixed_network(rows, cols, block_rows=tile,
                                       block_cols=tile, seed=0)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        res = adjust_tpu_blocked(net, AdjustmentOptions(), seg=seg,
                                 device="cuda", **kw)
        torch.cuda.synchronize()
    del os.environ["DTA_PROFILE"]
    from torch.autograd import DeviceType
    ev = prof.events()
    # host ranges; the profiler mirrors each on the device timeline as
    # well, under the same name
    host = [e for e in ev if e.device_type == DeviceType.CPU]
    its = sorted((e for e in host if e.name == "dta.iteration"),
                 key=lambda e: e.time_range.start)
    _check(len(its) == res.iterations,
           f"one trace range per iteration ({len(its)} ranges, "
           f"{res.iterations} iterations)")
    last = its[-1]
    t0, t1 = last.time_range.start, last.time_range.end
    # a device event belongs to the host range that launched it: the
    # runtime call with its correlation id (the kernels of csrc/ are
    # launched through ctypes, outside any torch operator)
    launch = {e.id: e.time_range.start for e in host
              if e.name.startswith("cu")}
    dev = [e for e in ev if e.device_type == DeviceType.CUDA
           and not e.name.startswith("dta.")]
    at = [(launch.get(e.id), e.time_range.start, e.time_range.end)
          for e in dev]
    matched = sum(t is not None for t, _, _ in at)
    _say(f"trace: {len(at)} device events, {matched} matched to their "
         f"launch (the others are placed by their device start)")
    at = [(s if t is None else t, s, e) for t, s, e in at]

    def device_ms(r):
        """Device time of the events launched in host range r: the union
        of their intervals (the kernel's streams run side by side)."""
        a, b = r.time_range.start, r.time_range.end
        busy, end = 0.0, float("-inf")
        for s, e in sorted((s, e) for t, s, e in at if a <= t <= b):
            busy += max(0.0, e - max(s, end))
            end = max(end, e)
        return busy / 1e3

    def inside(name, r=last):
        a, b = r.time_range.start, r.time_range.end
        return [e for e in host if e.name == name
                and a <= e.time_range.start and e.time_range.end <= b]

    wall_ms = (t1 - t0) / 1e3
    busy_ms = device_ms(last)
    factor = inside("dta.factor")
    _check(len(factor) == 1, "one factor range in the last iteration")
    out = {"iteration_ms": wall_ms, "device_ms": busy_ms,
           "busy_share": busy_ms / wall_ms,
           "factor_ms": factor[0].time_range.elapsed_us() / 1e3,
           "factor_device_ms": device_ms(factor[0])}
    parts = FACTOR_PARTS["nested" if kw.get("super_blocks") else "flat"]
    for key, name, parent, _ in parts:
        within = inside(parent, factor[0]) if parent else factor
        out[key] = sum(device_ms(e) for r in within
                       for e in inside(name, r))
    out["factor_other_device_ms"] = out["factor_device_ms"] - sum(
        out[key] for key, _, _, leaf in parts if leaf)
    _say("warm iteration trace: " + json.dumps(out))
    _check(busy_ms > 0 and all(out[key] > 0 for key, *_ in parts
                               if key.endswith("chol_inv")),
           "the trace shows the kernel's device time")
    return out


def phase_card_vs_cpu(label="two-level", **kw):
    out = {}
    for dev in ("cuda", "cpu"):
        net, seg = synthetic_mixed_network(24, 24, block_rows=12,
                                           block_cols=12)
        out[dev] = adjust_tpu_blocked(net, AdjustmentOptions(), seg=seg,
                                      device=dev, **kw)
    g, c = out["cuda"], out["cpu"]
    dx = float(np.abs(g.xyz - c.xyz).max())
    ds = abs(g.sigma_zero - c.sigma_zero)
    dc = float(np.abs(g.cov_stn - c.cov_stn).max()
               / np.abs(c.cov_stn).max())
    _say(f"refine evidence cuda {g.refine_evidence}, cpu "
         f"{c.refine_evidence}")
    _say(f"24x24 {label} cuda vs cpu: xyz {dx:.3e} (<= 1e-7), sigma0 "
         f"{ds:.3e} "
         f"(<= 1e-9), cov_stn rel {dc:.3e} (<= 1e-9); iterations "
         f"{g.iterations}/{c.iterations}")
    _check(g.status == c.status == "Converged", "both converged")
    _check(g.iterations == c.iterations, "same iteration count")
    _check(dx < 1e-7 and ds < 1e-9 and dc < 1e-9, "cuda vs cpu bounds")


# the port's CLI routes at 1,600 stations: adjust's arguments per route
_STAGE = ["--staged-adjustment", "--create-stage-files"]
CLI_ROUTES = {"host": [], "dense": ["--tpu"],
              "phased": ["--phased", "--tpu"],
              "phased_sb2": ["--phased", "--tpu", "--tpu-super-blocks", "2"],
              "staged": ["--phased", "--tpu", *_STAGE],
              "staged_sb2": ["--phased", "--tpu", *_STAGE,
                             "--tpu-super-blocks", "2"],
              "host_phased": ["--phased"],
              "host_staged": [*_STAGE, "--purge-stage-files"]}
# routes that run on the host only (no kernel launch)
CLI_HOST = ("host", "host_phased", "host_staged")
# staged routes and their resident counterparts
CLI_RESIDENT = {"staged": "phased", "staged_sb2": "phased_sb2"}
# sigma zero of the JAX package's CLI on the same 40 x 40 files (CPU);
# 0.998 on files whose angles' seconds below 1 were misread (ROADMAP.md F8)
CLI_SIGMA0_40 = "0.999"
# --block1-phased: one reverse sweep, rigorous for block 1 only; the host
# route is the reference of the device routes (the kernel once per block)
CLI_BLOCK1 = {"host_block1": ["--block1-phased"],
              "block1": ["--block1-phased", "--tpu"],
              "block1_staged": ["--block1-phased", "--tpu", *_STAGE]}
B1_STATUS = "Estimates solved for Block 1 only"
_NUM = re.compile(r"[-+]?\d+\.?\d*(?:[eE][-+]?\d+)?")


def _verb(folder, *argv):
    """One verb of the port's CLI in-process: (seconds, its stdout)."""
    buf = io.StringIO()
    t = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main([*argv, "--output-folder", str(folder)])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t
    out = buf.getvalue()
    _check(rc == 0, f"{' '.join(argv)} exited {rc}:\n{out[-3000:]}")
    return secs, out


def _verb_subprocess(folder, *argv):
    """One verb as `python -m dynadjust_tpu_torch`: seconds."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(Path(__file__).resolve().parent), env.get("PYTHONPATH", "")])
    t = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "dynadjust_tpu_torch", *argv,
                        "--output-folder", str(folder)], env=env,
                       capture_output=True, text=True, timeout=600)
    _check(r.returncode == 0, f"python -m dynadjust_tpu_torch "
           f"{' '.join(argv)} exited {r.returncode}:\n{r.stderr[-3000:]}")
    return time.perf_counter() - t


def _files_agree(a, b, tol):
    """compare_files semantics: lines equal, or the same non-numeric text
    with every number within tol.  The text is compared as
    whitespace-split tokens (a fixed-width number's sign moves the spaces
    beside it), so column alignment is not checked.  Returns the largest
    difference."""
    la, lb = Path(a).read_text().splitlines(), Path(b).read_text().splitlines()
    _check(len(la) == len(lb), f"{a} and {b} differ in length")
    worst = 0.0
    for x, y in zip(la, lb):
        if x == y:
            continue
        nx, ny = _NUM.findall(x), _NUM.findall(y)
        _check(len(nx) == len(ny) and
               _NUM.sub("#", x).split() == _NUM.sub("#", y).split(),
               f"{a} vs {b}: {x!r} / {y!r}")
        worst = max([worst] + [abs(float(p) - float(q))
                               for p, q in zip(nx, ny)])
    _check(worst <= tol, f"{a} vs {b}: numbers differ by {worst} > {tol}")
    return worst


_COVA = ("+SOLUTION/MATRIX_ESTIMATE L COVA", "-SOLUTION/MATRIX_ESTIMATE L COVA")


def _snx_cova(path):
    """A SINEX file's lines outside its covariance section, and the
    section's (row, first column, values) with the values (n, 3), NaN
    where a line holds fewer than three.  The section's lines are fixed
    width (" %5d %5d" and " % .14E" per value), parsed column-wise."""
    lines = Path(path).read_text().split("\n")
    i0, i1 = lines.index(_COVA[0]) + 2, lines.index(_COVA[1])
    body = np.array(lines[i0:i1], dtype="S")
    lens = np.char.str_len(body)
    _check(np.isin(lens, (34, 56, 78)).all(), f"{path}: fixed-width lines")
    ch = body.view("S1").reshape(len(body), -1)

    def field(rows, a, b, kind):
        return ch[rows, a:b].copy().view(f"S{b - a}").ravel().astype(kind)

    every = np.ones(len(body), bool)
    vals = np.full((len(body), 3), np.nan)
    for j in range(3):
        has = lens >= 34 + 22 * j
        vals[has, j] = field(has, 13 + 22 * j, 34 + 22 * j, np.float64)
    return (lines[:i0] + lines[i1:], field(every, 1, 6, np.int64),
            field(every, 7, 12, np.int64), vals)


def _snx_agree(a, b, tol, cov_tol, share=None):
    """SINEX files a and b agree: the lines outside the covariance section
    as _files_agree at tol, the section's rows and columns equal and its
    values within cov_tol (m^2).  share (S, S): the pairs of stations that
    share a block, for a blocked route's file a, whose covariances of
    stations that share no block are 0 by design (the reference's phased
    mode); those entries must be exactly 0 in a and are not compared.
    Returns the largest differences outside the section and in it."""
    ha, ra, ca, va = _snx_cova(a)
    hb, rb, cb, vb = _snx_cova(b)
    _check(np.array_equal(ra, rb) and np.array_equal(ca, cb),
           f"{a} vs {b}: covariance rows and columns")
    with tempfile.TemporaryDirectory() as t:
        Path(t, "a").write_text("\n".join(ha))
        Path(t, "b").write_text("\n".join(hb))
        worst = _files_agree(Path(t, "a"), Path(t, "b"), tol)
    real = ~np.isnan(vb)
    _check(np.array_equal(real, ~np.isnan(va)), f"{a} vs {b}: value counts")
    keep = real.copy()
    if share is not None:
        si = (ra - 1) // 3
        sj = (ca[:, None] - 1 + np.arange(3)) // 3
        keep &= share[si[:, None], np.minimum(sj, share.shape[0] - 1)]
        off = real & ~keep
        _check(not va[off].any(), f"{a}: covariances of stations that "
               f"share no block are 0")
        _say(f"  {a.name}: {int(keep.sum())} covariances compared (largest "
             f"|value| {np.abs(vb[keep]).max():.3e} m^2), {int(off.sum())} "
             f"between stations of different blocks are 0")
    worst_cov = float(np.abs(va - vb)[keep].max(initial=0.0))
    _check(worst_cov <= cov_tol, f"{a} vs {b}: covariances differ by "
           f"{worst_cov} > {cov_tol} m^2")
    return worst, worst_cov


def _jsonl_variances(path):
    """The VarianceCart and VarianceLocal matrices (m^2) of an .adj.jsonl's
    stations, (S, 2, 3, 3)."""
    out = []
    with open(path) as f:
        for line in f:
            u = json.loads(line).get("DnaStation", {}).get("Uncertainty")
            if u:
                out.append([u["VarianceCart"], u["VarianceLocal"]])
    return np.array(out)


def _block_share(folder, name, nstations):
    """(S, S) bool: the stations that share a block of the saved
    segmentation."""
    seg = Segmentation.load(str(Path(folder) / f"{name}.seg.pkl"))
    share = np.zeros((nstations, nstations), bool)
    for b in range(seg.block_count):
        st = np.asarray(seg.parameter_stations(b))
        share[np.ix_(st, st)] = True
    return share


class _NoTorchUnpickler(pickle.Unpickler):
    """Loads a saved result, refusing any torch class in it."""

    def find_class(self, module, name):
        _check(not module.startswith("torch"),
               f"the saved result holds {module}.{name}")
        return super().find_class(module, name)


def _cli_adjust(folder, name, extra):
    """adjust NAME in folder with the launch counts zeroed just before and
    read just after: (result, seconds, the verb's own step times (load,
    adjust, results.pkl, write_adj, ...), launches, launches by (B, n),
    summary lines)."""
    batched_cholesky_inverse.launches = 0
    batched_cholesky_inverse.shapes = {}
    secs, out = _verb(folder, "adjust", name, *extra)
    launches = batched_cholesky_inverse.launches
    shapes = dict(batched_cholesky_inverse.shapes)
    with open(Path(folder) / f"{name}.results.pkl", "rb") as f:
        res = _NoTorchUnpickler(f).load()
    times = re.search(r"Times \(s\): (.*)", out).group(1).split()
    steps = {k: float(v) for k, v in zip(times[::2], times[1::2])}
    summary = [ln.strip() for ln in out.splitlines()
               if ln.startswith(("+ Converged", "+ Failed", "+ Estimates",
                                 "  Chi"))]
    return res, secs, steps, launches, shapes, summary


def _newton_lines(label, r, allow_f64=False):
    """Print the Newton records (res.profile["newton"]) of an adjust
    result (dense and block-1 routes): each device solve's shape, route,
    Newton rounds and last residual (and the float64 residual of a
    fallback solve) and the profile's fallback count, which must match
    the records.  Holds the kernel route's rounds to 2..12, and, unless
    allow_f64, every solve to the kernel route: the records."""
    newton = (r.profile or {}).get("newton") or []
    _say(f"  {label} newton records: {json.dumps(newton)}")
    for k, rec in enumerate(newton):
        f64 = (f", float64 residual {rec['f64_residual']:.3e}"
               if rec["route"] == "f64" else "")
        _say(f"  {label} device solve {k + 1}: (1, {rec['n']}), route "
             f"{rec['route']}, {rec['rounds']} Newton rounds, residual "
             f"{rec['residual']:.3e}{f64}")
    kernel = [x for x in newton if x["route"] == "kernel"]
    if newton:
        n_f64 = r.profile["f64_fallbacks"]
        _say(f"  {label} float64 fallbacks: {n_f64} of {len(newton)}")
        _check(n_f64 == len(newton) - len(kernel),
               f"{label}: profile counts {n_f64} fallbacks")
    _check(all(2 <= x["rounds"] <= 12 for x in kernel),
           f"{label}: Newton rounds {[x['rounds'] for x in kernel]}")
    _check(allow_f64 or len(kernel) == len(newton),
           f"{label}: a solve took the float64 fallback")
    return newton


def phase_block1(d, files, out, dev=(), name="n40", key="cli",
                 size="40x40", segment=("300", "600"), allow_f64=False):
    """adjust --block1-phased on the host and on the device with and
    without staging, each after a fresh import of files and segment
    --min-inner-stns/--max-block-stns segment: the device routes launch
    the kernel once per block, at (1, 3 n_b), and are held to the host
    route (saved xyz 1e-6 m, .xyz numbers 1e-4, the same status line).
    Launches go to out under f"{key}_{route}"; allow_f64 lets a solve
    take the float64 fallback.  dev: extra adjust arguments (a CPU trial
    passes --device cpu).  Returns each device route's Newton records."""
    res, records = {}, {}
    for route, extra in CLI_BLOCK1.items():
        f = d / route
        f.mkdir()
        t_imp = _verb(f, "import", "-n", name, *files)[0]
        t_seg = _verb(f, "segment", name, "--min-inner-stns", segment[0],
                      "--max-block-stns", segment[1])[0]
        r, t, steps, launches, shapes, summary = _cli_adjust(
            f, name, [*extra, *dev])
        res[route] = r
        out["launches"][f"{key}_{route}"] = launches
        out["shapes"][f"{key}_{route}"] = list(shapes)
        out["seconds"][f"{size} {route}"] = {
            "import": t_imp, "segment": t_seg, "adjust": t,
            "adjust_steps": steps}
        _say(f"{key} {size} {route}: import {t_imp:.2f} s, segment "
             f"{t_seg:.2f} s, adjust {t:.2f} s (steps {steps}); "
             f"{' | '.join(summary)}; chol_inv launches {launches} "
             f"{shapes}")
        newton = _newton_lines(f"{key} {size} {route}", r, allow_f64)
        _check(r.status.startswith(B1_STATUS), f"{route}: {r.status}")
        if route == "host_block1":
            _check(launches == 0, "the host block-1 route runs no kernel")
            continue
        records[route] = newton
        B = len(r.block_info)
        solved = sorted((1, x["n"]) for x in newton)
        launched = sorted(shp for shp, c in shapes.items()
                          for _ in range(c))
        _check(len(solved) == B and launched == ([] if dev else solved),
               f"{route}: one device solve and one launch per block ({B} "
               f"blocks, launches {launched}, solves {solved})")
    host = res["host_block1"]
    for route in ("block1", "block1_staged"):
        r = res[route]
        dxyz = float(np.abs(r.xyz - host.xyz).max())
        worst = _files_agree(d / route / f"{name}.xyz",
                             d / "host_block1" / f"{name}.xyz", 1e-4)
        _say(f"{key} {size} {route} vs host_block1: status {r.status!r}, "
             f"saved xyz {dxyz:.3e} m (<= 1e-6), .xyz numbers {worst:.1e} "
             f"(<= 1e-4)")
        _check(r.status == host.status, f"{route} status {r.status}")
        _check(dxyz <= 1e-6, f"{route} xyz vs host_block1 {dxyz}")
    _check(any((d / "block1_staged" / f"{name}.mtx").iterdir()),
           "the staged block-1 route wrote its stage files")
    return records


def phase_cli(work, flat_iterations):
    """The port's CLI at 1,600 and 10,000 stations (phase 8)."""
    out = {"launches": {}, "seconds": {}, "shapes": {}}
    d = Path(work) / "n40"
    d.mkdir()
    files = _dna_inputs(d, "n40", 40, 40)
    res = {}
    for route, extra in CLI_ROUTES.items():
        f = d / route
        f.mkdir()
        if route == "host":
            t_imp = _verb_subprocess(f, "import", "-n", "n40", *files)
        else:
            t_imp, imp_out = _verb(f, "import", "-n", "n40", *files)
            if route == "dense":
                _say(f"cli 40x40 {imp_out.splitlines()[-1].strip()}")
        t_seg, seg_out = _verb(f, "segment", "n40", "--min-inner-stns",
                               "300", "--max-block-stns", "600")
        r, t, steps, launches, shapes, summary = _cli_adjust(f, "n40", extra)
        res[route] = r
        out["launches"][f"cli_{route}"] = launches
        out["shapes"][f"cli_{route}"] = list(shapes)
        out["seconds"][f"40x40 {route}"] = {
            "import": t_imp, "segment": t_seg, "adjust": t,
            "adjust_steps": steps}
        _say(f"cli 40x40 {route}: import {t_imp:.2f} s, segment "
             f"{t_seg:.2f} s ({seg_out.count('    block ')} blocks), "
             f"adjust {t:.2f} s (steps {steps}); "
             f"{' | '.join(summary)}; chol_inv launches {launches} "
             f"{shapes}; phases {r.profile}")
        _newton_lines(f"cli 40x40 {route}", r)
        if route == "dense":
            _check(launches == r.iterations and len(shapes) == 1,
                   f"the dense route launched the kernel once per "
                   f"iteration at one shape ({launches}, {shapes})")
            out["dense_shape"] = next(iter(shapes))
        elif route in CLI_HOST:
            _check(launches == 0, f"the {route} route runs no kernel")
        else:
            _check(launches > 0, f"the {route} route launched the kernel")
    host = res["host"]
    for route, r in res.items():
        dxyz = float(np.abs(r.xyz - host.xyz).max())
        worst = _files_agree(d / route / "n40.xyz", d / "host" / "n40.xyz",
                             1e-4)
        _say(f"cli 40x40 {route} vs host: {r.iterations} iterations "
             f"(host {host.iterations}), sigma0 {r.sigma_zero:.3f} "
             f"{r.pass_fail}, saved xyz {dxyz:.3e} m (<= 1e-6), .xyz "
             f"numbers {worst:.1e} (<= 1e-4)")
        _check(r.status == "Converged", f"{route}: {r.status}")
        _check(r.iterations == host.iterations, f"{route} iterations")
        _check(dxyz <= 1e-6, f"{route} xyz vs host {dxyz}")
        _check(f"{r.sigma_zero:.3f}" == CLI_SIGMA0_40
               and r.pass_fail == "PASSED",
               f"{route}: sigma0 {r.sigma_zero:.3f} {r.pass_fail}")
    for route, resident in CLI_RESIDENT.items():
        dxyz = float(np.abs(res[route].xyz - res[resident].xyz).max())
        worst = _files_agree(d / route / "n40.xyz",
                             d / resident / "n40.xyz", 1e-4)
        _say(f"cli 40x40 {route} vs {resident}: saved xyz {dxyz:.3e} m "
             f"(<= 1e-6), .xyz numbers {worst:.1e} (<= 1e-4)")
        _check(dxyz <= 1e-6, f"{route} xyz vs {resident} {dxyz}")
    _check(not (d / "host_staged" / "n40.mtx").exists(),
           "--purge-stage-files removed n40.mtx")
    out["phased_40"] = res["phased"]
    phase_block1(d, files, out)

    # 10,000 stations through the CLI's own segmentation
    d = Path(work) / "n10k"
    d.mkdir()
    t_imp, imp_out = _verb(d, "import", "-n", "n10k",
                           *_dna_inputs(d, "n10k", 100, 100))
    _say(f"cli 10k {imp_out.splitlines()[-1].strip()}")
    t_seg = _verb(d, "segment", "n10k", "--min-inner-stns", "600",
                  "--max-block-stns", "1200")[0]
    net0 = project.load_network(str(d), "n10k")
    seg = Segmentation.load(str(d / "n10k.seg.pkl"))
    sizes = [len(seg.parameter_stations(b)) for b in range(seg.block_count)]
    counts = np.bincount(np.concatenate(
        [seg.parameter_stations(b) for b in range(seg.block_count)]))
    njs = int((counts > 1).sum())
    _say(f"cli 10k segmentation: {seg.block_count} blocks, largest "
         f"{max(sizes)} stations, {njs} junction stations ({3 * njs} "
         f"junction parameters)")
    r, t, steps, launches, shapes, summary = _cli_adjust(
        d, "n10k", ["--phased", "--tpu"])
    out["launches"]["cli_10k_phased"] = launches
    out["shapes"]["cli_10k_phased"] = list(shapes)
    out["seconds"]["10k phased"] = {"import": t_imp, "segment": t_seg,
                                    "adjust": t, "adjust_steps": steps}
    _say(f"cli 10k phased: import {t_imp:.2f} s, segment {t_seg:.2f} s, "
         f"adjust {t:.2f} s (steps {steps}); "
         f"{' | '.join(summary)}; chol_inv launches {launches} {shapes}; "
         f"phases {r.profile}")
    _check(r.status == "Converged" and r.iterations == flat_iterations,
           f"10k CLI: {r.status} in {r.iterations} (in-memory "
           f"{flat_iterations})")
    _check(r.cov_xyz is None and r.block_cov is not None,
           "10k results are past the dense-covariance cap")
    _check(launches > 0, "the 10k CLI route launched the kernel")
    t = time.perf_counter()
    direct = adjust_tpu_blocked(net0, AdjustmentOptions(), seg=seg,
                                super_blocks=4, device="cuda")
    dxyz = float(np.abs(r.xyz - direct.xyz).max())
    _say(f"cli 10k vs adjust_tpu_blocked(super_blocks=4) on the saved "
         f"network: {direct.iterations} iterations, xyz {dxyz:.3e} m "
         f"(<= 1e-6), {time.perf_counter() - t:.2f} s")
    _check(direct.iterations == r.iterations, "direct nested iterations")
    _check(dxyz <= 1e-6, f"10k CLI vs direct nested xyz {dxyz}")
    return out


# the pipeline phase: one seeded 1' geoid grid for both networks (N 3-7 m,
# deflections <= 1.5"), the target frame, adjust's outputs (with the
# adjusted-measurement table, whose header line "M Station 1" the diff
# marker finds), and the routes at 1,600 stations
PIPE_GRID = dict(s_lat=-38.0, n_lat=-31.0, w_lon=142.0, e_lon=149.0,
                 inc_sec=60.0, seed=0)
PIPE_FRAME = ["-r", "ITRF2014", "-e", "01.01.2024"]
PIPE_OUT = ["--output-adj-msr", "--output-json"]
PIPE_EXPORTS = ["--export-snx", "--export-xml"]
# the host route writes the JSON report only (the script runs past 450 s:
# the first cut the phase takes); the device routes write every format,
# and the blocked route's SINEX and DynaML files are held to the dense
# route's, whose covariance is the full one, as the host route's
PIPE_ROUTES = {"host": [], "dense": ["--tpu", *PIPE_EXPORTS],
               "phased": ["--phased", "--tpu", *PIPE_EXPORTS]}
PIPE_ADJ = {"host": "simult", "dense": "simult", "phased": "phased"}
# sigma zero of the JAX package's CLI on the same 40 x 40 files (CPU)
PIPE_SIGMA0_40 = "1.000"
# covariances (m^2) of the device routes' .adj.jsonl and .snx against the
# host and dense routes'; the coordinates' 1e-4 would not do, since the
# variances themselves are of order 1e-4 m^2
PIPE_COV_TOL = 1e-9
_STAGE_LINE = re.compile(r"(\w+)\s+done \((\d+\.\d+) s\)")


def _pipeline_inputs(d, name, rows, cols, grid):
    """DNA files of the seeded mixed network, stations written as
    ellipsoidal heights (LLh) and the level differences made orthometric
    for the grid's N."""
    net, _ = synthetic_mixed_network(rows, cols, block_rows=34,
                                     block_cols=34, seed=0)
    orthometric_levelling(net, grid)
    files = [str(d / f"{name}.stn"), str(d / f"{name}.msr")]
    write_dna_stn(files[0], net, ellipsoidal=True)
    write_dna_msr(files[1], net)
    return files


def _circles_unoriented(path):
    """A copy of an .adj.jsonl with the orientation of circular error
    ellipses set to 0: a constrained station's ellipse is a circle (the
    host route reports the fixed-station sd on each axis, the blocked
    route zero), and a circle's orientation is undefined.  Returns the
    copy's path."""
    out = Path(f"{path}.unoriented")
    with open(path) as src, open(out, "w") as dst:
        for line in src:
            rec = json.loads(line)
            u = rec.get("DnaStation", {}).get("Uncertainty")
            if u and u["SemiMajor"] - u["SemiMinor"] <= 1e-12:
                u["Orientation"] = 0.0
            dst.write(json.dumps(rec) + "\n")
    return out


def _station_xyz(folder, name):
    net = project.load_network(str(folder), name)
    return np.stack(geo_to_cart(net.lat, net.lon, net.height,
                                net.datum.ellipsoid), axis=-1), net


def phase_pipeline(work, sizes=((40, 40), (100, 100)), dev=()):
    """The pipeline verbs on the card (phase 9): (a) verb by verb at
    sizes[0], adjust on the host, --tpu and --phased --tpu routes with
    JSON, SINEX and DynaML output; (b) the dynadjust verb alone at
    sizes[1] with --phased --tpu.  dev: extra adjust arguments (a CPU
    trial passes --device cpu)."""
    device = "cpu" if dev else "cuda"
    out = {"launches": {}, "seconds": {}, "shapes": {}}
    work = Path(work)
    grid = synthetic_geoid_grid(**PIPE_GRID)
    gsb = str(work / "grid.gsb")
    write_gsb(grid, gsb)
    sg = grid.subgrids[0]
    _say(f"pipeline grid: {sg.nrows} x {sg.ncols} nodes, N "
         f"{sg.values[..., 0].min():.3f}..{sg.values[..., 0].max():.3f} m, "
         f"max |deflection| {np.abs(sg.values[..., 1:3]).max():.3f} s, "
         f"{os.path.getsize(gsb)} bytes")

    # (a) verb by verb
    (ra, ca), (rb, cb) = sizes
    d = work / "pa"
    prep = d / "prep"
    prep.mkdir(parents=True)
    files = _pipeline_inputs(d, "pa", ra, ca, grid)
    secs = {"import": _verb(prep, "import", "-n", "pa", *files)[0]}
    xyz0, _ = _station_xyz(prep, "pa")
    secs["reftran"], rt_out = _verb(prep, "reftran", "pa", *PIPE_FRAME)
    xyz1, net1 = _station_xyz(prep, "pa")
    shift = np.linalg.norm(xyz1 - xyz0, axis=1)
    _say(f"pipeline a reftran: {rt_out.strip().splitlines()[-1]}; station "
         f"shift largest {shift.max():.4f} m, smallest {shift.min():.4f} m")
    _check(net1.frame == "ITRF2014" and shift.min() > 0.0,
           "reftran moved every station to ITRF2014")
    secs["geoid"], g_out = _verb(prep, "geoid", "pa", "-g", gsb,
                                 "--convert-stn-hts")
    net2 = project.load_network(str(prep), "pa")
    _check(net2.geoid_applied and 3.0 <= net2.geoid_sep.min()
           and net2.geoid_sep.max() <= 7.0, "geoid N on every station")
    secs["segment"] = _verb(prep, "segment", "pa", "--min-inner-stns",
                            "300", "--max-block-stns", "600")[0]
    res = {}
    for route, extra in PIPE_ROUTES.items():
        f = d / route
        shutil.copytree(prep, f)
        r, t, steps, launches, shapes, summary = _cli_adjust(
            f, "pa", [*extra, *PIPE_OUT, *dev])
        res[route] = r
        out["launches"][f"pipeline_{route}"] = launches
        out["shapes"][f"pipeline_{route}"] = list(shapes)
        secs[f"adjust {route}"] = t
        secs[f"adjust {route} steps"] = steps
        _say(f"pipeline a {route}: adjust {t:.2f} s (steps {steps}); "
             f"{' | '.join(summary)}; chol_inv launches {launches} "
             f"{shapes}")
        _newton_lines(f"pipeline a {route}", r)
        if route == "host":
            _check(launches == 0, "the host route runs no kernel")
        elif device == "cuda":
            _check(launches > 0, f"the {route} route launched the kernel")
    out["seconds"][f"{ra}x{ca} verbs"] = secs
    host = res["host"]
    hf, df = d / "host", d / "dense"
    for route, r in res.items():
        f = d / route
        dxyz = float(np.abs(r.xyz - host.xyz).max())
        worst = {"pa.xyz": _files_agree(f / "pa.xyz", hf / "pa.xyz", 1e-4),
                 "pa.adj.jsonl": _files_agree(
                     _circles_unoriented(f / "pa.adj.jsonl"),
                     _circles_unoriented(hf / "pa.adj.jsonl"), 1e-4)}
        var, hvar = (_jsonl_variances(x / "pa.adj.jsonl") for x in (f, hf))
        _check(var.shape == hvar.shape, f"{route} .adj.jsonl stations")
        cov = {"pa.adj.jsonl": float(np.abs(var - hvar).max())}
        if route == "phased":
            worst["pa.adjusted.stn.xml (dense)"] = _files_agree(
                f / "pa.adjusted.stn.xml", df / "pa.adjusted.stn.xml", 1e-4)
            worst["pa.snx (dense)"], cov["pa.snx (dense)"] = _snx_agree(
                f / "pa.snx", df / "pa.snx", 1e-4, PIPE_COV_TOL,
                _block_share(f, "pa", len(r.xyz)))
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(["diff", str(hf / "pa.simult.adj"),
                           str(f / f"pa.{PIPE_ADJ[route]}.adj"), "-t",
                           "1e-4", "--skip-to-marker", "M Station 1"])
        _say(f"pipeline a {route} vs host: {r.iterations} iterations "
             f"(host {host.iterations}), sigma0 {r.sigma_zero:.3f} "
             f"{r.pass_fail}, saved xyz {dxyz:.3e} m (<= 1e-6), numbers "
             f"(<= 1e-4) {worst}, covariances (<= {PIPE_COV_TOL} m^2) "
             f"{cov}, largest variance {hvar.max():.3e} m^2, diff -t 1e-4 "
             f"exit {rc}")
        _check(r.status == "Converged", f"{route}: {r.status}")
        _check(cov["pa.adj.jsonl"] <= PIPE_COV_TOL,
               f"{route} .adj.jsonl variances vs host {cov}")
        _check(r.iterations == host.iterations, f"{route} iterations")
        _check(dxyz <= 1e-6, f"{route} xyz vs host {dxyz}")
        _check(f"{r.sigma_zero:.3f}" == PIPE_SIGMA0_40
               and r.pass_fail == "PASSED",
               f"{route}: sigma0 {r.sigma_zero:.3f} {r.pass_fail}")
        _check(rc == 0, f"diff of the {route} .adj:\n{buf.getvalue()[-2000:]}")

    # (b) the dynadjust verb alone
    d = work / "pb"
    d.mkdir()
    files = _pipeline_inputs(d, "pb", rb, cb, grid)
    batched_cholesky_inverse.launches = 0
    batched_cholesky_inverse.shapes = {}
    # no --export-snx here: its 2.84 GB file at 10k took 103-144 s on the
    # card's host, time the national-scale phases need; the 1,600-station
    # routes above write and check SINEX
    t, dyn_out = _verb(d, "dynadjust", "-n", "pb", *files, *PIPE_FRAME,
                       "-g", gsb, "--convert-stn-hts", "--phased", "--tpu",
                       "--min-inner-stns", "600", "--max-block-stns", "1200",
                       "--output-json", *dev)
    launches = batched_cholesky_inverse.launches
    shapes = dict(batched_cholesky_inverse.shapes)
    out["launches"]["pipeline_dynadjust"] = launches
    out["shapes"]["pipeline_dynadjust"] = list(shapes)
    stages = _STAGE_LINE.findall((d / "dynadjust.log").read_text())
    times = re.search(r"Times \(s\): (.*)", dyn_out).group(1).split()
    steps = {k: float(v) for k, v in zip(times[::2], times[1::2])}
    out["seconds"][f"{rb}x{cb} dynadjust"] = {
        "verb": t, **{k: float(v) for k, v in stages},
        "adjust_steps": steps}
    with open(d / "pb.results.pkl", "rb") as fh:
        r = _NoTorchUnpickler(fh).load()
    _say(f"pipeline b dynadjust: {t:.2f} s, stages {stages}; adjust steps "
         f"{steps}; {r.status} in {r.iterations} iterations, sigma0 "
         f"{r.sigma_zero:.3f} {r.pass_fail}; chol_inv launches {launches} "
         f"{shapes}; .adj.jsonl {os.path.getsize(d / 'pb.adj.jsonl')} "
         f"bytes")
    _check([k for k, _ in stages] == ["import", "reftran", "geoid",
                                      "segment", "adjust"],
           f"dynadjust.log holds five done stages: {stages}")
    _check(r.status == "Converged" and r.pass_fail == "PASSED",
           f"10k pipeline: {r.status} {r.pass_fail}")
    _check(launches > 0 or device != "cuda",
           "the pipeline launched the kernel")
    # the network the pipeline saved before its adjust stage (the stage
    # saves the adjusted one over it): the first four stages again, by
    # the verb's program switches, in a folder of their own
    t = time.perf_counter()
    pre = d / "stages"
    pre.mkdir()
    _verb(pre, "dynadjust", "-n", "pb", *files, *PIPE_FRAME, "-g", gsb,
          "--convert-stn-hts", "--import", "--reftran", "--geoid",
          "--segment", "--min-inner-stns", "600", "--max-block-stns",
          "1200")
    net_saved = project.load_network(str(pre), "pb")
    seg = Segmentation.load(str(pre / "pb.seg.pkl"))
    direct = adjust_tpu_blocked(net_saved, AdjustmentOptions(), seg=seg,
                                super_blocks=4, device=device)
    dxyz = float(np.abs(r.xyz - direct.xyz).max())
    _say(f"pipeline b vs adjust_tpu_blocked(super_blocks=4) on the network "
         f"its first four stages saved: {direct.iterations} iterations "
         f"({r.iterations}), xyz {dxyz:.3e} m (<= 1e-6), "
         f"{time.perf_counter() - t:.2f} s")
    _check(direct.iterations == r.iterations, "direct nested iterations")
    _check(dxyz <= 1e-6, f"10k pipeline vs direct nested xyz {dxyz}")
    return out


def _dna_inputs(d, name, rows, cols):
    """DNA files of the seeded mixed network (the cli phase's inputs)."""
    net, _ = synthetic_mixed_network(rows, cols, block_rows=34,
                                     block_cols=34, seed=0)
    files = [str(d / f"{name}.stn"), str(d / f"{name}.msr")]
    write_dna_stn(files[0], net)
    write_dna_msr(files[1], net)
    return files


def _binary_bytes(folder, name):
    return {ext: os.path.getsize(Path(folder) / f"{name}.{ext}")
            for ext in ("bst", "bms", "asl", "aml", "map", "dbid")}


def _same_saved_networks(a, b, what):
    """Gate: the network imported from the binary pair (b) is the one
    imported from DNA (a): the same stations and records, the records'
    values and the coordinates equal (the .bst holds radians and its
    import converts them to DMS and back, as the DNA import converts the
    file's DMS: latitudes and longitudes within 8 units in the last
    place) and sigmas within 1e-15 relative (the .bms holds
    variances)."""
    _check(a.names == b.names and len(a.measurements) == len(
        b.measurements), f"{what}: stations and records")
    dc = max(float(np.abs(getattr(a, k) - getattr(b, k)).max())
             for k in ("lat", "lon"))
    ulps = max(float((np.abs(getattr(a, k) - getattr(b, k))
                      / np.spacing(np.abs(getattr(a, k)))).max())
               for k in ("lat", "lon"))
    dh = float(np.abs(a.height - b.height).max())
    dv = dsd = 0.0
    for ra, rb in zip(a.measurements, b.measurements):
        _check(type(ra).__name__ == type(rb).__name__, f"{what}: types")
        if hasattr(ra, "obs"):
            for oa, ob in zip(ra.obs, rb.obs):
                dv = max(dv, float(np.abs(oa.vec - ob.vec).max()))
                dsd = max(dsd, float(np.abs(oa.vcv - ob.vcv).max()
                                     / np.abs(oa.vcv).max()))
        else:
            dv = max(dv, abs(ra.value - rb.value))
            dsd = max(dsd, abs(ra.sd - rb.sd) / ra.sd)
    _say(f"{what}: {len(a.names)} stations, {len(a.measurements)} records; "
         f"max |d lat/lon| {dc:.3e} rad, {ulps:.0f} units in the last place "
         f"(<= 8), |d height| {dh:.3e} m (0), |d value| {dv:.3e} (0), "
         f"sigma rel {dsd:.3e} (<= 1e-15)")
    _check(ulps <= 8 and dh == 0.0 and dv == 0.0 and dsd <= 1e-15,
           f"{what}: coordinates and values")


def phase_formats(work, ref, sizes=((40, 40), (100, 100)), dev=()):
    """The binary and simulated inputs through the port's CLI: (a) at
    sizes[0], import --export-bst-bms, a fresh project imported from the
    .bst/.bms pair (the .dbid beside it), segment and adjust --phased
    --tpu, held to `ref` (the same route on the DNA import: iterations,
    saved xyz within 1e-9 m), and metadata of both files; (b) at
    sizes[0], import --simulate, the stations imported with
    <net>.simulated.msr, segment and adjust --phased --tpu: max_corr <
    5e-4 m and sigma zero < 0.01 (tests/test_simulate.py's bounds);
    (c) at sizes[1], import --export-bst-bms and the import of the pair:
    the same network.  dev: extra adjust arguments (a CPU trial passes
    --device cpu)."""
    out = {"launches": {}, "seconds": {}, "shapes": {}}
    work = Path(work)
    (ra, ca), (rb, cb) = sizes
    seg = ["--min-inner-stns", "300", "--max-block-stns", "600"]

    # (a) the binary pair at 1,600 stations
    d = work / "fa"
    d.mkdir()
    files = _dna_inputs(d, "fa", ra, ca)
    t_exp, exp_out = _verb(d, "import", "-n", "fa", *files,
                           "--export-bst-bms")
    nbytes = _binary_bytes(d, "fa")
    b = d / "binary"
    b.mkdir()
    t_imp = _verb(b, "import", "-n", "fa", str(d / "fa.bst"),
                  str(d / "fa.bms"))[0]
    _same_saved_networks(project.load_network(str(d), "fa"),
                         project.load_network(str(b), "fa"),
                         f"formats {ra}x{ca} binary import")
    t_seg = _verb(b, "segment", "fa", *seg)[0]
    r, t, steps, launches, shapes, summary = _cli_adjust(
        b, "fa", ["--phased", "--tpu", *dev])
    out["launches"]["formats_binary_phased"] = launches
    out["shapes"]["formats_binary_phased"] = list(shapes)
    meta = {}
    for ext in ("bst", "bms"):
        meta[ext] = _verb(d, "metadata", str(d / f"fa.{ext}"))
    dxyz = float(np.abs(r.xyz - ref.xyz).max())
    out["seconds"][f"{ra}x{ca} binary"] = {
        "import --export-bst-bms": t_exp, "import .bst/.bms": t_imp,
        "segment": t_seg, "adjust --phased --tpu": t, "adjust_steps": steps,
        "metadata": {k: v[0] for k, v in meta.items()}}
    _say(f"formats {ra}x{ca} binary: export {t_exp:.2f} s ({nbytes} "
         f"bytes), import of the pair {t_imp:.2f} s, segment {t_seg:.2f} "
         f"s, adjust --phased --tpu {t:.2f} s; {' | '.join(summary)}; "
         f"{r.iterations} iterations (DNA import {ref.iterations}), saved "
         f"xyz {dxyz:.3e} m from the DNA import's (<= 1e-9); chol_inv "
         f"launches {launches} {shapes}")
    for ext, (secs, text) in meta.items():
        _say(f"  metadata fa.{ext} ({secs:.2f} s): " + "; ".join(
            ln.strip() for ln in text.splitlines()[:4]))
        _check(f"bin_count:" in text, f"metadata of fa.{ext}")
    _check(r.status == "Converged" and r.iterations == ref.iterations,
           f"binary import: {r.status} in {r.iterations}")
    _check(dxyz <= 1e-9, f"binary import xyz vs the DNA import {dxyz}")
    _check(launches > 0 or bool(dev), "the binary import's adjustment "
           "launched the kernel")

    # (b) simulated measurements at 1,600 stations
    d = work / "fs"
    d.mkdir()
    files = _dna_inputs(d, "fs", ra, ca)
    t_sim, sim_out = _verb(d, "import", "-n", "fs", *files, "--simulate")
    s = d / "sim"
    s.mkdir()
    t_imp = _verb(s, "import", "-n", "fs", files[0],
                  str(d / "fs.simulated.msr"))[0]
    t_seg = _verb(s, "segment", "fs", *seg)[0]
    r, t, steps, launches, shapes, summary = _cli_adjust(
        s, "fs", ["--phased", "--tpu", *dev])
    out["launches"]["formats_simulated_phased"] = launches
    out["shapes"]["formats_simulated_phased"] = list(shapes)
    out["seconds"][f"{ra}x{ca} simulate"] = {
        "import --simulate": t_sim, "import simulated": t_imp,
        "segment": t_seg, "adjust --phased --tpu": t, "adjust_steps": steps}
    _say(f"formats {ra}x{ca} simulate: import --simulate {t_sim:.2f} s "
         f"({os.path.getsize(d / 'fs.simulated.msr')} bytes), import "
         f"{t_imp:.2f} s, segment {t_seg:.2f} s, adjust --phased --tpu "
         f"{t:.2f} s; {' | '.join(summary)}; max_corr {r.max_corr:.3e} m "
         f"(< 5e-4), sigma zero {r.sigma_zero:.3e} (< 0.01); chol_inv "
         f"launches {launches} {shapes}")
    _check(r.status == "Converged" and abs(r.max_corr) < 5e-4
           and r.sigma_zero < 0.01, f"simulated network: {r.status}, "
           f"max_corr {r.max_corr}, sigma zero {r.sigma_zero}")

    # (c) the binary pair at 10,000 stations
    d = work / "fb"
    d.mkdir()
    files = _dna_inputs(d, "fb", rb, cb)
    t_exp = _verb(d, "import", "-n", "fb", *files, "--export-bst-bms")[0]
    nbytes = _binary_bytes(d, "fb")
    b = d / "binary"
    b.mkdir()
    t_imp = _verb(b, "import", "-n", "fb", str(d / "fb.bst"),
                  str(d / "fb.bms"))[0]
    out["seconds"][f"{rb}x{cb} binary"] = {
        "import --export-bst-bms": t_exp, "import .bst/.bms": t_imp,
        "bytes": nbytes}
    _say(f"formats {rb}x{cb} binary: import --export-bst-bms {t_exp:.2f} s "
         f"({nbytes} bytes), import of the pair {t_imp:.2f} s")
    _same_saved_networks(project.load_network(str(d), "fb"),
                         project.load_network(str(b), "fb"),
                         f"formats {rb}x{cb} binary import")
    return out


def _alone_and_in_turns(fns, args, reps):
    """Seconds per call of each function of fns on args: first each alone
    (reps calls in a row), then in turns (each right after the other);
    and the native function's last output."""
    times = {}
    for order in ("alone", "in turns"):
        seq = ([n for n in fns for _ in range(reps)] if order == "alone"
               else list(fns) * reps)
        for name in seq:
            t = time.perf_counter()
            y = fns[name](*args)
            times.setdefault(f"{name} {order}", []).append(
                time.perf_counter() - t)
            if name == "native":
                got = y
    return times, got


def phase_native(B, ni, nj, reps=4):
    """The host kernel library against its numpy versions: the blocked
    matvec (the host refinement loop's block products,
    schur._block_matvec) at the 10k network's host-assembly shapes (B,
    ni, nj), float64 from a seed, each alone and in turns, each right
    after the other (BLAS's threads still spinning); and the GNSS baseline
    residuals (parallel/assembly.assemble) at the 10,000-station GNSS
    network of the gnss phase (29,601 baselines), each alone and in turns
    (20 calls each).  Max relative difference and seconds per call."""
    rng = np.random.default_rng(0)
    args = [rng.standard_normal(shp) for shp in (
        (B, ni, ni), (B, ni, nj), (B, nj, nj), (B, ni), (B, nj))]
    times, got = _alone_and_in_turns(
        {"native": native.block_matvec, "numpy": native.block_matvec_plain},
        args, reps)
    want = native.block_matvec_plain(*args)
    rel = max(float(np.abs(g - w).max() / np.abs(w).max())
              for g, w in zip(got, want))
    nbytes = sum(a.nbytes for a in args)
    _say(f"native block_matvec at ({B}, {ni}, {nj}) ({nbytes / 1e9:.2f} GB "
         f"of float64 operands), s per call: {json.dumps(times)}; max rel "
         f"difference {rel:.3e} (<= 1e-12)")
    _check(rel <= 1e-12, f"native block_matvec vs numpy {rel}")

    xyz, pairs, obs, var, x0, fixed = synthetic_grid_network(100, 100,
                                                             seed=7)
    args = (pairs, obs, x0)
    rtimes, got = _alone_and_in_turns(
        {"native": native.baseline_residuals,
         "numpy": native.baseline_residuals_plain}, args, 20)
    want = native.baseline_residuals_plain(*args)
    rel = float(np.abs(got - want).max() / np.abs(want).max())
    _say(f"native baseline_residuals at M = {len(pairs)} (10k GNSS), s per "
         f"call (min, median, max of 20): " + json.dumps(
             {k: [min(v), float(np.median(v)), max(v)]
              for k, v in rtimes.items()})
         + f"; max rel difference {rel:.3e} (<= 1e-12)")
    _check(rel <= 1e-12, f"native baseline_residuals vs numpy {rel}")
    return {"shape": [B, ni, nj], **times,
            "baseline_residuals": {"M": len(pairs), **rtimes}}


# the GNSS-only blocked adjustment (ROADMAP.md M5): bench.py's network
# (BENCH_MODE=gnss at its defaults, 64 x 64 stations in blocks of 16) and
# the 10k cell (100 x 100 in blocks of 25), both seed 7 as bench.py's,
# free-station weight 0.01 (free SD 10 m) as bench.py's build_normals
GNSS_NETS = {"4096": (64, 64, 16), "10k": (100, 100, 25)}
GNSS_FREE_WEIGHT = 0.01
GNSS_STEPS = 20                  # bench.py's device-only loop (_dev_loop)
GNSS_XYZ_TOL = 1e-6              # device loop vs float64 adjust_blocked, m
GNSS_SOLVE_REL = 1e-9            # schur_solve_device vs float64 schur_solve
GNSS_METHODS = ("inv", "chol", "inv64")


def _gnss_network(rows, cols, blk):
    """bench.py's GNSS network: (BlockedNetwork, x0, true xyz)."""
    xyz, pairs, obs, var, x0, fixed = synthetic_grid_network(rows, cols,
                                                             seed=7)
    blocks, junction = grid_segmentation(rows, cols, blk, blk)
    bn = BlockedNetwork(nstations=rows * cols, pairs=pairs, obs=obs,
                        weight=1.0 / var, blocks=blocks,
                        junction_stations=junction, constrained=fixed)
    return bn, x0, xyz


_STEP_GROUPS = (("scatter", r"index_add|indexFunc|scatter|index_put|put_"),
                ("cublas", r"gemm|gemv|cublas|cutlass|xmma|sm90"),
                ("gather", r"index|gather"))


def _step_split(adj, x):
    """torch.profiler split of one warm Gauss-Newton step's device time:
    the Cholesky-inverse kernel (none: the factors are built at setup),
    cuBLAS products, scatters (index_add_, index_put_), gathers and the
    rest, with the five costliest device functions.  The profiled step
    is the second of two in the profile, inside a "dta.gnss_step" range,
    and a device function counts when the runtime call that launched it
    lies in that range: in a process that has run profiles before, the
    device functions of a profile's first launches may be missing."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    adj.step(x)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        adj.step(x)
        torch.cuda.synchronize()
        with record_function("dta.gnss_step"):
            adj.step(x)
        torch.cuda.synchronize()
    ev = prof.events()
    host = [e for e in ev if e.device_type == DeviceType.CPU]
    step = next(e for e in host if e.name == "dta.gnss_step")
    a, b = step.time_range.start, step.time_range.end
    launch = {e.id: e.time_range.start for e in host
              if e.name.startswith("cu")}
    kern = _global_functions("chol_inv.cu")
    split, by_name = {}, {}
    for e in ev:
        if (e.device_type != DeviceType.CUDA or e.name.startswith("dta.")
                or not a <= launch.get(e.id, -1.0) <= b):
            continue
        ms = e.time_range.elapsed_us() / 1e3
        if any(re.search(rf"\b{k}\b", e.name) for k in kern):
            group = "kernel"
        else:
            group = next((g for g, rx in _STEP_GROUPS
                          if re.search(rx, e.name, re.I)), "other")
        d = split.setdefault(group, {"ms": 0.0, "launches": 0})
        d["ms"] += ms
        d["launches"] += 1
        by_name[e.name[:70]] = by_name.get(e.name[:70], 0.0) + ms
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    return {"groups": split, "device_ms": sum(v["ms"]
                                              for v in split.values()),
            "launches": sum(v["launches"] for v in split.values()),
            "top": [[n, ms] for n, ms in top]}


def phase_gnss(label, rows, cols, blk):
    """The GNSS-only blocked adjustment on the card (bench.py's
    bench_gnss split): build_plan; DeviceAdjustment's setup (upload and
    one factorization: one kernel launch at (B, ni), so no jittered
    retry) and run, counts zeroed just before and read just after, held
    to the float64 adjust_blocked on the same card (the same iterations,
    xyz within GNSS_XYZ_TOL m, max_corr <= 5e-4 m); the kernel's status on
    the network's own scaled blocks; one warm step (CUDA events), 20
    steps with no host sync, the torch.profiler split of one step; each
    DeviceSchurFactors method through schur_solve_device against the
    float64 schur_solve (GNSS_SOLVE_REL of the largest correction), with
    bench.py's factor + apply and apply-only seconds per solve; the
    kernel held at (B, ni).  Returns (launches, their shapes, record)."""
    t_phase = time.perf_counter()
    out = {}
    bn, x0, truth = _gnss_network(rows, cols, blk)
    t = time.perf_counter()
    plan = build_plan(bn, GNSS_FREE_WEIGHT)
    out["build_plan_s"] = time.perf_counter() - t
    B, ni = len(bn.blocks), plan.ni
    _say(f"gnss {label}: {bn.nstations} stations, {len(bn.pairs)} "
         f"baselines, {B} blocks, level 1 at ({B}, {ni}), nj {plan.nj}, "
         f"{plan.nj_global} junction parameters; build_plan "
         f"{out['build_plan_s']:.3f} s")

    batched_cholesky_inverse.launches = 0
    batched_cholesky_inverse.shapes = {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    adj = DeviceAdjustment(plan)
    torch.cuda.synchronize()
    out["setup_s"] = time.perf_counter() - t
    setup_launches = batched_cholesky_inverse.launches
    t = time.perf_counter()
    x, it, mc, hist = adj.run(x0)
    out["run_s"] = time.perf_counter() - t
    launches = batched_cholesky_inverse.launches
    shapes = dict(batched_cholesky_inverse.shapes)
    out["device_memory_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    t = time.perf_counter()
    xr, itr, mcr, hr = adjust_blocked(bn, x0, device="cuda")
    out["adjust_blocked_f64_s"] = time.perf_counter() - t
    dx = float(np.abs(x - xr).max())
    err = float(np.abs(x - truth).max())
    out.update(iterations=it, max_corr=mc, history=hist, xyz_vs_f64=dx)
    _say(f"gnss {label} DeviceAdjustment: setup {out['setup_s']:.3f} s, "
         f"run {out['run_s']:.3f} s, {it} iterations (float64 "
         f"adjust_blocked {itr}, {out['adjust_blocked_f64_s']:.3f} s), "
         f"max_corr {mc:.3e} m, history {hist}, xyz vs float64 {dx:.3e} m "
         f"(<= {GNSS_XYZ_TOL:g}), max|xyz - truth| {err:.4f} m; device "
         f"memory peak {out['device_memory_peak_gb']:.2f} GB; chol_inv "
         f"launches {launches} (setup {setup_launches}) {shapes}")
    _check(np.isfinite(x).all() and x.shape == x0.shape, "finite xyz")
    _check(it == itr, f"gnss {label}: {it} iterations, float64 {itr}")
    _check(mc <= 5e-4, f"gnss {label}: max_corr {mc}")
    _check(dx <= GNSS_XYZ_TOL, f"gnss {label}: xyz vs float64 {dx}")
    _check(setup_launches == launches == 1 and list(shapes) == [(B, ni)],
           f"gnss {label}: one launch at ({B}, {ni}) in setup, no "
           f"jittered retry")

    # the kernel's status on this network's own scaled level-1 blocks
    Nii_s = schur._scaled_normals(*(a.float() for a in (
        adj.Nii64, adj.Nij64, adj.Njj64)), adj.jmap, adj.jmask32,
        adj.nj_total)[0]
    Linv, status = batched_cholesky_inverse(Nii_s)
    L64 = Linv.double()
    eye = torch.eye(ni, dtype=torch.float64, device=adj.device)
    resid = float((L64 @ Nii_s.double() @ L64.transpose(1, 2) - eye)
                  .abs().max())
    del Nii_s, Linv, L64
    _say(f"gnss {label} kernel on the network's scaled blocks: status "
         f"{status.tolist()}, max|Linv N Linv^T - I| {resid:.3e}")
    _check(int(status.sum()) == 0, f"gnss {label}: kernel status")

    xd = torch.as_tensor(x0, dtype=torch.float64, device=adj.device)
    out["step_ms"] = _time_ms(lambda: adj.step(xd), reps=5)
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    xk = xd
    e0.record()
    for _ in range(GNSS_STEPS):
        xk, _ = adj.step(xk)
    e1.record()
    torch.cuda.synchronize()
    out["loop_step_ms"] = e0.elapsed_time(e1) / GNSS_STEPS
    out["step_split"] = _step_split(adj, xd)
    _check(out["step_split"]["launches"] > 0,
           f"gnss {label}: the step's profile shows its device functions")
    _say(f"gnss {label} step: {out['step_ms']:.3f} ms (one, CUDA events), "
         f"{out['loop_step_ms']:.3f} ms each of {GNSS_STEPS} with no host "
         f"sync; device split of one step {json.dumps(out['step_split'])}")
    del adj, xd, xk
    torch.cuda.empty_cache()

    bs = build_normals(bn, x0, GNSS_FREE_WEIGHT)
    xi64, xj64 = schur_solve(bs, device="cuda")
    scale = max(float(np.abs(xi64).max()), float(np.abs(xj64).max()))
    out["solves"] = {}
    for method in GNSS_METHODS:
        torch.cuda.synchronize()
        t = time.perf_counter()
        f = DeviceSchurFactors(bs, method=method)
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t
        xi, xj, _ = schur_solve_device(bs, refine=2, factors=f)
        rel = max(float(np.abs(xi - xi64).max()),
                  float(np.abs(xj - xj64).max())) / scale
        reps = 3
        t = time.perf_counter()
        for _ in range(reps):
            f.refactor()
            schur_solve_device(bs, refine=2, factors=f)
        fa_s = (time.perf_counter() - t) / reps
        t = time.perf_counter()
        for _ in range(reps):
            schur_solve_device(bs, refine=2, factors=f)
        ap_s = (time.perf_counter() - t) / reps
        out["solves"][method] = {"rel": rel, "setup_s": setup_s,
                                 "factor_apply_s": fa_s, "apply_s": ap_s}
        _say(f"gnss {label} schur_solve_device method {method}: vs float64 "
             f"schur_solve {rel:.3e} of the largest correction "
             f"({scale:.3e} m; <= {GNSS_SOLVE_REL:g}); setup {setup_s:.3f} "
             f"s, per solve factor + apply {fa_s:.4f} s, apply-only "
             f"{ap_s:.4f} s")
        _check(rel <= GNSS_SOLVE_REL, f"gnss {label} {method}: {rel}")
        del f
        torch.cuda.empty_cache()

    out["kernel"] = _hold_kernel(_spd(B, ni))[1]
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_phase
    _say(f"gnss {label}: {out['seconds']:.2f} s")
    return launches, shapes, out


def phase_f9(work):
    """ROADMAP.md F9's network through the CLI on the card: the 6 x 6 mixed
    network (3 x 3 tiles) as DNA files, import --simulate, then
    phase_block1 on the stations and the simulated records with segment
    --min-inner-stns 10 --max-block-stns 20.  Block 1's scaled normals
    (condition number 2.0e9) fail the float32 factor: each device route
    must solve it on the float64 route and say so in its Newton
    records."""
    d = Path(work) / "f9"
    d.mkdir()
    net, _ = synthetic_mixed_network(6, 6, block_rows=3, block_cols=3)
    files = [str(d / "n.stn"), str(d / "n.msr")]
    write_dna_stn(files[0], net)
    write_dna_msr(files[1], net)
    _verb(d, "import", "-n", "n", *files, "--simulate")
    out = {"launches": {}, "shapes": {}, "seconds": {}}
    records = phase_block1(d, [files[0], str(d / "n.simulated.msr")], out,
                           name="s", key="f9", size="6x6",
                           segment=("10", "20"), allow_f64=True)
    for route, newton in records.items():
        _check(any(x["route"] == "f64" for x in newton),
               f"f9 {route}: block 1 took the float64 route")
    return out


# the mesh phase (parallel/multihost.py): bench.py's 10k network over one
# nccl rank and over MESH_RANKS gloo ranks sharing the card, each rank's
# run held to the single-device run of its path (__graft_entry__.py:
# 133-142's bounds), every rank bitwise rank 0
MESH_RANKS = 4
MESH_XYZ_TOL = 1e-8
MESH_SIGMA0_TOL = 1e-9


def _mesh_runs(mesh, rows, cols, tile, block_super):
    """The two-level and the nested adjustment of the network over mesh,
    kernel launches and collectives zeroed just before each run and read
    just after: {path: record}.  Over several ranks the nested run's
    covariance stage takes the route past DTA_COV_DEV_BYTES (its refined
    level-1 pools gathered on the host), the two-level run's the device
    gather."""
    from dynadjust_tpu_torch.parallel import multihost as mh
    out = {}
    for path, kw in (("two_level", {}),
                     ("nested", dict(super_blocks=4,
                                     block_super=block_super))):
        net, seg = synthetic_mixed_network(rows, cols, block_rows=tile,
                                           block_cols=tile, seed=0)
        cov_on_host = path == "nested" and mesh.size > 1
        if cov_on_host:
            os.environ["DTA_COV_DEV_BYTES"] = "1"
        torch.cuda.synchronize(mesh.device)
        torch.cuda.reset_peak_memory_stats(mesh.device)
        batched_cholesky_inverse.launches = 0
        batched_cholesky_inverse.shapes = {}
        mh.reset_counts()
        t = time.perf_counter()
        try:
            res = adjust_tpu_blocked(net, AdjustmentOptions(), seg=seg,
                                     mesh=mesh, **kw)
        finally:
            os.environ.pop("DTA_COV_DEV_BYTES", None)
        torch.cuda.synchronize(mesh.device)
        out[path] = dict(
            cov_on_host=cov_on_host,
            peak_gb=torch.cuda.max_memory_allocated(mesh.device) / 1e9,
            wall=time.perf_counter() - t, xyz=res.xyz,
            sigma_zero=res.sigma_zero, status=res.status,
            iterations=res.iterations,
            launches=batched_cholesky_inverse.launches,
            shapes=dict(batched_cholesky_inverse.shapes),
            counts=dict(mh.COUNTS), evidence=res.refine_evidence,
            per_iteration=[e["collectives"] for e in res.iteration_log])
    return out


def _mesh_rank(mesh, rows, cols, tile, block_super, folder):
    """One gloo rank of the mesh phase: both runs, then the kernel held
    (phase 2's gates, which raise) and timed at each shape this rank
    launched it at, on the card the other ranks share (after the counts
    were read: these launches are not the path's)."""
    out = _mesh_runs(mesh, rows, cols, tile, block_super)
    shapes = {s for rec in out.values() for s in rec["shapes"]}
    out["kernel"] = {shp: _hold_kernel(_spd(*shp, seed=mesh.rank))[1]
                     for shp in sorted(shapes)}
    with open(Path(folder) / f"rank{mesh.rank}.pkl", "wb") as f:
        pickle.dump(out, f)


def _per_iteration(snaps):
    """Per-iteration (all_reduce calls, broadcasts, bytes) from the
    cumulative snapshots of the iteration log."""
    prev = {"all_reduce": 0, "broadcast": 0, "bytes": 0}
    rows = []
    for s in snaps:
        rows.append((s["all_reduce"] - prev["all_reduce"],
                     s["broadcast"] - prev["broadcast"],
                     s["bytes"] - prev["bytes"]))
        prev = s
    return rows


def phase_mesh(rows, cols, tile, block_super, refs):
    """The mesh route: one nccl rank on cuda:0 in this process (the
    kernel's shapes are those phases 2 and 5 hold), then MESH_RANKS
    spawned gloo ranks sharing cuda:0, each holding the kernel at its
    shard shapes; each run held to refs (the single-device results of
    phases 3 and 6, by path).  Returns
    (launches by path, {path: {(B, n): launches}})."""
    import torch.distributed as dist
    from dynadjust_tpu_torch.parallel import multihost as mh
    runs = {}
    t = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        mh.init_distributed(num_processes=1, process_id=0, backend="nccl",
                            init_method=f"file://{tmp}/store",
                            device="cuda:0")
        try:
            runs["nccl1"] = [_mesh_runs(mh.global_block_mesh(), rows, cols,
                                        tile, block_super)]
        finally:
            dist.destroy_process_group()
    _say(f"mesh nccl x 1: {time.perf_counter() - t:.2f} s")
    torch.cuda.empty_cache()
    t = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        mh.spawn_ranks(_mesh_rank, MESH_RANKS, f"file://{tmp}/store",
                       backend="gloo", device="cuda:0",
                       args=(rows, cols, tile, block_super, tmp),
                       timeout=900)
        runs[f"gloo{MESH_RANKS}"] = []
        for r in range(MESH_RANKS):
            with open(Path(tmp) / f"rank{r}.pkl", "rb") as f:
                runs[f"gloo{MESH_RANKS}"].append(pickle.load(f))
    _say(f"mesh gloo x {MESH_RANKS} on one card (spawned, started to "
         f"joined): {time.perf_counter() - t:.2f} s")
    launches, shapes = {}, {}
    for kind, ranks in runs.items():
        for path, ref in refs.items():
            rank0 = ranks[0][path]
            for r, out in enumerate(ranks):
                rec = out[path]
                dx = float(np.abs(rec["xyz"] - ref.xyz).max())
                ds = abs(rec["sigma_zero"] - ref.sigma_zero)
                key = f"mesh_{kind}_{path}_rank{r}"
                launches[key] = rec["launches"]
                shapes[key] = dict(rec["shapes"])
                _say(f"mesh {kind} {path} rank {r}/{len(ranks)}: "
                     f"{rec['status']} in {rec['iterations']} iterations "
                     f"(single device {ref.iterations}), wall "
                     f"{rec['wall']:.2f} s, peak device memory "
                     f"{rec['peak_gb']:.3f} GB (covariance pools gathered "
                     f"on the {'host' if rec['cov_on_host'] else 'device'}"
                     f"), xyz {dx:.3e} m (<= "
                     f"{MESH_XYZ_TOL:g}), sigma0 {ds:.3e} (<= "
                     f"{MESH_SIGMA0_TOL:g}), chol_inv launches "
                     f"{rec['launches']} {rec['shapes']}; collectives "
                     f"{rec['counts']}; per iteration (all_reduce, "
                     f"broadcast, bytes) {_per_iteration(rec['per_iteration'])}"
                     f"; refine evidence {rec['evidence']}")
                _check(rec["status"] == "Converged"
                       and rec["iterations"] == ref.iterations,
                       f"{key}: {rec['status']} in {rec['iterations']}")
                _check(dx <= MESH_XYZ_TOL and ds <= MESH_SIGMA0_TOL,
                       f"{key}: xyz {dx}, sigma0 {ds}")
                _check(rec["launches"] > 0, f"{key} launched the kernel")
                _check(rec["counts"]["all_reduce"] > 0,
                       f"{key} summed over the ranks")
                _check(np.array_equal(rec["xyz"], rank0["xyz"])
                       and rec["sigma_zero"] == rank0["sigma_zero"],
                       f"{key} is bitwise rank 0")
    for r, out in enumerate(runs[f"gloo{MESH_RANKS}"]):
        for (B, n), g in out["kernel"].items():
            _say(f"mesh gloo{MESH_RANKS} rank {r} kernel ({B}, {n}) on the "
                 f"shared card: {g['ms']:.3f} ms per call (plain "
                 f"{g['plain_ms']:.1f}, library {g['library_ms']:.3f}), "
                 f"max|kernel-plain| {g['max_abs_err']:.3e}")
    return launches, shapes


def phase_mesh_cli(work):
    """adjust --phased --tpu --devices 1 (one nccl rank in this process)
    on the cli phase's 1,600-station DNA files, held to the single-device
    --phased --tpu run; --devices 2 on a one-card machine exits 1 with the
    JAX CLI's message."""
    d = Path(work) / "mesh_cli"
    d.mkdir()
    files = _dna_inputs(d, "n40", 40, 40)
    res, out = {}, {"launches": {}, "shapes": {}}
    for key, extra in (("single", []), ("devices1", ["--devices", "1"])):
        f = d / key
        f.mkdir()
        _verb(f, "import", "-n", "n40", *files)
        _verb(f, "segment", "n40", "--min-inner-stns", "300",
              "--max-block-stns", "600")
        r, t, steps, launches, shapes, summary = _cli_adjust(
            f, "n40", ["--phased", "--tpu", *extra])
        res[key] = r
        out["launches"][f"cli_mesh_{key}"] = launches
        out["shapes"][f"cli_mesh_{key}"] = list(shapes)
        _say(f"mesh cli 40x40 {key}: adjust {t:.2f} s; "
             f"{' | '.join(summary)}; chol_inv launches {launches} "
             f"{shapes}")
        _check(launches > 0, f"mesh cli {key} launched the kernel")
    a, b = res["devices1"], res["single"]
    dx = float(np.abs(a.xyz - b.xyz).max())
    ds = abs(a.sigma_zero - b.sigma_zero)
    _say(f"mesh cli --devices 1 vs single: {a.iterations} iterations "
         f"({b.iterations}), saved xyz {dx:.3e} m (<= {MESH_XYZ_TOL:g}), "
         f"sigma0 {ds:.3e} (<= {MESH_SIGMA0_TOL:g})")
    _check(a.status == "Converged" and a.iterations == b.iterations
           and dx <= MESH_XYZ_TOL and ds <= MESH_SIGMA0_TOL,
           "mesh cli --devices 1 against the single-device run")
    ncard = torch.cuda.device_count()
    if ncard == 1:
        err = io.StringIO()
        with contextlib.redirect_stderr(err), \
                contextlib.redirect_stdout(io.StringIO()):
            rc = cli.main(["adjust", "n40", "--phased", "--tpu",
                           "--devices", "2", "--output-folder",
                           str(d / "single")])
        msg = "--devices 2 but only 1 devices visible"
        _say(f"mesh cli --devices 2 on one card: exit {rc}; "
             f"{err.getvalue().strip()}")
        _check(rc == 1 and msg in err.getvalue(),
               "--devices 2 on one card exits 1 with the message")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    t = time.perf_counter()
    _say(card_line())
    secs, reports = kernels.timed_build()
    for name, rep in reports.items():
        _say(f"--- nvcc {name}.cu ---\n{rep.strip()}")
    t = time.perf_counter()
    native.build(force=True)
    _say(f"phase build: {secs:.2f} s (nvcc); host kernel library "
         f"{native.LIBRARY.name} (g++): {time.perf_counter() - t:.2f} s")

    rows = cols = 100
    tile = 34
    super_blocks = 4
    block_super = _grid_grouping(rows, cols, tile, super_blocks)
    (B, ni), (SB, ni2, n_real), nj = _main_path_shapes(rows, cols, tile,
                                                       block_super)
    t = time.perf_counter()
    kern = phase_kernel(B, ni)
    _say(f"phase kernel: {time.perf_counter() - t:.2f} s")

    t = time.perf_counter()
    flat, launches_flat, _, _ = phase_main(rows, cols, tile)
    _say(f"phase main: {time.perf_counter() - t:.2f} s")

    t = time.perf_counter()
    phase_trace(rows, cols, tile)
    _say(f"phase trace: {time.perf_counter() - t:.2f} s")

    t = time.perf_counter()
    phase_card_vs_cpu()
    _say(f"phase card-vs-cpu: {time.perf_counter() - t:.2f} s")

    t = time.perf_counter()
    kern2 = phase_kernel_level2(SB, ni2, n_real)
    _say(f"phase kernel level 2: {time.perf_counter() - t:.2f} s")

    nested = dict(super_blocks=super_blocks, block_super=block_super)
    launches_nested, nested_res = phase_nested(
        rows, cols, tile, super_blocks, block_super, flat, (B, ni),
        (SB, ni2))
    t = time.perf_counter()
    phase_trace(rows, cols, tile, **nested)
    _say(f"phase nested trace: {time.perf_counter() - t:.2f} s")

    for fuse in ("6e8", "0"):
        t = time.perf_counter()
        os.environ["DTA_NESTED_FUSE_BYTES"] = fuse
        route = "one-pass" if fuse != "0" else "staged"
        phase_card_vs_cpu(f"nested {route}", super_blocks=2)
        del os.environ["DTA_NESTED_FUSE_BYTES"]
        _say(f"phase nested {route} card-vs-cpu: "
             f"{time.perf_counter() - t:.2f} s")

    t = time.perf_counter()
    torch.cuda.empty_cache()
    mesh_launches, mesh_shapes = phase_mesh(
        rows, cols, tile, block_super,
        {"two_level": flat, "nested": nested_res})
    torch.cuda.empty_cache()
    _say(f"phase mesh: {time.perf_counter() - t:.2f} s")

    # the host routes: staged nested factors, host assembly, the 40k
    # network past the device-solve budget; the national-scale runs
    host_launches, host_shapes = {}, {}
    host_phases = [
        ("staged", lambda: phase_staged(rows, cols, tile, super_blocks,
                                        block_super, nested_res)),
        ("host assembly", lambda: phase_host_assembly(rows, cols, tile,
                                                      flat)),
        ("national", lambda: phase_national(200, 200, tile)),
        ("national_mixed", lambda: _in_folder(phase_national_mixed)),
        ("national_streamed", phase_national_streamed)]
    for name, run in host_phases:
        t = time.perf_counter()
        la, sh = run()
        host_launches.update(la)
        host_shapes.update(sh)
        torch.cuda.empty_cache()
        _say(f"phase {name}: {time.perf_counter() - t:.2f} s")
    t = time.perf_counter()
    phase_native(B, ni, nj)
    _say(f"phase native: {time.perf_counter() - t:.2f} s")

    t = time.perf_counter()
    gnss = {label: phase_gnss(label, *net)
            for label, net in GNSS_NETS.items()}
    with tempfile.TemporaryDirectory() as work:
        f9 = phase_f9(work)
    _say(f"phase gnss: {time.perf_counter() - t:.2f} s")

    t = time.perf_counter()
    os.environ["DTA_PROFILE"] = "1"
    with tempfile.TemporaryDirectory() as work:
        clirun = phase_cli(work, flat.iterations)
    del os.environ["DTA_PROFILE"]
    _say(f"phase cli: {time.perf_counter() - t:.2f} s; verbs (s): "
         + json.dumps(clirun["seconds"]))

    t = time.perf_counter()
    with tempfile.TemporaryDirectory() as work:
        mesh_cli = phase_mesh_cli(work)
    _say(f"phase mesh cli: {time.perf_counter() - t:.2f} s")

    t = time.perf_counter()
    with tempfile.TemporaryDirectory() as work:
        pipe = phase_pipeline(work)
    torch.cuda.empty_cache()
    _say(f"phase pipeline: {time.perf_counter() - t:.2f} s; verbs (s): "
         + json.dumps(pipe["seconds"]))

    t = time.perf_counter()
    with tempfile.TemporaryDirectory() as work:
        fmts = phase_formats(work, clirun["phased_40"])
    _say(f"phase formats: {time.perf_counter() - t:.2f} s; verbs (s): "
         + json.dumps(fmts["seconds"]))

    # the kernel against its plain version at every shape the CLI and
    # pipeline routes launched it at
    t = time.perf_counter()
    cli_paths = {}
    for path, shps in {**clirun["shapes"], **pipe["shapes"],
                       **fmts["shapes"], **f9["shapes"],
                       **mesh_cli["shapes"]}.items():
        for shp in shps:
            cli_paths.setdefault(shp, []).append(path)
    kern_cli = {}
    for shp in sorted(cli_paths):
        kern_cli[shp] = _hold_kernel(_spd(*shp))[1]
        torch.cuda.empty_cache()
    Bd, nd = clirun["dense_shape"]
    _check((Bd, nd) in kern_cli, "the dense shape was held")
    _say(f"phase kernel cli shapes {sorted(cli_paths)}: "
         f"{time.perf_counter() - t:.2f} s")

    # ... and at every other shape the host routes launched it at
    t = time.perf_counter()
    host_paths = {}
    for path, shps in host_shapes.items():
        for shp in shps:
            host_paths.setdefault(shp, []).append(path)
    kern_host = {}
    for shp in sorted(host_paths):
        if shp != (B, ni) and shp not in kern_cli:
            kern_host[shp] = _hold_kernel(_spd(*shp))[1]
            torch.cuda.empty_cache()
    _say(f"phase kernel host-route shapes {sorted(host_paths)} (held "
         f"{sorted(kern_host)}): {time.perf_counter() - t:.2f} s")

    # ... and at the mesh route's shard shapes (the level-1 shard of each
    # rank, the replicated level 2), timed here alone on the card
    t = time.perf_counter()
    mesh_paths = {}
    for path, shps in mesh_shapes.items():
        for shp in shps:
            mesh_paths.setdefault(shp, []).append(path)
    kern_mesh = {}
    for shp in sorted(mesh_paths):
        if shp not in ((B, ni), (SB, ni2)):
            kern_mesh[shp] = _hold_kernel(_spd(*shp))[1]
            torch.cuda.empty_cache()
    _say(f"phase kernel mesh shapes {sorted(mesh_paths)} (held "
         f"{sorted(kern_mesh)}): {time.perf_counter() - t:.2f} s")

    # launches: the nested path's warm run; the two-level path's, the
    # cold nested run's and the CLI routes' beside it
    _say(json.dumps({"kernels": [{
        "name": "chol_inv", "route": "cuda",
        "source": "dynadjust_tpu_torch/csrc/chol_inv.cu",
        "replaces": "dynadjust_tpu/ops/pallas_schur.py:93",
        "launches": launches_nested[1],
        "launches_by_path": {"two_level": launches_flat,
                             "nested_cold": launches_nested[0],
                             "nested_warm": launches_nested[1],
                             **host_launches, **clirun["launches"],
                             **pipe["launches"], **fmts["launches"],
                             **{f"gnss_device_{label}": g[0]
                                for label, g in gnss.items()},
                             **f9["launches"], **mesh_launches,
                             **mesh_cli["launches"]},
        **kern, "level2": {"shape": [int(SB), int(ni2)], **kern2},
        "dense": {"shape": [int(Bd), int(nd)], **kern_cli[(Bd, nd)]},
        "cli": [{"shape": [int(b), int(n)], "paths": cli_paths[(b, n)],
                 **kern_cli[(b, n)]} for b, n in sorted(kern_cli)],
        "host_routes": [{"shape": [int(b), int(n)],
                         "paths": host_paths[(b, n)],
                         "launches": sum(host_shapes[p].get((b, n), 0)
                                         for p in host_paths[(b, n)]),
                         **kern_host[(b, n)]}
                        for b, n in sorted(kern_host)],
        "gnss": [{"shape": [int(b), int(n)],
                  "paths": [f"gnss_device_{label}"], **g[2]["kernel"]}
                 for label, g in gnss.items() for b, n in g[1]],
        "mesh": [{"shape": [int(b), int(n)], "paths": mesh_paths[(b, n)],
                  "launches": sum(mesh_shapes[p][(b, n)]
                                  for p in mesh_paths[(b, n)]),
                  **kern_mesh[(b, n)]} for b, n in sorted(kern_mesh)]}]}))
    _say(card_line())
    _say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
