"""Smoke run of dynadjust_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Phases (each prints its elapsed seconds; any failure raises, and the
script exits non-zero without printing a result):

  1. card name and power limit; build every kernel from csrc/ (nvcc, one
     process per source, all started together) and print the build time;
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
     all converge in the same iterations with sigma zero 0.998 (the JAX
     package's CLI on the same files) and PASSED, .xyz files within 1e-4
     of the host route's number by number and the saved xyz within
     1e-6 m of it.  10,000 stations: import, segment --min-inner-stns
     600 --max-block-stns 1200 and adjust --phased --tpu, held to the
     in-memory two-level run's iterations and to adjust_tpu_blocked
     called directly on the saved network and segmentation with
     super_blocks=4 (xyz within 1e-6 m); its .results.pkl (past the
     dense-covariance cap) loads back without torch.  Each verb is
     timed, write_adj on its own;
  9. kernel at every (B, n) that the CLI routes of phase 8 launched it
     at (the dense (1, 3S), the level-1 blocks of the CLI's segmentation
     at 1,600 and 10,000 stations, and the level-2 systems of
     --tpu-super-blocks 2), with the gates of phase 2, each timed
     against the plain version and the library;
 10. one {"kernels": [...]} line, the card line, and the result line.

Host routes (run between phases 7 and 8; each adjustment prints its
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
  cli (in phase 8): --phased --tpu --staged-adjustment
     --create-stage-files with and without --tpu-super-blocks 2, held
     also to their resident counterparts (.xyz within 1e-4, saved xyz
     within 1e-6 m), and the host sequential phased adjustment
     (--phased, and --staged-adjustment --create-stage-files
     --purge-stage-files without --tpu), which launch no kernel;
  and the kernel held at every new (B, n) these routes launched it at.

Needs one card; exits non-zero when torch.cuda.is_available() is false.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import pickle
import re
import resource
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
from dynadjust_tpu_torch.ops import kernels
from dynadjust_tpu_torch.ops.chol_inv import (batched_cholesky_inverse,
                                              cholesky_inverse_plain,
                                              fused_block_reduce)
from dynadjust_tpu_torch.io_formats.dna_writer import (write_dna_msr,
                                                       write_dna_stn)
from dynadjust_tpu_torch.adjust.device_assembly import DeviceAssembly
from dynadjust_tpu_torch.parallel import schur, streamed
from dynadjust_tpu_torch.parallel.schur import build_nested_partition
from dynadjust_tpu_torch.segment import Segmentation
from dynadjust_tpu_torch.utils.synthetic import grid_super_assignment
from dynadjust_tpu_torch.utils.synthetic_mixed import synthetic_mixed_network

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
    """(B, ni) of the level-1 blocks the main path factors, and the
    nested path's level-2 systems: (SB, ni2) and the number of real
    inner-junction parameters of each super-block."""
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
            (npart.SB, npart.ni2, npart.i2mask.sum(axis=1).astype(int)))


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


def _peak_rss_gb() -> float:
    """Peak resident memory of this process so far (GB)."""
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6


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
         f"so far {_peak_rss_gb():.2f} GB")
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
# sigma zero of the JAX package's CLI on the same 40 x 40 files (CPU)
CLI_SIGMA0_40 = "0.998"
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
    with every number within tol.  Returns the largest difference."""
    la, lb = Path(a).read_text().splitlines(), Path(b).read_text().splitlines()
    _check(len(la) == len(lb), f"{a} and {b} differ in length")
    worst = 0.0
    for x, y in zip(la, lb):
        if x == y:
            continue
        nx, ny = _NUM.findall(x), _NUM.findall(y)
        _check(len(nx) == len(ny) and _NUM.sub("#", x) == _NUM.sub("#", y),
               f"{a} vs {b}: {x!r} / {y!r}")
        worst = max([worst] + [abs(float(p) - float(q))
                               for p, q in zip(nx, ny)])
    _check(worst <= tol, f"{a} vs {b}: numbers differ by {worst} > {tol}")
    return worst


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
               if ln.startswith(("+ Converged", "+ Failed", "  Chi"))]
    return res, secs, steps, launches, shapes, summary


def phase_cli(work, flat_iterations):
    """The port's CLI at 1,600 and 10,000 stations (phase 8)."""
    out = {"launches": {}, "seconds": {}, "shapes": {}}
    d = Path(work) / "n40"
    d.mkdir()
    net, _ = synthetic_mixed_network(40, 40, block_rows=34, block_cols=34,
                                     seed=0)
    write_dna_stn(str(d / "n40.stn"), net)
    write_dna_msr(str(d / "n40.msr"), net)
    files = [str(d / "n40.stn"), str(d / "n40.msr")]
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

    # 10,000 stations through the CLI's own segmentation
    d = Path(work) / "n10k"
    d.mkdir()
    net, _ = synthetic_mixed_network(100, 100, block_rows=34, block_cols=34,
                                     seed=0)
    write_dna_stn(str(d / "n10k.stn"), net)
    write_dna_msr(str(d / "n10k.msr"), net)
    t_imp, imp_out = _verb(d, "import", "-n", "n10k", str(d / "n10k.stn"),
                           str(d / "n10k.msr"))
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    t = time.perf_counter()
    _say(card_line())
    secs, reports = kernels.timed_build()
    for name, rep in reports.items():
        _say(f"--- nvcc {name}.cu ---\n{rep.strip()}")
    _say(f"phase build: {secs:.2f} s")

    rows = cols = 100
    tile = 34
    super_blocks = 4
    block_super = _grid_grouping(rows, cols, tile, super_blocks)
    (B, ni), (SB, ni2, n_real) = _main_path_shapes(rows, cols, tile,
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

    # the host routes: staged nested factors, host assembly, and the
    # national network past the device-solve budget
    host_launches, host_shapes = {}, {}
    host_phases = [
        ("staged", lambda: phase_staged(rows, cols, tile, super_blocks,
                                        block_super, nested_res)),
        ("host assembly", lambda: phase_host_assembly(rows, cols, tile,
                                                      flat)),
        ("national", lambda: phase_national(200, 200, tile))]
    for name, run in host_phases:
        t = time.perf_counter()
        la, sh = run()
        host_launches.update(la)
        host_shapes.update(sh)
        torch.cuda.empty_cache()
        _say(f"phase {name}: {time.perf_counter() - t:.2f} s")

    t = time.perf_counter()
    os.environ["DTA_PROFILE"] = "1"
    with tempfile.TemporaryDirectory() as work:
        clirun = phase_cli(work, flat.iterations)
    del os.environ["DTA_PROFILE"]
    _say(f"phase cli: {time.perf_counter() - t:.2f} s; verbs (s): "
         + json.dumps(clirun["seconds"]))

    # the kernel against its plain version at every shape the CLI routes
    # launched it at
    t = time.perf_counter()
    cli_paths = {}
    for path, shps in clirun["shapes"].items():
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
                             **host_launches, **clirun["launches"]},
        **kern, "level2": {"shape": [int(SB), int(ni2)], **kern2},
        "dense": {"shape": [int(Bd), int(nd)], **kern_cli[(Bd, nd)]},
        "cli": [{"shape": [int(b), int(n)], "paths": cli_paths[(b, n)],
                 **kern_cli[(b, n)]} for b, n in sorted(kern_cli)],
        "host_routes": [{"shape": [int(b), int(n)],
                         "paths": host_paths[(b, n)], **kern_host[(b, n)]}
                        for b, n in sorted(kern_host)]}]}))
    _say(card_line())
    _say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
