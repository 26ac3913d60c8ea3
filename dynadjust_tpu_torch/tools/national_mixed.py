"""National-scale mixed-measurement adjustment, end to end.

    python -m dynadjust_tpu_torch.tools.national_mixed [ROWS COLS BLOCK SUPER]
        [--staged] [--out DIR] [--device cpu]

A synthetic mixed network (G baselines, S slope distances, A angles, V
zeniths, L level differences, R heights; utils/synthetic_mixed.py) of
ROWS x COLS stations in BLOCK x BLOCK tiles goes through the production
path of adjust_tpu_blocked: per-iteration re-linearisation, constraint
elimination, the batched float32 Schur factors (the nested three-level
path when SUPER > 0, its super-blocks a 2-D grid of about sqrt(SUPER) x
sqrt(SUPER) super-tiles; two-level when SUPER is 0), the float64
covariance stage, and the writers (.adj, .xyz, .apu under --out).
--staged keeps the level-1 factor pools in host RAM and streams them
through the device.  The defaults, 320 320 16 16, are the 102,400-station
configuration whose JAX-package result is committed; national_102400_ref.npz
beside this file holds that result per station (see build_reference).

Prints one JSON record (also written to DIR/national_<S>stn.json):
status, iterations, sigma zero, the error against the generator's truth,
the formal SD, the refinement and solve evidence, the phase profile, the
iteration and writer times, the solve route with its float64 design pool
bytes, the device memory peak and the host RSS peak.  Runs on the card
unless --device cpu; without a card and without --device cpu it exits 1.

Port of the JAX package's scripts/national_mixed_demo.py.
"""

from __future__ import annotations

import argparse
import contextlib
import hashlib
import json
import os
import resource
import sys
import time
from pathlib import Path

import numpy as np
import torch

REFERENCE = Path(__file__).with_name("national_102400_ref.npz")
# the configuration of the committed result
REF_CONFIG = (320, 320, 16, 16)


def log(msg):
    print(f"[{time.strftime('%H:%M:%S')}] {msg}", file=sys.stderr,
          flush=True)


def check_device(device) -> torch.device:
    """torch.device(device); a CUDA device must be present."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA card is present (pass device='cpu' / "
                           "--device cpu to run on the CPU)")
    return device


def peak_rss_gb() -> float:
    """Peak resident memory of this process so far (GB)."""
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6


def block_grouping(rows, cols, block, super_blocks):
    """The 2-D super grouping: square super-tiles of g x g tiles with
    g = round(sqrt(super_blocks)) keep the super-junction frontier
    O(sqrt(S)), where contiguous 1-D bands would make it O(S / band).
    None when super_blocks is 0 (the two-level path)."""
    if super_blocks <= 0:
        return None
    from ..utils.synthetic import grid_super_assignment
    g = max(1, int(round(super_blocks ** 0.5)))
    tr = (rows + block - 1) // block
    tc = (cols + block - 1) // block
    return grid_super_assignment(rows, cols, block, block,
                                 (tr + g - 1) // g, (tc + g - 1) // g)


def build(rows, cols, block, super_blocks):
    """(net, seg, truth, block_super) of the configuration."""
    from ..utils.synthetic_mixed import synthetic_mixed_network
    net, seg, truth = synthetic_mixed_network(rows, cols, block_rows=block,
                                              block_cols=block,
                                              return_truth=True)
    return net, seg, truth, block_grouping(rows, cols, block, super_blocks)


def station_sd_enu(res) -> np.ndarray:
    """(S, 3) SD(e), SD(n), SD(up) of every station, as the .xyz writer
    computes them (output/adj_writer.py::station_lines)."""
    from ..geodesy.local_frame import rotation_cart_to_local
    R = rotation_cart_to_local(res.lat, res.lon)
    V = np.einsum("sij,sjk,slk->sil", R, res.cov_stn, R)
    return np.sqrt(np.maximum(np.einsum("sii->si", V), 0.0))


def truth_fields(xyz, cov_stn, truth) -> dict:
    """The JAX script's plausibility fields: the 3-D error against the
    generating truth and the formal 3-D SD, in mm."""
    err = np.linalg.norm(xyz - truth, axis=1)
    sd = np.sqrt(np.maximum(
        cov_stn[:, 0, 0] + cov_stn[:, 1, 1] + cov_stn[:, 2, 2], 0.0))
    return {"err_vs_truth_mm": {
                "median": round(float(np.median(err)) * 1e3, 3),
                "p99": round(float(np.percentile(err, 99)) * 1e3, 3),
                "max": round(float(err.max()) * 1e3, 3)},
            "formal_sd_mm_median": round(float(np.median(sd)) * 1e3, 3),
            "formal_sd_finite": bool(np.isfinite(sd).all())}


def _rounded_profile(profile):
    if not profile:
        return None
    out = {}
    for k, v in profile.items():
        if isinstance(v, dict):
            out[k] = {kk: (round(vv, 2) if isinstance(vv, float) else vv)
                      for kk, vv in v.items()}
        else:
            out[k] = round(v, 2)
    return out


@contextlib.contextmanager
def _profiling():
    """DTA_PROFILE set for the adjustment (the record reads its phase
    profile and route), as it was afterwards."""
    had = os.environ.get("DTA_PROFILE")
    os.environ.setdefault("DTA_PROFILE", "1")
    try:
        yield
    finally:
        if had is None:
            del os.environ["DTA_PROFILE"]


def names_digest(names) -> str:
    """sha1 of the station names in order, one per line."""
    return hashlib.sha1("\n".join(names).encode()).hexdigest()


def run(rows=320, cols=320, block=16, super_blocks=16, staged=False,
        out=None, device="cuda", cmdline=""):
    """Generate, adjust and (with `out`) write the network; returns
    (result, record).  The result also carries the generator's truth
    (`res.truth`) and the adjusted network (`res.net`)."""
    from ..adjust import AdjustmentOptions
    from ..adjust.tpu_blocked import adjust_tpu_blocked
    device = check_device(device)
    t0 = time.time()
    net, seg, truth, block_super = build(rows, cols, block, super_blocks)
    S = net.nstations
    t_generate = time.time() - t0
    log(f"generated {S} stations, {len(net.measurements)} records, "
        f"{seg.block_count} blocks in {t_generate:.1f}s")
    if block_super is not None:
        log(f"super grouping: {len(np.unique(block_super))} super-blocks")

    opts = AdjustmentOptions()
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.time()
    with _profiling():
        res = adjust_tpu_blocked(net, opts, seg=seg,
                                 super_blocks=super_blocks, staged=staged,
                                 block_super=block_super, device=device)
    t_adjust = time.time() - t0
    dev_peak = (torch.cuda.max_memory_allocated(device) / 1e9
                if device.type == "cuda" else None)
    log(f"adjust: {res.status} in {res.iterations} iterations, "
        f"sigma0 {res.sigma_zero:.4f} [{res.pass_fail}], "
        f"max_corr {res.max_corr:.2e} m, total {t_adjust:.1f}s")
    for it in res.iteration_log:
        log(f"  iter {it['iteration']}: max_corr {it['max_corr']:+.4f} m "
            f"at {it['station']} (block {it['block']}) "
            f"[{it['elapsed']:.1f}s]")

    t_write = None
    if out is not None:
        from ..output import write_adj, write_xyz
        from ..output.uncertainty import write_apu
        os.makedirs(out, exist_ok=True)
        base = os.path.join(out, f"national_{S}stn")
        t_write = {}
        for ext, write in ((".adj", lambda p: write_adj(
                               p, net, res, opts, cmdline=cmdline)),
                           (".xyz", lambda p: write_xyz(p, net, res)),
                           (".apu", lambda p: write_apu(p, net, res))):
            t = time.time()
            write(base + ext)
            t_write[ext[1:]] = round(time.time() - t, 2)
        log(f"outputs written to {base}.adj/.xyz/.apu: {t_write} s")

    route = (res.profile or {}).get("route") or {}
    rec = {
        "stations": S, "records": len(net.measurements),
        "blocks": seg.block_count, "super_blocks": super_blocks,
        "staged": bool(staged),
        "status": res.status, "iterations": res.iterations,
        "sigma0": round(float(res.sigma_zero), 4),
        "pass_fail": res.pass_fail,
        "max_corr_m": float(res.max_corr),
        "t_generate_s": round(t_generate, 1),
        "t_adjust_s": round(t_adjust, 1),
        "phase_profile_s": _rounded_profile(
            {k: v for k, v in (res.profile or {}).items()
             if k != "route"}),
        "stats_share_of_adjust": (round(res.profile["stats"] / t_adjust, 3)
                                  if res.profile else None),
        "iter_s": [round(it["elapsed"], 2) for it in res.iteration_log],
        "t_write_s": t_write,
        **truth_fields(res.xyz, res.cov_stn, truth),
        "refine_evidence": res.refine_evidence,
        "solve_evidence": [
            {k: it[k] for k in ("solve_rel", "solve_rounds") if k in it}
            for it in res.iteration_log],
        "route": {"solve": route.get("solve"),
                  "assembly": route.get("assembly"),
                  "pool_bytes": route.get("pool_bytes"),
                  "budget_bytes": float(os.environ.get(
                      "DTA_DEVICE_SOLVE_BYTES", 8e9))},
        "peak_device_gb": dev_peak,
        "peak_host_rss_gb": round(peak_rss_gb(), 2),
        "device": (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else "cpu"),
    }
    if out is not None:
        with open(os.path.join(out, f"national_{S}stn.json"), "w") as f:
            json.dump(rec, f, indent=1)
    res.truth = truth
    res.net = net
    return res, rec


# ---- the committed JAX-package result as a per-station reference ---------

def read_xyz(path):
    """(names, xyz (S, 3), sd_enu (S, 3)) of an .xyz file."""
    names, vals = [], []
    with open(path) as f:
        lines = iter(f)
        for line in lines:
            if line.startswith("-----"):
                break
        for line in lines:
            p = line.split()
            if len(p) < 12:
                break
            names.append(p[0])
            vals.append([float(v) for v in p[6:12]])
    v = np.asarray(vals, dtype=np.float64)
    return names, v[:, :3], v[:, 3:]


def build_reference(xyz_path, rows=REF_CONFIG[0], cols=REF_CONFIG[1],
                    block=REF_CONFIG[2]) -> dict:
    """The per-station reference from a committed .xyz result: its
    adjusted XYZ less the generator's truth and its SD(e, n, up), float32
    in the generator's station order, with the digest of the station
    names.  The file's stations must be the generator's, in its order."""
    from ..utils.synthetic_mixed import synthetic_mixed_network
    names, xyz, sd = read_xyz(xyz_path)
    net, _, truth = synthetic_mixed_network(rows, cols, block_rows=block,
                                            block_cols=block,
                                            return_truth=True)
    if names != list(net.names):
        raise ValueError(f"{xyz_path}: the stations are not the "
                         f"generator's, in its order")
    return {"dxyz": (xyz - truth).astype(np.float32),
            "sd_enu": sd.astype(np.float32),
            "names_sha1": np.asarray(names_digest(names))}


def load_reference(path=REFERENCE) -> dict:
    with np.load(path, allow_pickle=False) as z:
        return {k: z[k] for k in z.files}


def compare(xyz, sd_enu, truth, names, ref, tol=1e-4) -> dict:
    """Every station's adjusted X, Y, Z and SD(e, n, up) against the
    reference (truth + dxyz, sd_enu; both printed to 1e-4 m): the largest
    differences, the five worst stations, how many stations differ by
    more than the print rounding can explain (half the printed 1e-4 m),
    the stations past `tol` m (at most 20 named, worst first) and
    whether there are none."""
    dx = np.abs(xyz - (truth + ref["dxyz"].astype(np.float64))).max(axis=1)
    ds = np.abs(sd_enu - ref["sd_enu"].astype(np.float64)).max(axis=1)
    worst = np.maximum(dx, ds)
    order = np.argsort(-worst, kind="stable")
    bad = order[:int((worst > tol).sum())]
    same_names = names_digest(names) == str(ref["names_sha1"])

    def named(idx):
        return [{"station": names[i], "dxyz_m": float(dx[i]),
                 "dsd_m": float(ds[i])} for i in idx]

    return {"stations": int(len(xyz)), "max_dxyz_m": float(dx.max()),
            "max_dsd_m": float(ds.max()), "tol_m": tol,
            "names_match": same_names, "worst": named(order[:5]),
            "n_past_rounding": {"xyz": int((dx > 5e-5).sum()),
                                "sd": int((ds > 5e-5).sum())},
            "n_bad": int(len(bad)), "bad": named(bad[:20]),
            "ok": bool(same_names and len(bad) == 0)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("size", nargs="*", type=int,
                    help="ROWS COLS BLOCK SUPER (default 320 320 16 16)")
    ap.add_argument("--staged", action="store_true",
                    help="stage the level-1 factor pools in host RAM")
    ap.add_argument("--out", default="national_mixed",
                    help="folder of the .adj/.xyz/.apu and the JSON record")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    if len(args.size) > 4:
        ap.error("at most ROWS COLS BLOCK SUPER")
    rows, cols, block, sup = (args.size + list(REF_CONFIG)[len(args.size):])
    try:
        check_device(args.device)
    except RuntimeError as e:
        print(f"national_mixed: {e}", file=sys.stderr)
        return 1
    _, rec = run(rows, cols, block, sup, staged=args.staged, out=args.out,
                 device=args.device, cmdline=" ".join(sys.argv))
    print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
