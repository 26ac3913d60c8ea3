"""A/B timing of Cholesky-inverse kernel sources on one CUDA card.

    python -m dynadjust_tpu_torch.tools.chol_inv_ab [--B 9 --n 3468] \\
        old/chol_inv.cu dynadjust_tpu_torch/csrc/chol_inv.cu

Each source (a csrc/chol_inv.cu of this or an earlier commit: the same C
entry points ``dta_chol_inv`` and ``dta_chol_inv_tile``) is built with
the package's nvcc flags into ``_build/ab/``.  On SPD inputs made from a
seed (the shape chip_smoke.py uses for the main path) every source is
held against the plain PyTorch version (max|dLinv| / max|Linv| and the
float64 residual max|Linv N Linvᵀ − I|), then timed with CUDA events in
turns, first to last and back (A B B A), the kernel call alone after
one untimed call: its scratch copy is refreshed outside the timed
window.  Last, one call of
each under torch.profiler gives the time and grid launches of each
device function.  Prints the card line first; compare sources only
within one run.
"""

from __future__ import annotations

import argparse
import ctypes
import re
import subprocess
from pathlib import Path

import torch

from ..ops import kernels
from ..ops.chol_inv import _pad_identity, cholesky_inverse_plain


def _build(sources):
    out = kernels.BUILD / "ab"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, src in enumerate(sources):
        name = f"{i}_{src.parent.name}_{src.stem}"
        lib = out / f"lib{name}.so"
        procs[name] = (lib, subprocess.Popen(
            [kernels._nvcc(), *kernels.NVCC_FLAGS, "-o", str(lib), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, p) in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(f"nvcc {name} failed:\n{log}")
        spills = re.findall(r"(\d+) bytes spill stores", log)
        print(f"{name}: built, spill stores {spills}", flush=True)
        L = ctypes.CDLL(str(lib))
        L.dta_chol_inv.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 \
            + [ctypes.c_void_p]
        L.dta_chol_inv.restype = ctypes.c_int
        L.dta_chol_inv_tile.restype = ctypes.c_int
        libs[name] = L
    return libs


class _Case:
    """Padded input, scratch and outputs of one source at one shape."""

    def __init__(self, L, N):
        self.L, self.B, self.n0 = L, N.shape[0], N.shape[1]
        self.src = _pad_identity(N, L.dta_chol_inv_tile())
        self.A = torch.empty_like(self.src)
        self.Linv = torch.empty_like(self.src)
        self.status = torch.empty(self.B, dtype=torch.int32,
                                  device=N.device)

    def refresh(self):
        self.A.copy_(self.src)
        self.Linv.zero_()
        self.status.zero_()

    def launch(self):
        err = self.L.dta_chol_inv(
            self.A.data_ptr(), self.Linv.data_ptr(), self.status.data_ptr(),
            self.B, self.A.shape[1], torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"launch failed: CUDA error {err}")

    def result(self):
        return self.Linv[:, :self.n0, :self.n0], self.status


def _time_ms(case, reps):
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    case.refresh()
    case.launch()                     # warm-up, untimed
    total = 0.0
    for _ in range(reps):
        case.refresh()
        e0.record()
        case.launch()
        e1.record()
        torch.cuda.synchronize()
        total += e0.elapsed_time(e1)
    return total / reps


def _split(case):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    case.refresh()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        case.launch()
        torch.cuda.synchronize()
    out = {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        k = re.sub(r"\(.*", "", e.name.replace("(anonymous namespace)::", ""))
        d = out.setdefault(k, [0.0, 0])
        d[0] += e.time_range.elapsed_us() / 1e3
        d[1] += 1
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("sources", nargs="+", type=Path)
    ap.add_argument("--B", type=int, default=9)
    ap.add_argument("--n", type=int, default=3468)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("chol_inv_ab: no CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    libs = _build(args.sources)
    B, n = args.B, args.n
    g = torch.Generator(device="cuda").manual_seed(0)
    G = torch.randn(B, 2 * n, n, device="cuda", generator=g,
                    dtype=torch.float64)
    eye = torch.eye(n, device="cuda", dtype=torch.float64)
    N64 = G.transpose(1, 2) @ G / (2 * n) + 0.5 * eye
    del G
    N = N64.to(torch.float32)

    def residual(L):
        L = L.double()
        return float((L @ N64 @ L.transpose(1, 2) - eye).abs().max())

    Lp, _ = cholesky_inverse_plain(N)
    print(f"plain: residual {residual(Lp):.4e}", flush=True)
    cases = {name: _Case(L, N) for name, L in libs.items()}
    for name, case in cases.items():
        case.refresh()
        case.launch()
        Lk, st = case.result()
        torch.cuda.synchronize()
        rel = float((Lk - Lp).abs().max() / Lp.abs().max())
        print(f"{name}: rel {rel:.4e} residual {residual(Lk):.4e} "
              f"status {st.tolist()}", flush=True)
    names = list(cases)
    for name in names + names[::-1]:
        print(f"{name}: {_time_ms(cases[name], args.reps):.3f} ms",
              flush=True)
    for name in names:
        sp = _split(cases[name])
        print(f"{name}: " + "  ".join(
            f"{k}: {v[0]:.3f} ms / {v[1]}" for k, v in sp.items()),
            flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
