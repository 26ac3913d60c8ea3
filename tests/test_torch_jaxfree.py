"""dynadjust_tpu_torch and chip_smoke.py run where JAX is not installed.

The machine with the GPU has PyTorch but no JAX, and importing any module
of the JAX package (even a numpy-only one) imports jax through
dynadjust_tpu/__init__.py.  A subprocess with an import hook that refuses
jax, jaxlib and dynadjust_tpu imports every module of the port and
chip_smoke (the host modules of binary, dbid and JSONL files, simulation,
plots, the host kernel library, the GNSS-only blocked adjustment, the
multi-process layer with its dryrun and the national-scale tools by
name), runs the host kernel
library, a small adjustment, and a small
GNSS network through the host-assembled and the device-resident
Gauss-Newton loops on the CPU, and checks that none of the three names
was loaded; another runs `python -m dynadjust_tpu_torch` import,
reftran, geoid, segment, adjust --phased --tpu --device cpu (also with
--devices 2: this process and one spawned gloo rank), the dynadjust
pipeline verb, import --simulate --export-bst-bms, an import of
the binary pair, adjust --block1-phased --tpu --device cpu and metadata
of a .bms file under the same hook; a static check reads every import
statement.
"""

import ast
import os
import subprocess
import sys
import textwrap
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "dynadjust_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "dynadjust_tpu")

_CHILD = textwrap.dedent("""
    import importlib, pkgutil, sys
    FORBIDDEN = {"jax", "jaxlib", "dynadjust_tpu"}

    class Refuse:
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in FORBIDDEN:
                raise ImportError(f"refused import of {name}")
            return None

    sys.meta_path.insert(0, Refuse())
    import dynadjust_tpu_torch
    mods = [m.name for m in pkgutil.walk_packages(
        dynadjust_tpu_torch.__path__, "dynadjust_tpu_torch.")]
    for m in mods:
        importlib.import_module(m)
    for m in ("io_formats.binary", "io_formats.dbid", "io_formats.jsonl",
              "network.simulate", "output.plot", "ops.native",
              "parallel.blocked_adjust", "parallel.assembly",
              "parallel.device_adjust", "parallel.multihost",
              "tools.multihost_dryrun", "tools.national_mixed",
              "tools.national_streamed"):
        assert "dynadjust_tpu_torch." + m in mods, m
    import numpy as np
    from dynadjust_tpu_torch.ops import native
    B, n = 3, 4
    y = native.block_matvec(*(np.ones(s) for s in (
        (B, n, n), (B, n, 2), (B, 2, 2), (B, n), (B, 2))))
    assert (y[0] == n + 2).all() and (y[1] == n + 2).all()
    import chip_smoke
    import torch
    torch.set_num_threads(2)
    from dynadjust_tpu_torch.adjust import AdjustmentOptions
    from dynadjust_tpu_torch.adjust.tpu_blocked import adjust_tpu_blocked
    from dynadjust_tpu_torch.utils.synthetic_mixed import (
        synthetic_mixed_network)
    net, seg = synthetic_mixed_network(12, 12, block_rows=6, block_cols=6)
    res = adjust_tpu_blocked(net, AdjustmentOptions(), seg=seg,
                             device="cpu")
    assert res.status == "Converged", res.status
    from dynadjust_tpu_torch.parallel.blocked_adjust import (
        BlockedNetwork, adjust_blocked)
    from dynadjust_tpu_torch.parallel.device_adjust import (
        adjust_blocked_device)
    from dynadjust_tpu_torch.utils.synthetic import (
        grid_segmentation, synthetic_grid_network)
    xyz, pairs, obs, var, x0, fixed = synthetic_grid_network(8, 8)
    blocks, junction = grid_segmentation(8, 8, 4, 4)
    bn = BlockedNetwork(nstations=64, pairs=pairs, obs=obs,
                        weight=1.0 / var, blocks=blocks,
                        junction_stations=junction, constrained=fixed)
    xd, itd, mcd, _ = adjust_blocked_device(bn, x0, device="cpu")
    xh, ith, _, _ = adjust_blocked(bn, x0, device="cpu")
    assert itd == ith and mcd <= 5e-4 and abs(xd - xh).max() < 1e-8
    loaded = sorted(n for n in sys.modules
                    if n.split(".")[0] in FORBIDDEN)
    assert not loaded, loaded
    print("MODULES", len(mods))
""")


def test_port_and_chip_smoke_run_without_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    r = subprocess.run([sys.executable, "-c", _CHILD], cwd=str(ROOT),
                       env=env, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stdout + r.stderr
    n = int(r.stdout.split("MODULES")[-1])
    assert n >= 25                      # every module was imported


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_no_jax_import_statements():
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 25
    assert PKG / "cli.py" in files and PKG / "__main__.py" in files
    bad = [(str(f.relative_to(ROOT)), name) for f in files
           for name in _imports(f)
           if name.split(".")[0] in FORBIDDEN]
    assert not bad, bad


_CLI_CHILD = textwrap.dedent("""
    import runpy, sys
    FORBIDDEN = {"jax", "jaxlib", "dynadjust_tpu"}

    class Refuse:
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in FORBIDDEN:
                raise ImportError(f"refused import of {name}")
            return None

    sys.meta_path.insert(0, Refuse())
    import torch
    torch.set_num_threads(2)
    from dynadjust_tpu_torch.io_formats.dna_writer import (
        write_dna_msr, write_dna_stn)
    from dynadjust_tpu_torch.utils.synthetic_mixed import (
        synthetic_mixed_network)
    from dynadjust_tpu_torch.geoid.gridtools import write_gsb
    from dynadjust_tpu_torch.utils.synthetic_geoid import (
        orthometric_levelling, synthetic_geoid_grid)
    net, _ = synthetic_mixed_network(6, 6, block_rows=3, block_cols=3)
    grid = synthetic_geoid_grid(-37.5, -36.5, 142.5, 143.5)
    write_gsb(grid, "g.gsb")
    orthometric_levelling(net, grid)
    write_dna_stn("n.stn", net, ellipsoidal=True)
    write_dna_msr("n.msr", net)
    frame = ["-r", "ITRF2014", "-e", "01.01.2024"]
    seg = ["--min-inner-stns", "10", "--max-block-stns", "20"]
    for verb in (["import", "-n", "n", "n.stn", "n.msr"],
                 ["reftran", "n", *frame],
                 ["geoid", "n", "-g", "g.gsb", "--convert-stn-hts"],
                 ["segment", "n", *seg],
                 ["adjust", "n", "--phased", "--tpu", "--device", "cpu"],
                 ["adjust", "n", "--phased", "--tpu", "--device", "cpu",
                  "--devices", "2"],
                 ["import", "-n", "s", "n.stn", "n.msr", "--simulate"],
                 ["import", "-n", "b", "n.stn", "n.msr", "--export-bst-bms"],
                 ["import", "-n", "b", "b.bst", "b.bms"],
                 ["segment", "b", *seg],
                 ["adjust", "b", "--block1-phased", "--tpu", "--device",
                  "cpu"],
                 ["metadata", "b.bms"],
                 ["dynadjust", "-n", "p", "n.stn", "n.msr", *frame, "-g",
                  "g.gsb", "--convert-stn-hts", "--phased", "--tpu",
                  "--device", "cpu", *seg, "--output-json",
                  "--export-snx", "--export-xml"]):
        sys.argv = ["dynadjust_tpu_torch", *verb]
        try:
            runpy.run_module("dynadjust_tpu_torch", run_name="__main__",
                             alter_sys=True)
        except SystemExit as e:
            assert e.code == 0, (verb, e.code)
    loaded = sorted(n for n in sys.modules
                    if n.split(".")[0] in FORBIDDEN)
    assert not loaded, loaded
""")


def test_cli_runs_without_jax(tmp_path):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    r = subprocess.run([sys.executable, "-c", _CLI_CHILD], cwd=str(tmp_path),
                       env=env, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "*** PASSED ***" in r.stdout or "*** WARNING ***" in r.stdout \
        or "*** FAILED ***" in r.stdout, r.stdout
    for ext in ("net.pkl", "seg", "sap", "phased.adj", "xyz", "results.pkl"):
        assert (tmp_path / f"n.{ext}").exists(), ext
        assert (tmp_path / f"p.{ext}").exists(), ext
    for ext in ("adj.jsonl", "snx", "adjusted.stn.xml"):
        assert (tmp_path / f"p.{ext}").exists(), ext
    assert (tmp_path / "dynadjust.log").read_text().count(" done ") == 5
    assert (tmp_path / "s.simulated.msr").exists()
    for ext in ("bst", "bms", "dbid", "phased-block1.adj"):
        assert (tmp_path / f"b.{ext}").exists(), ext
