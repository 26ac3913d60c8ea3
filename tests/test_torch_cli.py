"""The port's CLI against the JAX package's, on the same DNA files.

A 10 x 10 synthetic mixed network (seeded) is written as DNA .stn/.msr
files; both CLIs run in-process, each in its own folder, through
import -> segment -> adjust on the CPU (the port with --device cpu):

  * the host routes (adjust; the host sequential phased adjustment:
    --phased, --block1-phased, --staged-adjustment without --tpu): .adj
    and .xyz byte-identical below the header (the line "Number of
    unknown parameters");
  * the device routes (adjust --tpu, --phased --tpu, --phased --tpu
    --tpu-super-blocks 2, and --phased --tpu --staged-adjustment with
    and without super-blocks): printed numbers within 1e-4
    (dynadjust_tpu.diff.compare_files) and the adjusted xyz of the saved
    results within 1e-7 m;
  * .seg and .sap identical below their headers;
  * the stage files: refused when missing without --create-stage-files,
    written under --stage-path, removed by --purge-stage-files.
"""

import os
import pickle
import shutil

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from dynadjust_tpu.cli import main as jax_main
from dynadjust_tpu.diff import compare_files
from dynadjust_tpu.io_formats.dna_writer import write_dna_msr, write_dna_stn
from dynadjust_tpu.utils.synthetic_mixed import synthetic_mixed_network
from dynadjust_tpu_torch.cli import main as torch_main

MARKER = "Number of unknown parameters"
SEGMENT = ["--min-inner-stns", "30", "--max-block-stns", "60"]
STAGE = ["--staged-adjustment", "--create-stage-files"]
ROUTES = {
    "host": [],
    "dense-tpu": ["--tpu"],
    "phased-tpu": ["--phased", "--tpu"],
    "phased-tpu-sb2": ["--phased", "--tpu", "--tpu-super-blocks", "2"],
    "host-phased": ["--phased"],
    "host-block1": ["--block1-phased"],
    "host-staged": [*STAGE, "--purge-stage-files"],
    "staged-tpu": ["--phased", "--tpu", *STAGE],
    "staged-tpu-sb2": ["--phased", "--tpu", *STAGE,
                       "--tpu-super-blocks", "2"],
}
# the .adj each route writes (the JAX CLI's names: --staged-adjustment
# alone keeps the simultaneous file name)
ADJ = {"host": "simult", "dense-tpu": "simult", "host-staged": "simult",
       "host-block1": "phased-block1"}


@pytest.fixture(scope="module")
def dna_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("dna")
    net, _ = synthetic_mixed_network(10, 10, block_rows=5, block_cols=5,
                                     seed=0)
    write_dna_stn(str(d / "n.stn"), net)
    write_dna_msr(str(d / "n.msr"), net)
    return d


def _pipeline(main, folder, dna, adjust_args):
    """import -> segment -> adjust in `folder`; returns the results."""
    os.makedirs(folder, exist_ok=True)
    common = ["--output-folder", str(folder)]
    assert main(["import", "-n", "n", str(dna / "n.stn"),
                 str(dna / "n.msr"), *common]) == 0
    assert main(["segment", "n", *SEGMENT, *common]) == 0
    assert main(["adjust", "n", *adjust_args, *common]) == 0
    with open(folder / "n.results.pkl", "rb") as f:
        return pickle.load(f)


def _below(path, marker):
    lines = open(path).read().splitlines()
    i = next(k for k, ln in enumerate(lines) if marker in ln)
    return lines[i:]


@pytest.fixture(scope="module")
def runs(dna_files, tmp_path_factory):
    """run(route) -> (folder, JAX result, port result): both CLIs on one
    route, run once per module on first use."""
    cache = {}

    def run(route):
        if route not in cache:
            base = tmp_path_factory.mktemp(route)
            rj = _pipeline(jax_main, base / "jax", dna_files, ROUTES[route])
            rt = _pipeline(torch_main, base / "torch", dna_files,
                           [*ROUTES[route], "--device", "cpu"])
            cache[route] = (base, rj, rt)
        return cache[route]
    return run


@pytest.mark.parametrize("route", list(ROUTES))
def test_adjustment_agrees(runs, route):
    base, rj, rt = runs(route)
    assert rt.status == rj.status
    if route == "host-block1":
        assert rt.status.startswith("Estimates solved for Block 1 only")
    else:
        assert rt.status == "Converged"
    assert rt.iterations == rj.iterations
    assert rt.pass_fail == rj.pass_fail
    assert abs(rt.sigma_zero - rj.sigma_zero) < 1e-9
    assert np.abs(rt.xyz - rj.xyz).max() < 1e-7
    adj = f"n.{ADJ.get(route, 'phased')}.adj"
    if route.startswith("host"):
        for name in (adj, "n.xyz"):
            mark = MARKER if name == adj else "Adjusted Coordinates"
            assert (_below(base / "torch" / name, mark)
                    == _below(base / "jax" / name, mark)), name
    else:
        ok, diffs = compare_files(str(base / "torch" / adj),
                                  str(base / "jax" / adj), 1e-4,
                                  skip_to_marker=MARKER)
        assert ok, diffs[:5]
        ok, diffs = compare_files(str(base / "torch" / "n.xyz"),
                                  str(base / "jax" / "n.xyz"), 1e-4)
        assert ok, diffs[:5]


@pytest.mark.parametrize("route", list(ROUTES))
def test_segmentation_files_identical(runs, route):
    base = runs(route)[0]
    assert (_below(base / "torch" / "n.seg", "SEGMENTATION SUMMARY")
            == _below(base / "jax" / "n.seg", "SEGMENTATION SUMMARY"))
    assert ((base / "torch" / "n.sap").read_text()
            == (base / "jax" / "n.sap").read_text())


def test_saved_network_is_adjusted(runs, tmp_path):
    """adjust saves the adjusted network back: a second adjust starts
    from the adjusted coordinates and converges at once."""
    base = tmp_path / "again"
    shutil.copytree(runs("host")[0] / "torch", base)
    assert torch_main(["adjust", "n", "--device", "cpu",
                       "--output-folder", str(base)]) == 0
    with open(base / "n.results.pkl", "rb") as f:
        res = pickle.load(f)
    assert res.iterations == 1


def test_report_mode_rewrites_from_saved_results(runs, tmp_path):
    base = tmp_path / "report"
    shutil.copytree(runs("phased-tpu")[0] / "torch", base)
    adj = base / "n.phased.adj"
    before = _below(adj, MARKER)
    adj.unlink()
    assert torch_main(["adjust", "n", "--phased", "--tpu", "--report-mode",
                       "--output-folder", str(base)]) == 0
    assert _below(adj, MARKER) == before


def test_purge_stage_files(runs):
    """The staged host route wrote its stage files and
    --purge-stage-files removed <name>.mtx, in both CLIs."""
    base = runs("host-staged")[0]
    for side in ("jax", "torch"):
        assert (base / side / "n.simult.adj").exists()
        assert not (base / side / "n.mtx").exists()


def test_stage_files_lifecycle(runs, tmp_path, capsys):
    """--staged-adjustment refuses to run without stage files unless
    --create-stage-files (exit 1, as the JAX CLI); with it the .mtx files
    land under --stage-path, a later staged run reuses them, and
    --purge-stage-files removes them."""
    work, stage = tmp_path / "w", tmp_path / "stage"
    shutil.copytree(runs("host-phased")[0] / "torch", work)
    jwork = tmp_path / "jw"
    shutil.copytree(runs("host-phased")[0] / "jax", jwork)
    common = ["--stage-path", str(stage)]
    capsys.readouterr()
    assert jax_main(["adjust", "n", "--staged-adjustment", *common,
                     "--output-folder", str(jwork)]) == 1
    assert torch_main(["adjust", "n", "--staged-adjustment", *common,
                       "--output-folder", str(work)]) == 1
    assert "--create-stage-files" in capsys.readouterr().err
    assert torch_main(["adjust", "n", *STAGE, *common,
                       "--output-folder", str(work)]) == 0
    files = sorted(p.name for p in (stage / "n.mtx").iterdir())
    assert files and all(f.endswith(".mtx") for f in files)
    assert not (work / "n.mtx").exists()
    assert torch_main(["adjust", "n", "--staged-adjustment", *common,
                       "--purge-stage-files",
                       "--output-folder", str(work)]) == 0
    assert not (stage / "n.mtx").exists()


def test_staged_with_devices_is_refused(runs, tmp_path, capsys):
    """--devices with --staged-adjustment exits 1 with the JAX CLI's
    words: the host-streamed factors are single-device."""
    work = tmp_path / "w"
    shutil.copytree(runs("host-phased")[0] / "torch", work)
    capsys.readouterr()
    assert torch_main(["adjust", "n", "--phased", "--tpu", *STAGE,
                       "--devices", "2", "--device", "cpu",
                       "--output-folder", str(work)]) == 1
    err = capsys.readouterr().err
    assert "--devices cannot be combined with --staged-adjustment" in err
