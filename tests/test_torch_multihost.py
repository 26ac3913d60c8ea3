"""The port's multi-process layer (parallel/multihost.py) on the CPU.

  * the dryrun (tools/multihost_dryrun.py) at 2 hosts x 2 ranks, held to
    the bounds of the JAX package's own dryrun test
    (tests/test_multihost.py:33-47): the flat and the hierarchical
    (hosts, blocks) sharded solves against the single-device solve, and
    the mixed adjustment across the ranks against one device;
  * adjust --phased --tpu --devices 2 as two processes that join one
    group through DTA_COORDINATOR / DTA_NUM_PROCESSES / DTA_PROCESS_ID
    (a file store): rank 0 prints the single-device run's statistics,
    rank 1 prints nothing;
  * dynadjust --devices 2 joining the same way: rank 0 alone runs the
    stages before adjust;
  * the ranks (spawn_ranks, the dryrun) run on the card unless the
    caller asks for the CPU, and the dryrun's child mode needs
    --coordinator;
  * a rank that fails makes spawn_ranks raise, well inside the
    process-group timeout, with no rank left running;
  * without the DTA_* variables init_distributed stays single-process;
  * every collective of the port is an all_reduce or a broadcast (the
    two that gloo runs on CUDA tensors).
"""

import ast
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

torch.set_num_threads(2)

from dynadjust_tpu.io_formats.dna_writer import write_dna_msr, write_dna_stn
from dynadjust_tpu.utils.synthetic_mixed import synthetic_mixed_network
from dynadjust_tpu_torch.cli import main as torch_main
from dynadjust_tpu_torch.parallel import multihost as mh

import _torch_mesh_ranks as ranks_mod

ROOT = Path(__file__).resolve().parents[1]


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH", "")
    for k in ("DTA_COORDINATOR", "DTA_NUM_PROCESSES", "DTA_PROCESS_ID"):
        env.pop(k, None)
    return env


def test_multihost_dryrun(tmp_path):
    out = tmp_path / "multihost.json"
    r = subprocess.run(
        [sys.executable, "-m", "dynadjust_tpu_torch.tools.multihost_dryrun",
         "--nproc", "2", "--local-devices", "2", "--rows", "18",
         "--cols", "18", "--block", "6", "--out", str(out),
         "--timeout", "240", "--device", "cpu"],
        env=_env(), capture_output=True, text=True, timeout=300,
        cwd=tmp_path)
    assert r.returncode == 0, r.stderr[-2000:]
    res = json.loads(out.read_text())
    assert res["ok"] is True and res["ranks"] == 4
    assert res["results"]["flat"]["max_dxi"] < 1e-10
    assert res["results"]["flat"]["max_dxj"] < 1e-10
    assert res["results"]["hierarchical"]["max_dxi"] < 1e-10
    assert res["results"]["hierarchical"]["max_dxj"] < 1e-10
    assert res["results"]["hierarchical"]["mesh_shape"] == {
        "hosts": 2, "blocks": 2}
    e2e = res["results"]["end_to_end_adjustment"]
    assert e2e["iterations"] == e2e["iterations_single"]
    assert e2e["max_dxyz_m"] < 1e-8
    assert e2e["d_sigma0"] < 1e-9
    assert e2e["max_dcov"] < 1e-12


def _stats(text):
    return [ln.strip() for ln in text.splitlines()
            if "Chi squared" in ln and "Sigma zero" in ln]


def test_cli_ranks_join_through_the_environment(tmp_path):
    net, _ = synthetic_mixed_network(8, 8, block_rows=4, block_cols=4,
                                     seed=1)
    write_dna_stn(str(tmp_path / "n.stn"), net)
    write_dna_msr(str(tmp_path / "n.msr"), net)
    runs = {}
    for key in ("single", "ranks"):
        w = tmp_path / key
        w.mkdir()
        common = ["--output-folder", str(w)]
        assert torch_main(["import", "-n", "n", str(tmp_path / "n.stn"),
                           str(tmp_path / "n.msr"), *common]) == 0
        assert torch_main(["segment", "n", "--min-inner-stns", "10",
                           "--max-block-stns", "20", *common]) == 0
        runs[key] = w
    argv = [sys.executable, "-m", "dynadjust_tpu_torch", "adjust", "n",
            "--phased", "--tpu", "--device", "cpu"]
    single = subprocess.run(argv + ["--output-folder", str(runs["single"])],
                            env=_env(), capture_output=True, text=True,
                            timeout=300)
    assert single.returncode == 0, single.stderr[-2000:]
    procs = []
    for rank in range(2):
        env = _env()
        env.update(DTA_COORDINATOR=f"file://{tmp_path}/store",
                   DTA_NUM_PROCESSES="2", DTA_PROCESS_ID=str(rank),
                   DTA_DIST_TIMEOUT="120")
        procs.append(subprocess.Popen(
            argv + ["--devices", "2", "--output-folder", str(runs["ranks"])],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=300))
    finally:
        for p in procs:
            p.kill()
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-2000:]
    assert _stats(outs[0][0]) == _stats(single.stdout) != []
    assert outs[1][0] == ""


def test_dynadjust_ranks_run_early_stages_once(tmp_path):
    """dynadjust --devices 2 as two processes joining through DTA_*: rank
    0 alone runs import and segment (one set of stage lines in
    dynadjust.log), the other rank waits and joins the adjustment; rank
    0 prints the single-process run's statistics."""
    net, _ = synthetic_mixed_network(8, 8, block_rows=4, block_cols=4,
                                     seed=1)
    stn, msr = str(tmp_path / "n.stn"), str(tmp_path / "n.msr")
    write_dna_stn(stn, net)
    write_dna_msr(msr, net)
    argv = [sys.executable, "-m", "dynadjust_tpu_torch", "dynadjust",
            "-n", "n", stn, msr, "--phased", "--tpu", "--device", "cpu",
            "--min-inner-stns", "10", "--max-block-stns", "20"]
    single, ranks = tmp_path / "single", tmp_path / "ranks"
    single.mkdir()
    ranks.mkdir()
    r = subprocess.run(argv + ["--output-folder", str(single)], env=_env(),
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    procs = []
    for rank in range(2):
        env = _env()
        env.update(DTA_COORDINATOR=f"file://{tmp_path}/store",
                   DTA_NUM_PROCESSES="2", DTA_PROCESS_ID=str(rank),
                   DTA_DIST_TIMEOUT="120")
        procs.append(subprocess.Popen(
            argv + ["--devices", "2", "--output-folder", str(ranks)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=300))
    finally:
        for p in procs:
            p.kill()
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-2000:]
    assert _stats(outs[0][0]) == _stats(r.stdout) != []
    assert outs[1][0] == ""
    log = (ranks / "dynadjust.log").read_text()
    for stage in ("import", "segment", "adjust"):
        assert sum(f"{stage:<10}started" in ln
                   for ln in log.splitlines()) == 1, (stage, log)


def test_ranks_default_to_the_card(tmp_path, monkeypatch):
    """spawn_ranks and the dryrun run on the card unless the caller asks
    for the CPU: with no card they refuse instead of running there."""
    from dynadjust_tpu_torch.tools.multihost_dryrun import main as dryrun
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    assert mh.placement(2, device="cpu") == ("gloo", "cpu")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        mh.spawn_ranks(ranks_mod.failing_rank, 2,
                       f"file://{tmp_path}/store", args=(str(tmp_path),))
    assert dryrun(["--nproc", "1", "--local-devices", "2",
                   "--out", str(tmp_path / "mh.json")]) == 1
    assert not (tmp_path / "mh.json").exists()


def test_dryrun_process_id_needs_coordinator(tmp_path):
    from dynadjust_tpu_torch.tools.multihost_dryrun import main as dryrun
    with pytest.raises(SystemExit) as e:
        dryrun(["--process-id", "0", "--out", str(tmp_path / "mh.json")])
    assert e.value.code == 2


def test_failed_rank_raises_without_hanging(tmp_path, monkeypatch):
    monkeypatch.setenv("DTA_DIST_TIMEOUT", "60")
    t = time.monotonic()
    with pytest.raises(RuntimeError, match="failed|killed"):
        mh.spawn_ranks(ranks_mod.failing_rank, 2,
                       f"file://{tmp_path}/store", device="cpu",
                       args=(str(tmp_path),), timeout=90)
    assert time.monotonic() - t < 90


def test_init_distributed_without_environment(monkeypatch):
    for k in ("DTA_COORDINATOR", "DTA_NUM_PROCESSES", "DTA_PROCESS_ID"):
        monkeypatch.delenv(k, raising=False)
    assert mh.init_distributed() is False
    assert not torch.distributed.is_initialized()
    assert not mh.is_multiprocess()


ALLOWED = {"all_reduce", "broadcast", "init_process_group",
           "destroy_process_group", "new_group", "get_rank",
           "get_world_size", "get_backend", "is_initialized", "ReduceOp"}


def test_collectives_are_all_reduce_and_broadcast():
    """Every torch.distributed name the port uses (as `dist.<name>` or
    `torch.distributed.<name>`) is a collective gloo runs on CUDA tensors
    or group bookkeeping."""
    used = set()
    for path in (ROOT / "dynadjust_tpu_torch").rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Attribute):
                base = node.value
                if isinstance(base, ast.Name) and base.id == "dist":
                    used.add(node.attr)
                elif (isinstance(base, ast.Attribute)
                      and base.attr == "distributed"):
                    used.add(node.attr)
    assert "all_reduce" in used and "broadcast" in used
    assert used <= ALLOWED, used - ALLOWED
