"""The port's national-scale tools (dynadjust_tpu_torch/tools/
national_mixed.py and national_streamed.py) against the JAX package's
counterparts (scripts/national_mixed_demo.py, national_streamed_demo.py)
at small size on the CPU, and the packaged per-station reference
(tools/national_102400_ref.npz) against the committed JAX result it was
built from (artifacts/national_run_v3/national_102400stn.xyz).

  * mixed: national_mixed.run(24, 24, 6, 4) against the JAX package's
    adjust_tpu_blocked on the same network, segmentation, super_blocks
    and 2-D super grouping: the same iterations, xyz within 1e-8 m,
    sigma zero within 1e-9, station covariances within 1e-9 relative
    (both at the port's Newton tolerance, 1e-12);
    the record's error-against-truth and formal-SD fields are the JAX
    script's formulas applied to the JAX result;
  * streamed: national_streamed.run(24, 24, 6, 2) against the JAX
    package's schur_solve_nested_factored(streamed=True, refine=0,
    max_refine=3) on the same normals: xi and xj within 1e-10 of the
    largest correction, the relative residual at most 1e-10, the reuse
    apply equal to the first solve;
  * each tool's entry point writes its JSON record (and the mixed one
    its .adj, .xyz and .apu), and exits 1 without a card unless told to
    run on the CPU;
  * the packaged reference: rebuilt from the artifact and the port's
    generator it matches the file (station names and order, every
    number within 1e-5 m), and the comparison the card's gate uses flags
    a station moved by 2e-4 m.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

import dynadjust_tpu.adjust as JA
from dynadjust_tpu.adjust.tpu_blocked import \
    adjust_tpu_blocked as jax_adjust
from dynadjust_tpu.parallel import schur as JS
from dynadjust_tpu.parallel.blocked_adjust import (BlockedNetwork,
                                                   build_normals)
from dynadjust_tpu.utils.synthetic import (grid_segmentation,
                                           grid_super_assignment,
                                           synthetic_grid_network)
from dynadjust_tpu.utils.synthetic_mixed import \
    synthetic_mixed_network as jsynth
from dynadjust_tpu_torch.tools import national_mixed, national_streamed

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
ARTIFACT = ROOT / "artifacts" / "national_run_v3" / "national_102400stn.xyz"


def _jax_script_fields(res, truth):
    """scripts/national_mixed_demo.py's formulas (:104-145)."""
    err = np.linalg.norm(res.xyz - truth, axis=1)
    sd = np.sqrt(np.maximum(
        res.cov_stn[:, 0, 0] + res.cov_stn[:, 1, 1] + res.cov_stn[:, 2, 2],
        0.0))
    return {"err_vs_truth_mm": {
                "median": round(float(np.median(err)) * 1e3, 3),
                "p99": round(float(np.percentile(err, 99)) * 1e3, 3),
                "max": round(float(err.max()) * 1e3, 3)},
            "formal_sd_mm_median": round(float(np.median(sd)) * 1e3, 3)}


@pytest.fixture(scope="module")
def mixed_pair():
    with pytest.MonkeyPatch.context() as mp:
        # the port's Newton tolerance for both: at the JAX package's
        # resident default (3e-9) its station covariances stop 1.5e-9
        # relative short of the converged ones on this network
        mp.setenv("DTA_NEWTON_TOL", "1e-12")
        return _mixed_pair()


def _mixed_pair():
    rows, cols, block, sup = 24, 24, 6, 4
    ours, rec = national_mixed.run(rows, cols, block, sup, device="cpu")
    # the JAX script's path (:66-77)
    net, seg, truth = jsynth(rows, cols, block_rows=block, block_cols=block,
                             return_truth=True)
    g = max(1, int(round(sup ** 0.5)))
    tr, tc = (rows + block - 1) // block, (cols + block - 1) // block
    block_super = grid_super_assignment(rows, cols, block, block,
                                        (tr + g - 1) // g, (tc + g - 1) // g)
    ref = jax_adjust(net, JA.AdjustmentOptions(), seg=seg, super_blocks=sup,
                     block_super=block_super)
    return ours, rec, ref, truth


def test_mixed_tool_matches_jax(mixed_pair):
    ours, rec, ref, truth = mixed_pair
    assert ours.status == ref.status == "Converged"
    assert ours.iterations == ref.iterations == rec["iterations"]
    np.testing.assert_array_equal(ours.truth, truth)
    assert np.abs(ours.xyz - ref.xyz).max() <= 1e-8
    assert abs(ours.sigma_zero - ref.sigma_zero) <= 1e-9
    assert (np.abs(ours.cov_stn - ref.cov_stn).max()
            <= 1e-9 * np.abs(ref.cov_stn).max())
    assert rec["pass_fail"] == ref.pass_fail
    assert rec["blocks"] == 16 and rec["super_blocks"] == 4


def test_mixed_record_fields_are_the_jax_scripts(mixed_pair):
    ours, rec, ref, truth = mixed_pair
    want = _jax_script_fields(ref, truth)
    assert rec["err_vs_truth_mm"] == want["err_vs_truth_mm"]
    assert rec["formal_sd_mm_median"] == want["formal_sd_mm_median"]
    assert rec["sigma0"] == round(float(ref.sigma_zero), 4)
    assert len(rec["iter_s"]) == len(rec["solve_evidence"]) == rec[
        "iterations"]
    assert rec["route"]["solve"] == "device"
    assert rec["route"]["pool_bytes"] > 0
    ev = rec["refine_evidence"]
    assert ev["l1_err"] < 1e-8 and ev["l3_err"] < 1e-8
    assert rec["solve_evidence"][-1]["solve_rel"] <= 1e-9
    assert set(rec["phase_profile_s"]) >= {"setup", "factor", "solve",
                                           "stats", "stats_sub"}


def test_streamed_tool_matches_jax():
    rows, cols, block, sup = 24, 24, 6, 2
    ours, rec = national_streamed.run(rows, cols, block, sup, device="cpu")
    # the JAX script's path (:40-67)
    xyz, pairs, obs, var, x0, fixed = synthetic_grid_network(rows, cols,
                                                             seed=7)
    blocks, junction = grid_segmentation(rows, cols, block, block)
    bn = BlockedNetwork(nstations=rows * cols, pairs=pairs, obs=obs,
                        weight=1.0 / var, blocks=blocks,
                        junction_stations=junction, constrained=fixed)
    bs = build_normals(bn, x0, 0.01)
    part = JS.build_nested_partition(bs, grid_super_assignment(
        rows, cols, block, block, sup, sup))
    xi, xj, factors = JS.schur_solve_nested_factored(
        bs, part, refine=0, streamed=True, max_refine=3)
    np.testing.assert_array_equal(ours.bs.Nii, bs.Nii)
    scale = max(np.abs(xi).max(), np.abs(xj).max())
    assert np.abs(ours.xi - xi).max() <= 1e-10 * scale
    assert np.abs(ours.xj - xj).max() <= 1e-10 * scale
    assert rec["relative_residual"] <= 1e-10
    assert rec["reuse_vs_solve_rel"] <= 1e-10
    np.testing.assert_allclose(ours.xi_reuse, ours.xi, rtol=0,
                               atol=1e-10 * scale)
    assert (rec["stations"], rec["blocks"], rec["super_blocks"]) == (
        576, 16, part.SB)
    assert rec["baselines"] == len(pairs)
    assert rec["refine_evidence"]["inline"] is True
    led = rec["transfer_ledger"]
    assert led["up_gb"] >= led["up_tri_Nii64_gb"]
    assert led["down_gb"] >= led["down_tri_A64_gb"]


@pytest.mark.parametrize("tool", ["mixed", "mixed-staged", "streamed"])
def test_entry_point_writes_record(tool, tmp_path, capsys):
    mixed = tool.startswith("mixed")
    mod = national_mixed if mixed else national_streamed
    args = ["12", "12", "6", "4"] if mixed else ["12", "12", "6", "1"]
    if tool == "mixed-staged":
        args.append("--staged")
    assert mod.main([*args, "--device", "cpu", "--out", str(tmp_path)]) == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    name = ("national_144stn" if mixed else "streamed_144stn")
    assert json.loads((tmp_path / f"{name}.json").read_text()) == rec
    assert rec["stations"] == 144
    if mixed:
        assert rec["status"] == "Converged"
        # staged: host assembly and the host loop (adjust_tpu_blocked)
        assert rec["staged"] == (tool == "mixed-staged")
        assert rec["route"]["assembly"] == ("host" if rec["staged"]
                                            else "device")
        for ext in ("adj", "xyz", "apu"):
            assert (tmp_path / f"{name}.{ext}").stat().st_size > 0, ext
        assert set(rec["t_write_s"]) == {"adj", "xyz", "apu"}
        names, xyz, sd = national_mixed.read_xyz(tmp_path / f"{name}.xyz")
        assert len(names) == 144 and np.isfinite(sd).all()
    else:
        assert rec["relative_residual"] <= 1e-10


@pytest.mark.parametrize("tool", ["mixed", "streamed"])
def test_entry_point_needs_a_card_unless_told(tool, monkeypatch, tmp_path,
                                              capsys):
    mod = national_mixed if tool == "mixed" else national_streamed
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert mod.main(["12", "12", "6", "2", "--out", str(tmp_path)]) == 1
    assert "no CUDA card" in capsys.readouterr().err
    with pytest.raises(RuntimeError, match="no CUDA card"):
        mod.run(12, 12, 6, 2)
    assert not list(tmp_path.iterdir())


@pytest.fixture(scope="module")
def national_truth():
    net, _, truth, _ = national_mixed.build(*national_mixed.REF_CONFIG)
    return list(net.names), truth


def test_packaged_reference_rebuilds_from_artifact(national_truth):
    names, truth = national_truth
    packaged = national_mixed.load_reference()
    rebuilt = national_mixed.build_reference(ARTIFACT)
    assert str(packaged["names_sha1"]) == str(rebuilt["names_sha1"]) \
        == national_mixed.names_digest(names)
    file_names, xyz, sd = national_mixed.read_xyz(ARTIFACT)
    assert file_names == names and len(names) == 102400
    for k in ("dxyz", "sd_enu"):
        assert packaged[k].shape == (102400, 3)
        assert packaged[k].dtype == np.float32
        assert np.abs(packaged[k].astype(np.float64)
                      - rebuilt[k].astype(np.float64)).max() <= 1e-5
    assert np.abs(truth + packaged["dxyz"] - xyz).max() <= 1e-5
    assert np.abs(packaged["sd_enu"] - sd).max() <= 1e-5
    # S0_0 is constrained: adjusted = truth, SD 0
    assert np.abs(packaged["dxyz"][0]).max() <= 1e-4
    assert not packaged["sd_enu"][0].any()


def test_reference_comparison_flags_a_moved_station(national_truth):
    names, truth = national_truth
    ref = national_mixed.load_reference()
    xyz = truth + ref["dxyz"].astype(np.float64)
    sd = ref["sd_enu"].astype(np.float64)
    ok = national_mixed.compare(xyz, sd, truth, names, ref)
    assert ok["ok"] and ok["n_bad"] == 0 and ok["max_dxyz_m"] <= 1e-9
    assert ok["n_past_rounding"] == {"xyz": 0, "sd": 0}
    k = 4321
    moved = xyz.copy()
    moved[k, 1] += 2e-4
    out = national_mixed.compare(moved, sd, truth, names, ref)
    assert not out["ok"] and out["n_bad"] == 1
    assert out["bad"][0]["station"] == names[k]
    assert out["max_dxyz_m"] == pytest.approx(2e-4, abs=1e-9)
    assert out["n_past_rounding"] == {"xyz": 1, "sd": 0}
    assert out["worst"][0] == out["bad"][0]
    sd2 = sd.copy()
    sd2[k + 1, 2] -= 2e-4
    out = national_mixed.compare(xyz, sd2, truth, names, ref)
    assert not out["ok"] and out["bad"][0]["station"] == names[k + 1]
    out = national_mixed.compare(xyz, sd, truth, names[::-1], ref)
    assert not out["ok"] and not out["names_match"]
