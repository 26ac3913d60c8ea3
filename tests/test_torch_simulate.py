"""import --simulate in the port against the JAX package.

network/simulate.py::simulate_measurements replaces every measurement of
a network with the value its coordinates give, and nominal standard
deviations.  On a seeded 12 x 12 mixed network (GNSS baselines, slope
distances, angles, zenith distances, level differences and heights):

  * simulate_measurements of both packages gives identical values and
    sigmas;
  * import --simulate of both CLIs writes the same <name>.simulated.msr
    file, but for the comment naming the package and the angles'
    seconds, which the port's DNA writer writes with two whole digits
    (ROADMAP.md F8: the JAX package's reader misreads its own writer's
    seconds below 1, so the JAX CLI's file does not adjust to zero
    residual);
  * the stations imported with the simulated file adjust (host route and
    the port's --phased --tpu --device cpu) with max_corr < 5e-4 m and
    sigma zero < 0.01, tests/test_simulate.py's bounds on sample data.
"""

import pickle

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from dynadjust_tpu.cli import main as jax_main
from dynadjust_tpu.io_formats.dna_writer import write_dna_msr, write_dna_stn
from dynadjust_tpu.network.simulate import simulate_measurements as jsim
from dynadjust_tpu.utils.synthetic_mixed import synthetic_mixed_network
from dynadjust_tpu_torch.cli import main as torch_main
from dynadjust_tpu_torch.network.data import from_reference
from dynadjust_tpu_torch.network.simulate import simulate_measurements
from test_torch_dna import zero_padded_seconds


def _values(rec):
    """Every number of a record that simulation sets."""
    if hasattr(rec, "obs"):
        return np.concatenate([np.r_[o.vec, o.vcv.ravel()] for o in rec.obs])
    return np.array([rec.value, rec.sd])


def test_simulated_values_and_sigmas_agree():
    jnet, _ = synthetic_mixed_network(12, 12, block_rows=6, block_cols=6,
                                      seed=3)
    tnet = from_reference(jnet)
    before = [_values(r) for r in tnet.measurements]
    n = simulate_measurements(tnet)
    assert n == jsim(jnet) == len(jnet.measurements)
    changed = 0
    for a, b, c in zip(tnet.measurements, jnet.measurements, before):
        np.testing.assert_array_equal(_values(a), _values(b))
        changed += not np.array_equal(_values(a), c)
    assert changed == len(before)


@pytest.fixture(scope="module")
def simulated(tmp_path_factory):
    d = tmp_path_factory.mktemp("simulate")
    net, _ = synthetic_mixed_network(12, 12, block_rows=6, block_cols=6,
                                     seed=3)
    write_dna_stn(str(d / "n.stn"), net)
    write_dna_msr(str(d / "n.msr"), net)
    for side, main in (("jax", jax_main), ("torch", torch_main)):
        (d / side).mkdir()
        assert main(["import", "-n", "n", str(d / "n.stn"),
                     str(d / "n.msr"), "--simulate",
                     "--output-folder", str(d / side)]) == 0
    return d



def test_simulated_msr_files_identical(simulated):
    t = (simulated / "torch" / "n.simulated.msr").read_text().splitlines()
    j = (simulated / "jax" / "n.simulated.msr").read_text().splitlines()
    assert len(t) > 500 and t[0] == j[0]
    assert t[1] == j[1].replace("dynadjust_tpu", "dynadjust_tpu_torch")
    assert t[2:] == [zero_padded_seconds(ln) for ln in j[2:]]
    assert t[2:] != j[2:]             # the file holds angles to pad


@pytest.mark.parametrize("route", [[], ["--phased", "--tpu", "--device",
                                        "cpu"]], ids=["host", "phased-tpu"])
def test_simulated_network_adjusts_to_zero_residual(simulated, tmp_path,
                                                    route):
    w = tmp_path / "w"
    w.mkdir()
    common = ["--output-folder", str(w)]
    assert torch_main(["import", "-n", "s", str(simulated / "n.stn"),
                       str(simulated / "torch" / "n.simulated.msr"),
                       *common]) == 0
    assert torch_main(["segment", "s", "--min-inner-stns", "30",
                       "--max-block-stns", "60", *common]) == 0
    assert torch_main(["adjust", "s", *route, *common]) == 0
    with open(w / "s.results.pkl", "rb") as f:
        res = pickle.load(f)
    assert res.status == "Converged" and res.iterations <= 2
    assert abs(res.max_corr) < 5e-4
    assert res.sigma_zero < 0.01
