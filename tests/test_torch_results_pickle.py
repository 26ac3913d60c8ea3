"""The port's adjustment results pickle and load without a card.

Past the dense-covariance cap (DTA_DENSE_COV_MAX_STN) adjust_tpu_blocked
puts a BlockCovProvider around a local closure into the result; the
JAX package's CLI then fails to pickle it.  The port's provider drops
the closure and its cache when pickled, and a provider loaded back
raises a clear error when asked for a block.  The result holds no
torch tensor, so --report-mode reads it on any machine; the CLI writes
and reads it back past the cap.
"""

import io
import pickle

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from dynadjust_tpu_torch.adjust import AdjustmentOptions
from dynadjust_tpu_torch.adjust.tpu_blocked import adjust_tpu_blocked
from dynadjust_tpu_torch.cli import main
from dynadjust_tpu_torch.io_formats.dna_writer import (write_dna_msr,
                                                       write_dna_stn)
from dynadjust_tpu_torch.utils.synthetic_mixed import synthetic_mixed_network


def _tensors(obj, seen=None):
    """Every torch tensor reachable from obj."""
    seen = set() if seen is None else seen
    if id(obj) in seen:
        return []
    seen.add(id(obj))
    if isinstance(obj, torch.Tensor):
        return [obj]
    if isinstance(obj, dict):
        items = list(obj.keys()) + list(obj.values())
    elif isinstance(obj, (list, tuple, set)):
        items = list(obj)
    elif hasattr(obj, "__dict__"):
        items = list(vars(obj).values())
    else:
        return []
    return [t for x in items for t in _tensors(x, seen)]


class _NoTorch(pickle.Unpickler):
    def find_class(self, module, name):
        assert not module.startswith("torch"), (module, name)
        return super().find_class(module, name)


@pytest.mark.parametrize("super_blocks", [0, 2], ids=["two-level",
                                                      "nested"])
def test_result_pickles_past_the_cap(monkeypatch, super_blocks):
    monkeypatch.setenv("DTA_DENSE_COV_MAX_STN", "10")
    net, seg = synthetic_mixed_network(8, 8, block_rows=4, block_cols=4)
    res = adjust_tpu_blocked(net, AdjustmentOptions(), seg=seg,
                             device="cpu", super_blocks=super_blocks)
    assert res.cov_xyz is None and res.block_cov is not None
    live = res.block_cov.block_cov(0)
    assert not _tensors(res)
    blob = pickle.dumps(res, protocol=pickle.HIGHEST_PROTOCOL)
    back = _NoTorch(io.BytesIO(blob)).load()
    np.testing.assert_array_equal(back.xyz, res.xyz)
    np.testing.assert_array_equal(back.cov_stn, res.cov_stn)
    assert back.block_cov.block_of(0) == res.block_cov.block_of(0)
    np.testing.assert_array_equal(back.block_cov.partners(0),
                                  res.block_cov.partners(0))
    with pytest.raises(RuntimeError, match="DTA_DENSE_COV_MAX_STN"):
        back.block_cov.block_cov(0)
    # the live provider is untouched by pickling
    np.testing.assert_array_equal(res.block_cov.block_cov(0), live)


def test_cli_results_past_the_cap(monkeypatch, tmp_path):
    monkeypatch.setenv("DTA_DENSE_COV_MAX_STN", "10")
    net, _ = synthetic_mixed_network(8, 8, block_rows=4, block_cols=4)
    write_dna_stn(str(tmp_path / "n.stn"), net)
    write_dna_msr(str(tmp_path / "n.msr"), net)
    out = ["--output-folder", str(tmp_path)]
    assert main(["import", "-n", "n", str(tmp_path / "n.stn"),
                 str(tmp_path / "n.msr"), *out]) == 0
    assert main(["segment", "n", "--min-inner-stns", "20",
                 "--max-block-stns", "40", *out]) == 0
    assert main(["adjust", "n", "--phased", "--tpu", "--device", "cpu",
                 *out]) == 0
    adj = (tmp_path / "n.phased.adj").read_text()
    with open(tmp_path / "n.results.pkl", "rb") as f:
        res = _NoTorch(f).load()
    assert res.cov_xyz is None and res.status == "Converged"
    (tmp_path / "n.phased.adj").unlink()
    assert main(["adjust", "n", "--phased", "--tpu", "--report-mode",
                 *out]) == 0
    mark = "Number of unknown parameters"
    again = (tmp_path / "n.phased.adj").read_text()
    assert again[again.index(mark):] == adj[adj.index(mark):]
