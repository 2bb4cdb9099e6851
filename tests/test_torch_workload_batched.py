"""``simulate_dlrm_policies(batched=True)`` of the port (one policy-axis
batch, op path on the CPU) against the reference's batched run, on the
16-GPU DLRM iteration.  The reference's ``hash`` is shadowed with
``zlib.crc32`` as in ``test_torch_workload.py``, so both build the same
schedule; tolerances as there."""
import zlib

import pytest
import torch

import repro.core.workload as rw
from repro.core.engine import EngineConfig as REngineConfig
from repro_torch.core import EngineConfig
from repro_torch.core import workload as pw
from test_torch_workload import F5, _assert_reports_agree, _fabric


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def crc32_hash(monkeypatch):
    monkeypatch.setattr(rw, "hash", lambda s: zlib.crc32(s.encode()),
                        raising=False)


def test_batched_policy_axis_matches_reference(crc32_hash):
    """``simulate_dlrm_policies(batched=True)``: the 16-GPU iteration
    (``clos(2, 2, 4)``, test_f5's engine config) under pfc and dcqcn as
    one policy-axis batch, against the reference's batched run."""
    topo_r, topo_p = _fabric("clos16")
    gpus = list(range(16))
    want = rw.simulate_dlrm_policies(topo_r, gpus, ("pfc", "dcqcn"),
                                     cfg=REngineConfig(**F5), batched=True)
    got = pw.simulate_dlrm_policies(topo_p, gpus, ("pfc", "dcqcn"),
                                    cfg=EngineConfig(**F5), batched=True,
                                    device="cpu")
    assert [r.policy for r in got] == ["pfc", "dcqcn"]
    for g, w in zip(got, want):
        assert g.finished
        _assert_reports_agree(g, w)
