"""The port's DLRM iteration workload (``repro_torch.core.workload``, op
path on the CPU) against the reference's (``repro.core.workload``).

The reference salts its All-To-All's ECMP keys with Python's ``hash(tag)``,
which changes with ``PYTHONHASHSEED``; the port uses ``zlib.crc32(tag)``.
Each test that compares the two shadows ``hash`` in the reference module
with ``crc32`` (the reference's file is not edited), so both build the
same schedule.

Tolerances (``tests/test_engine_equiv.py``): schedules array for array
equal; ``iteration_time`` rtol 1e-5, PAUSE frames rtol 1e-3 + atol 1 (on
the CPU they come out equal).
"""
import hashlib
import os
import subprocess
import sys
import zlib
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.core.workload as rw
from repro.core.cc import get_policy as r_get_policy
from repro.core.engine import EngineConfig as REngineConfig
from repro.core.topology import clos as r_clos
from repro_torch.core import EngineConfig, clos, get_policy
from repro_torch.core import workload as pw

ROOT = Path(__file__).resolve().parents[1]
# tests/test_paper_claims.py::test_f5's engine config
F5 = dict(dt=2e-6, max_steps=2000, max_extends=5)
SCHED_ARRAYS = ("path", "n_hops", "size", "group", "dep", "delay")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The op path is thousands of small ops: one intra-op thread is
    faster than many, and does not fight the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def crc32_hash(monkeypatch):
    monkeypatch.setattr(rw, "hash", lambda s: zlib.crc32(s.encode()),
                        raising=False)


def _fabric(name):
    # 16 GPUs as in test_f5; 32 GPUs as in examples/dlrm_end_to_end.py
    dims = {"clos16": (2, 2, 4), "clos32": (2, 2, 8)}[name]
    return r_clos(*dims), clos(*dims)


def assert_schedules_equal(got, want):
    assert got.n_groups == want.n_groups
    assert list(got.group_names) == list(want.group_names)
    for k in SCHED_ARRAYS:
        a, b = getattr(got, k), getattr(want, k)
        assert a.dtype == b.dtype, k
        np.testing.assert_array_equal(a, b, err_msg=k)


@pytest.mark.parametrize("algo", ["1d", "2d"])
@pytest.mark.parametrize("fabric", ["clos16", "clos32"])
def test_schedule_equal_to_reference(crc32_hash, fabric, algo):
    topo_r, topo_p = _fabric(fabric)
    gpus = list(range(topo_p.n_gpus))
    want = rw.build_dlrm_iteration(topo_r, gpus,
                                   comm=rw.DLRMCommSpec(allreduce_algo=algo))
    got = pw.build_dlrm_iteration(topo_p, gpus,
                                  comm=pw.DLRMCommSpec(allreduce_algo=algo))
    assert_schedules_equal(got, want)


def _assert_reports_agree(got, want):
    assert got.policy == want.policy
    assert got.finished == want.finished
    np.testing.assert_allclose(got.iteration_time, want.iteration_time,
                               rtol=1e-5)
    np.testing.assert_allclose(got.exposed_comm, want.exposed_comm,
                               rtol=1e-5, atol=1e-5 * want.iteration_time)
    np.testing.assert_allclose(got.pfc_pauses, want.pfc_pauses, rtol=1e-3,
                               atol=1)
    assert got.total_compute == want.total_compute


@pytest.mark.parametrize("pol", ["pfc", "dcqcn"])
def test_iteration_matches_reference(crc32_hash, pol):
    """The 16-GPU iteration of test_f5, simulated by both."""
    topo_r, topo_p = _fabric("clos16")
    gpus = list(range(16))
    want = rw.simulate_dlrm_iteration(topo_r, gpus, r_get_policy(pol),
                                      cfg=REngineConfig(**F5))
    got = pw.simulate_dlrm_iteration(topo_p, gpus, get_policy(pol),
                                     cfg=EngineConfig(**F5), device="cpu")
    assert got.finished
    _assert_reports_agree(got, want)


def test_policy_loop_matches_reference(crc32_hash):
    """``simulate_dlrm_policies`` (serial, one shared runner) on a small
    iteration: 8 GPUs in two nodes, 1D all-reduce of 4 MB."""
    topo_r, topo_p = r_clos(1, 2, 4), clos(1, 2, 4)
    gpus = list(range(8))
    prof = dict(bot_mlp_fwd=20e-6, emb_lookup=10e-6, interact_top_fwd=30e-6,
                top_bwd=40e-6, bot_bwd=20e-6, opt_update=10e-6)
    comm = dict(allreduce_bytes=4e6, alltoall_fwd_bytes=1e6,
                alltoall_bwd_bytes=1e6, n_chunks=2, allreduce_algo="1d")
    cfg = dict(dt=1e-6, max_steps=1500, max_extends=3, queue_stride=0)
    pols = ("pfc", "dcqcn", "hpcc")
    want = rw.simulate_dlrm_policies(
        topo_r, gpus, pols, rw.DLRMComputeProfile(**prof),
        rw.DLRMCommSpec(**comm), cfg=REngineConfig(**cfg), batched=False)
    got = pw.simulate_dlrm_policies(
        topo_p, gpus, pols, pw.DLRMComputeProfile(**prof),
        pw.DLRMCommSpec(**comm), cfg=EngineConfig(**cfg), device="cpu")
    assert [r.policy for r in got] == list(pols)
    for g, w in zip(got, want):
        assert g.finished
        _assert_reports_agree(g, w)


def test_batched_policy_axis_raises():
    """``batched=True`` stacks the policies into one policy axis, which
    needs at least two of them (the reference's ``stack_policies``)."""
    _, topo = _fabric("clos16")
    with pytest.raises(ValueError, match="at least two"):
        pw.simulate_dlrm_policies(topo, list(range(16)), ("pfc",),
                                  batched=True, device="cpu")


def test_spec_and_runner_paths_agree():
    """The iteration as a ScenarioSpec workload (cached schedule) is the
    same schedule ``build_dlrm_iteration`` gives."""
    from repro_torch.core import FabricSpec, ScenarioSpec
    fab = FabricSpec("clos", n_racks=2, nodes_per_rack=2, gpus_per_node=4)
    spec = ScenarioSpec(fab, pw.DLRMIterationSpec(), "pfc")
    topo, sched, pol = spec.build()
    assert pol.name == "pfc"
    assert_schedules_equal(sched, pw.build_dlrm_iteration(
        topo, list(range(16))))


_PATH_HASH = (
    "import sys, hashlib\n"
    "sys.modules['jax'] = None\n"
    "sys.modules['repro'] = None\n"
    "from repro_torch.core import clos, build_dlrm_iteration\n"
    "s = build_dlrm_iteration(clos(2, 2, 4), list(range(16)))\n"
    "print(hashlib.sha1(s.path.tobytes()).hexdigest())\n")


def test_schedule_independent_of_pythonhashseed():
    digests = set()
    for seed in ("1", "2"):
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                   PYTHONHASHSEED=seed)
        out = subprocess.run([sys.executable, "-c", _PATH_HASH],
                             capture_output=True, text=True, env=env,
                             timeout=120)
        assert out.returncode == 0, out.stderr
        digests.add(out.stdout.strip())
    assert len(digests) == 1
    here = pw.build_dlrm_iteration(clos(2, 2, 4), list(range(16)))
    assert digests == {hashlib.sha1(here.path.tobytes()).hexdigest()}
