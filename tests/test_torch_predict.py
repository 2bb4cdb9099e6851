"""The port's HLO-replay bridge (``repro_torch.core.hlo_comm``,
``repro_torch.core.predict``) against the reference's: the HLO parsers on
``tests/test_hlo_tools.py``'s text and on HLO the reference compiles
here, the replayed schedule array for array, and ``predict_policies`` on
``tests/test_system.py``'s case, batched and serial."""
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import hlo_comm as rhlo
from repro.core import predict as rpred
from repro.core.topology import clos as r_clos
from repro_torch.core import hlo_comm as phlo
from repro_torch.core import predict as ppred
from repro_torch.core import sweep as psweep
from repro_torch.core.topology import clos

HLO_TEXT = """
  %ar = f32[1024,512]{1,0} all-reduce(%x), replica_groups={{0,1,2,3}}, to_apply=%add
  %ag.1 = bf16[64,128]{1,0} all-gather(%y), replica_groups=[16,16], dimensions={0}
  %a2a = f32[32]{0} all-to-all(%z), replica_groups={{0,1},{2,3}}
"""
OPS = (("all-reduce", 64e6, 16, 16), ("all-to-all", 16e6, 16, 16))
MESH, AXES = (16, 16), (0, 1)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _compiled_hlo() -> str:
    """HLO of a one-device ``pmap`` with four kinds of collectives, as
    the reference's toolchain emits it (unoptimized and compiled)."""
    def f(x):
        return (jax.lax.psum(x, "i"), jax.lax.all_gather(x, "i"),
                jax.lax.all_to_all(x.reshape(1, -1), "i", 0, 0),
                jax.lax.ppermute(x, "i", [(0, 0)]))
    low = jax.pmap(f, axis_name="i").lower(
        jnp.zeros((1, 64, 32), jnp.float32))
    return low.as_text(dialect="hlo") + "\n" + low.compile().as_text()


def _as_port(ops):
    return [phlo.CollectiveOp(o.kind, o.bytes_total, o.group_size,
                              o.n_groups, o.count) for o in ops]


@pytest.mark.parametrize("source", ["test_hlo_tools", "compiled"])
def test_parsers_match_reference(source):
    text = HLO_TEXT if source == "test_hlo_tools" else _compiled_hlo()
    want = rhlo.extract(text)
    got = phlo.extract(text)
    assert want and [dataclasses_tuple(o) for o in got] == \
        [dataclasses_tuple(o) for o in want]
    assert phlo.summarize(got) == rhlo.summarize(want)
    assert phlo.collective_link_bytes(got) == \
        rhlo.collective_link_bytes(want)
    factors = {"all-reduce": lambda n: 1.5}
    assert phlo.collective_link_bytes(got, factors) == \
        rhlo.collective_link_bytes(want, factors)
    # trip counts are accepted and ignored, as in the reference
    assert phlo.extract(text, {"body": 4}) == got


def dataclasses_tuple(op):
    return (op.kind, op.bytes_total, op.group_size, op.n_groups, op.count)


def test_collective_op_is_hashable_and_frozen():
    op = phlo.CollectiveOp("all-reduce", 10, 2, 1)
    assert hash(op) == hash(phlo.CollectiveOp("all-reduce", 10, 2, 1))
    with pytest.raises(AttributeError):
        op.count = 2


@pytest.mark.parametrize("mesh, axes, n_gpus", [
    (MESH, AXES, 16), (MESH, AXES, 32), ((2, 4, 8), (2, 0, 1), 32),
    ((4, 4), (1, 1), 16)])
def test_schedule_from_ops_matches_reference(mesh, axes, n_gpus):
    rt = r_clos(n_gpus // 16, 2, 8)
    pt = clos(n_gpus // 16, 2, 8)
    rops = [rhlo.CollectiveOp(k, int(b), g, n) for k, b, g, n in OPS]
    want = rpred.schedule_from_ops(rt, rops, mesh, list(axes), n_chunks=3)
    got = ppred.schedule_from_ops(pt, _as_port(rops), mesh, list(axes),
                                  n_chunks=3)
    assert got.n_flows == want.n_flows and got.n_groups == want.n_groups
    assert got.group_names == want.group_names
    for k in ("path", "size", "group", "dep", "delay"):
        assert np.array_equal(getattr(got, k), getattr(want, k)), k
    for ax in set(axes):
        assert ppred.mesh_groups(mesh, ax, n_gpus) == \
            rpred.mesh_groups(mesh, ax, n_gpus)


def test_replay_spec_is_a_scenario_workload():
    spec = ppred.HLOReplaySpec(tuple(_as_port(
        [rhlo.CollectiveOp(k, int(b), g, n) for k, b, g, n in OPS])),
        MESH, AXES)
    topo = clos(1, 2, 8)
    sched = spec.build_schedule(topo)
    assert sched.n_flows == ppred.schedule_from_ops(
        topo, list(spec.ops), MESH, list(AXES)).n_flows
    assert hash(spec) == hash(ppred.HLOReplaySpec(spec.ops, MESH, AXES))


def _assert_reports_agree(got, want, dt):
    assert [g.policy for g in got] == [w.policy for w in want]
    for g, w in zip(got, want):
        assert g.finished == w.finished
        assert g.extend_exhausted == w.extend_exhausted
        assert abs(g.comm_time - w.comm_time) <= 2 * dt + 1e-12
        np.testing.assert_allclose(g.comm_time, w.comm_time, rtol=1e-5)
        np.testing.assert_allclose(g.pauses, w.pauses, rtol=1e-3, atol=1.0)


@pytest.mark.parametrize("policies, ref_batched", [
    (("pfc", "dcqcn"), False), (("hpcc", "mlp"), True)],
    ids=["test_system", "hpcc_mlp"])
def test_predict_policies_matches_reference(policies, ref_batched):
    """``tests/test_system.py``'s case (16-GPU CLOS, mesh (16, 16)),
    batched and serial through the port, against the reference's serial
    runs or its one vmapped batch: the same reports."""
    rops = [rhlo.CollectiveOp(k, b, g, n) for k, b, g, n in OPS]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        want = rpred.predict_policies(rops, MESH, list(AXES),
                                      policies=policies,
                                      topo=r_clos(1, 2, 8),
                                      batched=ref_batched)
        runner = psweep.SweepRunner(ppred.EngineConfig(
            dt=2e-6, max_steps=4000, max_extends=6, queue_stride=0),
            device="cpu")
        for batched in (False, True):
            got = ppred.predict_policies(_as_port(rops), MESH, list(AXES),
                                         policies=policies,
                                         topo=clos(1, 2, 8),
                                         batched=batched, runner=runner)
            _assert_reports_agree(got, want, 2e-6)
            assert all(r.finished and r.comm_time > 0 for r in got)


class Taken(Exception):
    pass


def test_predict_follows_the_advice(monkeypatch):
    """``batched=None`` follows ``policy_axis_pays_off`` of the runner's
    device type."""
    runner = psweep.SweepRunner(device="cpu")
    for path in ("run_policy_axis", "run_specs"):
        def taken(*a, _path=path, **kw):
            raise Taken(_path)
        monkeypatch.setattr(runner, path, taken)
    monkeypatch.setattr(psweep, "_CALIBRATION", {})
    ops = _as_port([rhlo.CollectiveOp(k, b, g, n) for k, b, g, n in OPS])
    for axis, want in ((0.0, "run_specs"), (float("inf"),
                                            "run_policy_axis")):
        psweep.set_calibration(psweep.BackendCalibration(
            "cpu", crossover={"policy_axis": axis}))
        with pytest.raises(Taken, match=want):
            ppred.predict_policies(ops, MESH, AXES, ("pfc", "dcqcn"),
                                   topo=clos(1, 2, 8), runner=runner)
