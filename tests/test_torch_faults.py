"""The port's fault-injection step (``repro_torch.core.engine`` with a
faulty ``FaultSpec``) against the reference's jnp step, on the cases of
``tests/test_faults.py``: lossy RoCE with IRN and go-back-N recovery, PFC
off, the loss signal into each loss-aware policy, ECN misconfiguration,
degradation windows and flaps, per-class leaves and the loss invariants
(the batched cases are in ``tests/test_torch_faults_sweep.py``).

Tolerances (the fault step's): completion within 2 steps, delivered and
lost bytes rtol 1e-4, PAUSE frames rtol 1e-3 + atol 1.  On the
single-switch incast every run here is bit-equal to the reference; on
multi-hop lossy paths the reference's compiler fuses the per-hop drop
products differently from fusion to fusion, so single values differ by
an ulp and the tolerances apply.
"""
import dataclasses
import warnings

import numpy as np
import pytest
import torch
from _hyp import given, settings, st

from repro.core import cc as rcc
from repro.core import engine as reng
from repro.core import faults as rfaults
from repro.core import sweep as rsweep
from repro.core.collectives import Schedule as RSchedule
from repro.core.collectives import incast as rincast
from repro.core.topology import (NIC_BW, NIC_LAT, SWITCH_BUF, _Builder,
                                 single_switch)
from repro_torch import convert
from repro_torch.core import cc as pcc
from repro_torch.core import engine as peng
from repro_torch.core import faults as pfaults
from repro_torch.core import sweep as psweep

torch.set_num_threads(1)

STEP_TOL = 2


@pytest.fixture(autouse=True)
def _rearm_unhealthy_warnings():
    psweep.reset_unhealthy_warnings()
    rsweep.reset_unhealthy_warnings()


def _cfg(**kw):
    kw.setdefault("dt", 1e-6)
    kw.setdefault("max_steps", 1500)
    kw.setdefault("max_extends", 3)
    kw.setdefault("queue_stride", 0)
    return kw


def _incast(size=2e6):
    topo = single_switch(8)
    return topo, rincast(topo, list(range(1, 8)), 0, size)


def _ring(size=2e6):
    """tests/test_faults.py's 3-switch ring with a cyclic buffer
    dependency (a textbook PFC deadlock under small thresholds)."""
    b = _Builder("ring3")
    for g in range(3):
        b.add_dev(f"gpu{g}", False)
    sw = [b.add_dev(f"sw{i}", True, SWITCH_BUF) for i in range(3)]
    up = [b.add_link(g, sw[g], NIC_BW, NIC_LAT, ecn=False) for g in range(3)]
    ring = [b.add_link(sw[i], sw[(i + 1) % 3], NIC_BW, NIC_LAT, ecn=True,
                       cls="tor_up") for i in range(3)]
    down = [b.add_link(sw[g], g, NIC_BW, NIC_LAT, ecn=True, cls="tor_down")
            for g in range(3)]
    topo = b.build(3, up, {"kind": "ring", "switches": sw})
    path = np.full((3, 4), -1, np.int32)
    for i in range(3):
        path[i] = [up[i], ring[i], ring[(i + 1) % 3], down[(i + 2) % 3]]
    sched = RSchedule(path, np.full(3, 4, np.int32),
                      np.full(3, size, np.float32), np.zeros(3, np.int32),
                      np.full(3, -1, np.int32), np.zeros(3, np.float32),
                      n_groups=1, group_names=["g0"])
    return topo, sched


def _quiet(fn, *a, **kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        return fn(*a, **kw)


def ref_run(topo, sched, pol, cfg, fault=None, fabric=None):
    return _quiet(reng.simulate, topo, sched, rcc.get_policy(pol),
                  reng.EngineConfig(**cfg, step_impl="jnp"),
                  fabric_params=(None if fabric is None
                                 else reng.FabricParams(**fabric)),
                  fault_spec=None if fault is None
                  else rfaults.FaultSpec(**fault))


def port_sim(topo, sched, pol, cfg, impl="torch"):
    sim = peng.Simulator(convert.topology_from_numpy(topo),
                         convert.schedule_from_numpy(sched),
                         pcc.get_policy(pol), peng.EngineConfig(**cfg),
                         device="cpu")
    if impl == "cuda":
        # the kernel path's plumbing on CPU tensors: every kernel wrapper
        # runs its plain version
        sim.step_impl = "cuda"
    return sim


def port_run(topo, sched, pol, cfg, fault=None, fabric=None, impl="torch"):
    return _quiet(port_sim(topo, sched, pol, cfg, impl).run,
                  fabric_params=(None if fabric is None
                                 else peng.FabricParams(**fabric)),
                  fault_spec=None if fault is None
                  else pfaults.FaultSpec(**fault))


def steps(t, dt):
    t = np.asarray(t, np.float64)
    return np.where(np.isfinite(t), np.rint(t / dt), -1.0)


def assert_agree(port, ref, dt):
    """The fault step's whole-run tolerances."""
    assert port.finished == ref.finished
    assert abs(steps(port.completion_time, dt)
               - steps(ref.completion_time, dt)) <= STEP_TOL
    np.testing.assert_allclose(port.delivered.sum(), ref.delivered.sum(),
                               rtol=1e-4)
    if ref.lost is None:
        assert port.lost is None
    else:
        np.testing.assert_allclose(port.lost.sum(), ref.lost.sum(),
                                   rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(port.pause_count, ref.pause_count, rtol=1e-3,
                               atol=1.0)
    assert (port.deadlocked, port.diverged) == (ref.deadlocked, ref.diverged)


def assert_bit_equal(a, b):
    assert np.array_equal(a.t_finish, b.t_finish)
    assert np.array_equal(a.delivered, b.delivered)
    assert np.array_equal(a.pause_count, b.pause_count)
    assert (a.lost is None) == (b.lost is None)
    if a.lost is not None:
        assert np.array_equal(a.lost, b.lost)


# ---------------------------------------------------------------------------
# the central contract: defaults are inert
# ---------------------------------------------------------------------------

def test_default_faultspec_is_inert_and_bitwise_lossless():
    F = pfaults.FaultSpec
    assert not pfaults.is_faulty(F())
    assert pfaults.is_faulty(F(loss_rate=1e-4))
    assert pfaults.is_faulty(F(pfc_on=0.0))
    assert not pfaults.is_faulty(F().with_class(loss_rate={}))
    assert pfaults.is_faulty(F().with_class(loss_rate={"spine_down": 1e-3}))
    topo, sched = _incast()
    sim = port_sim(topo, sched, "dcqcn", _cfg())
    base = sim.run()
    with_spec = sim.run(fault_spec=F())
    assert_bit_equal(base, with_spec)
    assert with_spec.lost is None
    ref = ref_run(topo, sched, "dcqcn", _cfg(), fault={})
    assert np.array_equal(base.t_finish, ref.t_finish)


def test_fault_param_specs_match_reference():
    assert pfaults.RECOVERY_MODES == rfaults.RECOVERY_MODES
    assert set(pfaults.FAULT_PARAM_SPECS) == set(rfaults.FAULT_PARAM_SPECS)
    for k, s in pfaults.FAULT_PARAM_SPECS.items():
        r = rfaults.FAULT_PARAM_SPECS[k]
        assert (s.default, s.lo, s.hi, s.scale, s.integer) == \
            (r.default, r.lo, r.hi, r.scale, r.integer), k
        assert s.bounded and s.lo <= s.default <= s.hi, k
    with pytest.raises(ValueError, match="unknown recovery"):
        pfaults.FaultSpec.lossy_roce(1e-3, recovery="arq")
    with pytest.raises(ValueError, match="unknown fault params"):
        pfaults.FaultSpec.check_fields(["loss_rat"])


# ---------------------------------------------------------------------------
# lossy RoCE
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("impl", ["torch", "cuda"],
                         ids=["op_path", "kernel_path_plain"])
def test_loss_slows_completion_and_gbn_worse_than_irn(impl):
    topo, sched = _incast()
    cfg = _cfg()
    runs = {}
    for name, fault in (("lossless", None),
                        ("irn", dict(loss_rate=1e-3, gbn=0.0)),
                        ("gbn", dict(loss_rate=1e-3, gbn=1.0))):
        runs[name] = port_run(topo, sched, "pfc", cfg, fault, impl=impl)
        ref = ref_run(topo, sched, "pfc", cfg, fault)
        assert_agree(runs[name], ref, cfg["dt"])
        assert_bit_equal(runs[name], ref)
    assert all(r.finished for r in runs.values())
    assert runs["irn"].lost.sum() > 0
    assert runs["lossless"].completion_time < runs["irn"].completion_time
    assert runs["irn"].completion_time < runs["gbn"].completion_time


def test_pfc_off_operating_point_disables_pausing():
    topo, sched = _incast()
    cfg = _cfg()
    fab = dict(xoff=100e3, xon=50e3)
    on = port_run(topo, sched, "pfc", cfg, fabric=fab)
    assert on.pause_count.sum() > 0
    fault = dict(loss_rate=1e-4, gbn=0.0, pfc_on=0.0)   # lossy_roce(1e-4)
    off = port_run(topo, sched, "pfc", cfg, fault, fabric=fab)
    assert off.pause_count.sum() == 0 and off.finished
    assert_agree(off, ref_run(topo, sched, "pfc", cfg, fault, fabric=fab),
                 cfg["dt"])


LOSS_AWARE = [n for n in pcc.ALL_POLICIES if pcc.get_policy(n).loss_aware]


@pytest.mark.parametrize("name", LOSS_AWARE)
def test_loss_signal_reaches_loss_aware_policy(name):
    """Each loss-aware policy's update receives the loss EWMA (a tensor,
    positive on the lossy flows) and its lossy run holds the
    reference's."""
    assert rcc.get_policy(name).loss_aware
    topo, sched = _incast(1e6)
    cfg = _cfg(max_steps=1000, max_extends=1)
    fault = dict(loss_rate=1e-3, gbn=0.0, pfc_on=1.0)
    seen = []
    sim = port_sim(topo, sched, name, cfg)
    pol = sim.policy

    def spy(p, state, sig):
        seen.append(float(sig.loss.max()))
        return pol.update(p, state, sig)
    sim.policy = dataclasses.replace(pol, update=spy)
    got = _quiet(sim.run, fault_spec=pfaults.FaultSpec(**fault))
    assert got.lost.sum() > 0 and max(seen) > 0
    assert_agree(got, ref_run(topo, sched, name, cfg, fault), cfg["dt"])


def test_dcqcn_loss_reaction_slows_completion():
    topo, sched = _incast(5e6)
    cfg = _cfg()
    fault = dict(loss_rate=1e-5, gbn=0.0, pfc_on=1.0)
    r0 = port_run(topo, sched, "dcqcn", cfg)
    r = port_run(topo, sched, "dcqcn", cfg, fault)
    assert r.finished and r.lost.sum() > 0
    assert r.completion_time > r0.completion_time
    assert_agree(r, ref_run(topo, sched, "dcqcn", cfg, fault), cfg["dt"])


@pytest.mark.parametrize("scale", [0.0, 0.5])
def test_ecn_misconfiguration(scale):
    """ecn_scale scales marking: 0 breaks DCQCN's congestion signal.  The
    kernel path folds the scale into pmax (the reference's Pallas order),
    the op path multiplies after the clip (its jnp order): both within the
    tolerances of the reference's jnp step."""
    topo, sched = _incast()
    cfg = _cfg()
    fault = dict(ecn_scale=scale)
    r0 = port_run(topo, sched, "dcqcn", cfg)
    ref = ref_run(topo, sched, "dcqcn", cfg, fault)
    for impl in ("torch", "cuda"):
        r = port_run(topo, sched, "dcqcn", cfg, fault, impl=impl)
        assert r.finished
        assert r.completion_time != r0.completion_time
        assert_agree(r, ref, cfg["dt"])


def test_link_degradation_and_flaps_delay_completion():
    topo, sched = _incast()
    cfg = _cfg()
    r0 = port_run(topo, sched, "pfc", cfg)
    for fault in (dict(degrade=0.5, degrade_t0=0.0, degrade_t1=1.0),
                  dict(flap_period=200e-6, flap_down=100e-6),
                  dict(flap_period=300e-6, flap_down=50e-6,
                       flap_t0=120e-6)):
        r = port_run(topo, sched, "pfc", cfg, fault)
        assert r.finished and r.completion_time > r0.completion_time
        ref = ref_run(topo, sched, "pfc", cfg, fault)
        assert_agree(r, ref, cfg["dt"])
        assert_bit_equal(r, ref)


def test_per_class_fault_leaves():
    topo, sched = _incast(2e6)
    cfg = _cfg()
    rf = rfaults.FaultSpec()
    for cls, hits in (("tor_down", True), ("spine_down", False)):
        fault = {"loss_rate": pfaults.FaultSpec().with_class(
            loss_rate={cls: 1e-3}).loss_rate}
        r = port_run(topo, sched, "pfc", cfg, fault)
        assert (r.lost.sum() > 0) == hits
        ref = _quiet(reng.simulate, topo, sched, rcc.get_policy("pfc"),
                     reng.EngineConfig(**cfg, step_impl="jnp"),
                     fault_spec=rf.with_class(loss_rate={cls: 1e-3}))
        assert_bit_equal(r, ref)


def _check_loss_invariants(loss_rate, recovery, size=1e6):
    topo, sched = _incast(size)
    cfg = _cfg(max_steps=1000, max_extends=2)
    fault = dict(loss_rate=loss_rate, gbn=float(recovery == "gbn"),
                 pfc_on=1.0)
    r = port_run(topo, sched, "pfc", cfg, fault)
    if loss_rate == 0.0 and recovery == "irn":
        assert r.lost is None          # statically inert spec
        return
    assert np.all(np.isfinite(r.lost)) and np.all(r.lost >= 0)
    assert np.all(np.isfinite(r.delivered)) and np.all(r.delivered >= 0)
    if recovery == "irn":
        assert np.all(r.delivered <= sched.size * 1.1)
    assert_bit_equal(r, ref_run(topo, sched, "pfc", cfg, fault))


@given(st.floats(min_value=0.0, max_value=5e-3),
       st.sampled_from(pfaults.RECOVERY_MODES))
@settings(max_examples=8, deadline=None)
def test_loss_invariants_property(loss_rate, recovery):
    _check_loss_invariants(loss_rate, recovery)


@pytest.mark.parametrize("loss_rate,recovery",
                         [(0.0, "irn"), (0.0, "gbn"), (2e-3, "irn"),
                          (5e-3, "gbn")])
def test_loss_invariants_points(loss_rate, recovery):
    """The property's invariants at fixed points (the property itself
    needs hypothesis)."""
    _check_loss_invariants(loss_rate, recovery)
