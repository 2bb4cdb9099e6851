"""The port's engine (``repro_torch.core.engine``, op path on the CPU)
against the reference's jnp engine (``repro.core.engine``).

Whole runs use the repository's own tolerances
(``tests/test_engine_equiv.py``): ``finished`` equal, completion time and
every ``t_finish`` within one step (event times are step-quantised),
delivered bytes rtol 1e-4, PAUSE frames rtol 1e-3 / atol 1.  One step
from the same mid-run state is compared leaf by leaf at rtol 1e-6.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _engine_scenarios import scenarios
from repro.core import cc as rcc
from repro.core import engine as reng
from repro.core.faults import FaultSpec as RFaultSpec
from repro_torch import convert
from repro_torch.core import cc as pcc
from repro_torch.core import engine as peng
from repro_torch.core import FaultSpec, incast, single_switch

CASES = [(tag, topo, sched, pol, cfg)
         for tag, topo, sched, pols, cfg in scenarios() for pol in pols]
# HPCC with probabilistic INT, on the 8-GPU CLOS case
CASES += [(tag, topo, sched, "hpcc_pint", cfg)
          for tag, topo, sched, pols, cfg in scenarios()
          if tag == "ar1d_clos8"]


def _port_cfg(cfg, **kw):
    fields = {f.name: getattr(cfg, f.name)
              for f in dataclasses.fields(peng.EngineConfig)
              if f.name != "step_impl"}
    return peng.EngineConfig(**dict(fields, **kw))


def _port_sim(topo, sched, pol, cfg, **kw):
    return peng.Simulator(convert.topology_from_numpy(topo),
                          convert.schedule_from_numpy(sched),
                          pcc.get_policy(pol), _port_cfg(cfg),
                          device="cpu", **kw)


def steps(t, dt):
    """Event times are float32 stamps of (step + 1) * dt: compare them as
    step counts (a stamp's own rounding is not a step; never = -1)."""
    t = np.asarray(t, np.float64)
    return np.where(np.isfinite(t), np.rint(t / dt), -1.0)


def assert_runs_agree(port, ref, dt):
    assert port.finished == ref.finished
    assert abs(steps(port.completion_time, dt)
               - steps(ref.completion_time, dt)) <= 1
    np.testing.assert_allclose(steps(port.t_finish, dt),
                               steps(ref.t_finish, dt), rtol=0, atol=1)
    np.testing.assert_allclose(port.delivered.sum(), ref.delivered.sum(),
                               rtol=1e-4)
    np.testing.assert_allclose(port.pause_count, ref.pause_count, rtol=1e-3,
                               atol=1.0)


@pytest.mark.parametrize("tag,topo,sched,pol,cfg", CASES,
                         ids=[f"{t}-{p}" for t, _, _, p, _ in CASES])
def test_whole_run_matches_reference(tag, topo, sched, pol, cfg):
    ref = reng.simulate(topo, sched, rcc.get_policy(pol),
                        dataclasses.replace(cfg, step_impl="jnp"))
    port = _port_sim(topo, sched, pol, cfg).run()
    assert_runs_agree(port, ref, cfg.dt)
    assert port.meta["steps_run"] == ref.meta["steps_run"]
    np.testing.assert_allclose(steps(port.group_time, cfg.dt),
                               steps(ref.group_time, cfg.dt), rtol=0, atol=1)
    assert (port.deadlocked, port.storm_step, port.diverged) == \
        (ref.deadlocked, ref.storm_step, ref.diverged)


def _flat(carry):
    out = {}
    for k, v in carry.items():
        if isinstance(v, dict):
            out.update({f"{k}.{kk}": np.asarray(vv) for kk, vv in v.items()})
        else:
            out[k] = np.asarray(v)
    return out


@pytest.mark.parametrize("case,n_steps", [(1, 60), (4, 100), (6, 150)],
                         ids=["incast-dcqcn", "clos8-static_window",
                              "a2a32-dcqcn"])
def test_one_step_from_the_same_state(case, n_steps):
    """Reference: N jitted steps from its initial carry; port: one step
    from that carry (converted), on the op path and on the kernel path's
    plumbing (the wrappers' plain versions on CPU tensors)."""
    tag, topo, sched, pol, cfg = CASES[case]
    rpol = rcc.get_policy(pol)
    pp, plan = reng._prep(topo, sched, cfg)
    carry = reng._init_carry(pp, plan, rpol, cfg, rpol.params)
    step = jax.jit(reng._make_step(rpol, dataclasses.replace(
        cfg, step_impl="jnp"), plan))
    fab, flt = reng.FabricParams.from_config(cfg), RFaultSpec()
    params = {k: jnp.float32(v) for k, v in rpol.params.items()}
    for it in range(n_steps):
        carry = step(carry, jnp.int32(it), pp, params, fab, flt)
    want = _flat(step(carry, jnp.int32(n_steps), pp, params, fab, flt))

    sim = _port_sim(topo, sched, pol, cfg)
    assert sim.plan == peng._Plan(**dataclasses.asdict(plan))
    for use_kernels in (False, True):
        pstep = peng._make_step(sim.policy, sim.cfg, sim.plan, sim.pp, None,
                                sim.fabric, use_kernels)
        # the port's carry has a leading lane axis: one lane here
        lane = convert.carry_from_numpy(
            _flat_to_carry(jax.tree_util.tree_map(lambda x: x[None],
                                                  carry)))
        got = convert.carry_to_numpy(pstep(lane, n_steps))
        got = {k: v[0] for k, v in _flat(got).items()}
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(got[k].astype(np.float64),
                                       want[k].astype(np.float64),
                                       rtol=1e-6, err_msg=k)


def _flat_to_carry(carry):
    return {k: ({kk: np.asarray(vv) for kk, vv in v.items()}
                if isinstance(v, dict) else np.asarray(v))
            for k, v in carry.items()}


def _tiny():
    topo = single_switch(8)
    return topo, incast(topo, list(range(1, 8)), 0, 2e6)


def test_early_exit_bitwise_equals_monolithic():
    topo, sched = _tiny()
    cfg = peng.EngineConfig(dt=1e-6, max_steps=700, max_extends=1,
                            chunk_steps=177, queue_stride=0)
    sim = peng.Simulator(topo, sched, pcc.get_policy("dcqcn"), cfg,
                         device="cpu")
    fast, full = sim.run(early_exit=True), sim.run(early_exit=False)
    assert fast.finished and full.finished
    assert fast.meta["steps_run"] < full.meta["steps_run"]
    assert fast.meta["steps_run"] % 177 == 0
    assert np.array_equal(fast.t_finish, full.t_finish)
    assert np.array_equal(fast.pause_count, full.pause_count)
    assert np.array_equal(fast.delivered, full.delivered)


def test_padding_is_inert():
    topo, sched = _tiny()
    cfg = peng.EngineConfig(dt=1e-6, max_steps=700, max_extends=1,
                            queue_stride=0)
    pol = pcc.get_policy("dctcp")
    base = peng.Simulator(topo, sched, pol, cfg, device="cpu").run()
    padded = peng.Simulator(topo, sched, pol, cfg, device="cpu",
                            pad_flows=sched.n_flows + 17,
                            pad_groups=sched.n_groups + 3).run()
    assert padded.t_finish.shape == base.t_finish.shape
    assert np.array_equal(base.t_finish, padded.t_finish)
    assert np.array_equal(base.pause_count, padded.pause_count)
    np.testing.assert_allclose(base.delivered, padded.delivered, rtol=1e-6)


def test_queue_stride_subsamples_timeline():
    topo, sched = _tiny()
    runs = {}
    for stride in (0, 1, 4):
        cfg = peng.EngineConfig(dt=1e-6, max_steps=600, max_extends=1,
                                queue_stride=stride)
        runs[stride] = peng.Simulator(topo, sched, pcc.get_policy("pfc"),
                                      cfg, device="cpu").run()
    n = len(runs[4].dev_queue)
    assert n > 0
    assert np.array_equal(runs[4].dev_queue, runs[1].dev_queue[::4][:n])
    assert runs[0].dev_queue.size == 0
    assert np.array_equal(runs[0].t_finish, runs[1].t_finish)


def test_timeline_matches_reference():
    topo, sched = _tiny()
    cfg = reng.EngineConfig(dt=1e-6, max_steps=600, max_extends=1,
                            queue_stride=4, step_impl="jnp")
    ref = reng.simulate(topo, sched, rcc.get_policy("pfc"), cfg)
    port = _port_sim(topo, sched, "pfc", cfg).run()
    assert port.dev_queue.shape == ref.dev_queue.shape
    np.testing.assert_allclose(port.dev_queue, ref.dev_queue, rtol=1e-6)


def test_faulty_spec_is_not_ported_yet():
    """The fault branches are ported now: a faulty spec runs the faulty
    step (Results.lost filled) instead of raising, serially and on a
    Simulator's default spec alike (tests/test_torch_faults.py holds it
    against the reference)."""
    topo, sched = _tiny()
    sim = peng.Simulator(topo, sched, pcc.get_policy("pfc"), device="cpu",
                         cfg=peng.EngineConfig(dt=1e-6, max_steps=700,
                                               max_extends=1,
                                               queue_stride=0),
                         fault_spec=FaultSpec.lossy_roce(1e-3))
    r = sim.run()
    assert r.finished and r.lost is not None and r.lost.sum() > 0
    assert sim.run(fault_spec=FaultSpec()).lost is None


def test_fabric_params_per_class_match_reference():
    """Per-link-class ECN/PFC knobs reach the step as in the reference."""
    tag, topo, sched, _, cfg = next(c for c in CASES if c[0] == "ar1d_clos8")
    rfab = reng.FabricParams().with_class(kmin={"tor_down": 100e3},
                                          xoff={"host_nic": 0.3e6})
    ref = reng.simulate(topo, sched, rcc.get_policy("dcqcn"),
                        dataclasses.replace(cfg, step_impl="jnp"),
                        fabric_params=rfab)
    port = peng.Simulator(
        convert.topology_from_numpy(topo), convert.schedule_from_numpy(sched),
        pcc.get_policy("dcqcn"), _port_cfg(cfg),
        fabric_params=convert.fabric_params_from_numpy(rfab),
        device="cpu").run()
    assert_runs_agree(port, ref, cfg.dt)
    pfab = peng.FabricParams().with_class(kmin={"tor_down": 100e3},
                                          xoff={"host_nic": 0.3e6})
    for f in peng.FabricParams.FIELDS:
        assert np.array_equal(np.asarray(getattr(pfab, f)),
                              np.asarray(getattr(rfab, f))), f
