"""``repro_torch.core.autotune`` against ``repro.core.autotune`` on the
CPU: the population case of ``tests/test_engine_equiv.py`` and the cases
of ``tests/test_policy_api.py`` (integer rejection, bounds projection, a
linear-scale key, fabric keys), each history held member by member.

Costs agree within rtol 1e-5 and parameters within rtol 1e-3 (measured:
member 0 and every history parameter equal; a jittered member's cost
1 float32 ulp apart, 9.2e-8 relative, where the reference's exp of a
z-space value inside its compiled, vmapped cost rounds differently from
the same exp alone).
"""
import numpy as np
import pytest
import torch

from repro.core import cc as rcc
from repro.core import engine as reng
from repro.core.autotune import autotune as rautotune
from repro.core.collectives import ScheduleBuilder as RScheduleBuilder
from repro.core.scenario import FabricSpec as RFabricSpec
from repro.core.scenario import IncastSpec as RIncastSpec
from repro.core.scenario import ScenarioSpec as RScenarioSpec
from repro.core.topology import single_switch as rsingle
from repro_torch.core import cc as pcc
from repro_torch.core import engine as peng
from repro_torch.core.autotune import autotune, autotune_spec
from repro_torch.core.collectives import ScheduleBuilder
from repro_torch.core.scenario import FabricSpec, IncastSpec, ScenarioSpec
from repro_torch.core.topology import single_switch

torch.set_num_threads(1)


def _tiny(single, builder):
    """``tests/test_engine_equiv.py``'s 4-to-1 incast of 2 MB."""
    topo = single(5)
    b = builder(topo)
    g = b.new_group("x")
    for s in range(1, 5):
        b.add_flow(s, 0, 2e6, g)
    return topo, b.build()


CASES = {
    # tests/test_engine_equiv.py:151
    "population": dict(policy="dcqcn", tune_keys=["rai_frac", "timer"],
                       steps=3, population=3, max_steps=400),
    # tests/test_policy_api.py: projection, linear scale, fabric keys
    "projection": dict(policy="dcqcn", tune_keys=["rai_frac"], steps=3,
                       lr=5e5, max_steps=400),
    "linear_scale": dict(policy="hpcc", tune_keys=["eta"], steps=2, lr=0.5,
                         population=3, max_steps=300),
    "fabric_keys": dict(policy="dcqcn", tune_keys=[], fabric_keys=["kmin"],
                        steps=2, lr=50.0, max_steps=300),
}


def _run(name, port: bool):
    kw = dict(CASES[name])
    pol, steps = kw.pop("policy"), kw.pop("max_steps")
    cfg = dict(dt=2e-6, max_steps=steps, max_extends=0, queue_stride=0)
    if port:
        return autotune(*_tiny(single_switch, ScheduleBuilder),
                        pcc.get_policy(pol), cfg=peng.EngineConfig(**cfg),
                        device="cpu", **kw)
    return rautotune(*_tiny(rsingle, RScheduleBuilder), rcc.get_policy(pol),
                     cfg=reng.EngineConfig(**cfg), **kw)


def _same_history(got, want):
    assert len(got.history) == len(want.history)
    for hg, hw in zip(got.history, want.history):
        assert set(hg) == set(hw)
        for k, w in hw.items():
            if k in ("step", "projected", "nonfinite_members"):
                assert hg[k] == w, k
            elif k in ("cost", "population_costs"):
                np.testing.assert_allclose(hg[k], w, rtol=1e-5, err_msg=k)
            else:
                np.testing.assert_allclose(hg[k], w, rtol=1e-3, err_msg=k)
    np.testing.assert_allclose(got.baseline_cost, want.baseline_cost,
                               rtol=1e-5)
    np.testing.assert_allclose(got.tuned_cost, want.tuned_cost, rtol=1e-5)
    assert set(got.params) == set(want.params)
    for k, w in want.params.items():
        np.testing.assert_allclose(got.params[k], w, rtol=1e-3, err_msg=k)


@pytest.mark.parametrize("name", list(CASES))
def test_history_matches_reference(name):
    got, want = _run(name, True), _run(name, False)
    _same_history(got, want)
    if name == "population":
        assert len(got.history[0]["population_costs"]) == 3
        assert got.tuned_cost <= got.baseline_cost + 1e-6
    if name == "projection":
        s = pcc.get_policy("dcqcn").param_spec("rai_frac")
        assert all(s.lo <= h["rai_frac"] <= s.hi for h in got.history)
    if name == "fabric_keys":
        s = peng.FABRIC_PARAM_SPECS["kmin"]
        assert s.lo <= float(got.fabric.kmin) <= s.hi
        np.testing.assert_allclose(float(got.fabric.kmin),
                                   float(want.fabric.kmin), rtol=1e-3)


def test_rejects_integer_and_init_baked_params():
    topo, sched = _tiny(single_switch, ScheduleBuilder)
    cfg = peng.EngineConfig(dt=2e-6, max_steps=50, max_extends=0,
                            queue_stride=0)
    with pytest.raises(ValueError, match="integer-valued"):
        autotune(topo, sched, pcc.get_policy("dcqcn"), ["fast_rounds"],
                 steps=1, cfg=cfg, device="cpu")
    with pytest.raises(ValueError, match="integer-valued"):
        autotune(topo, sched, pcc.get_policy("hpcc"), ["max_stage"],
                 steps=1, cfg=cfg, device="cpu")
    with pytest.raises(ValueError, match="consumed by init"):
        autotune(topo, sched, pcc.get_policy("static_window"), ["margin"],
                 steps=1, cfg=cfg, device="cpu")
    with pytest.raises(ValueError, match="per-link-class"):
        autotune(topo, sched, pcc.get_policy("dcqcn"), [],
                 fabric_keys=["kmin"], steps=1, cfg=cfg, device="cpu",
                 fabric_params=peng.FabricParams().with_class(
                     kmin={"tor_down": 1e5}))


def test_fabric_spec_table_is_the_reference_s():
    assert set(peng.FABRIC_PARAM_SPECS) == set(reng.FABRIC_PARAM_SPECS)
    for k, s in reng.FABRIC_PARAM_SPECS.items():
        p = peng.FABRIC_PARAM_SPECS[k]
        assert (p.default, p.lo, p.hi, p.scale, p.integer) == \
            (s.default, s.lo, s.hi, s.scale, s.integer)


def test_nonfinite_member_is_frozen(monkeypatch):
    """A member whose cost is not finite takes no step, is recorded in
    ``nonfinite_members`` and is never the best."""
    real = peng.Simulator.soft_cost_fn

    def poisoned(self, remat=False, lanes=None):
        cost = real(self, remat, lanes)

        def f(cc_params=None, fabric_params=None):
            c = cost(cc_params, fabric_params)
            return c * torch.tensor([1.0, float("nan"), 1.0])
        return f

    monkeypatch.setattr(peng.Simulator, "soft_cost_fn", poisoned)
    res = _run("population", True)
    assert all(h["nonfinite_members"] == [1] for h in res.history)
    assert all(np.isinf(h["population_costs"][1]) for h in res.history)
    assert all(h["cost"] == min(h["population_costs"]) for h in res.history)


def test_autotune_spec_matches_reference():
    """The declarative entry on ``examples/cc_autotune.py``'s incast, cut
    to 300 steps and 2 descent steps."""
    cfg = dict(dt=2e-6, max_steps=300, max_extends=0, queue_stride=0)
    kw = dict(steps=2, lr=0.25, population=2)
    got = autotune_spec(ScenarioSpec(FabricSpec("single", 1, 1, 8),
                                     IncastSpec(7, 10e6), "dcqcn"),
                        ["rai_frac", "g"], cfg=peng.EngineConfig(**cfg),
                        device="cpu", **kw)
    from repro.core.autotune import autotune_spec as rautotune_spec
    want = rautotune_spec(RScenarioSpec(RFabricSpec("single", 1, 1, 8),
                                        RIncastSpec(7, 10e6), "dcqcn"),
                          ["rai_frac", "g"], cfg=reng.EngineConfig(**cfg),
                          **kw)
    _same_history(got, want)


# ---------------------------------------------------------------------------
# why chip_smoke.py holds examples/cc_autotune.py's tunings as it does
# ---------------------------------------------------------------------------

def _example_sims():
    """``examples/cc_autotune.py``'s incast and config, both packages."""
    import chip_smoke
    cfg = dict(chip_smoke.AUTOTUNE_CFG, queue_stride=0)
    rspec = RScenarioSpec(RFabricSpec("single", 1, 1, 8),
                          RIncastSpec(7, 10e6), "dcqcn")
    pspec = ScenarioSpec(FabricSpec("single", 1, 1, 8), IncastSpec(7, 10e6),
                         "dcqcn")
    return (reng.Simulator(*rspec.build(), reng.EngineConfig(**cfg)),
            peng.Simulator(*pspec.build(), peng.EngineConfig(**cfg),
                           device="cpu"))


def test_example_cost_moves_with_one_ulp_of_kmin():
    """The fabric tuning starts at exp(log(400 KB)): 399,999.875 in
    float32.  Four ulps away, at 400,000, the soft cost moves by 2.6e-3
    relative, and the port's moves with the reference's (bit-equal at
    the first, one float32 ulp apart at the second): where the
    reference's compiled, vmapped exp lands an ulp away from its own
    eager exp (the history's value), its member costs differ."""
    rsim, psim = _example_sims()
    rcost = rsim.soft_cost_fn()
    got = {}
    for kmin in (399999.875, 400000.0):
        want = float(rcost(dict(rsim.policy.params),
                           reng.FabricParams(kmin=np.float32(kmin))))
        with torch.no_grad():
            mine = float(psim.soft_cost(
                None, peng.FabricParams(kmin=np.float32(kmin))))
        assert mine == want if kmin == 399999.875 else \
            abs(mine / want - 1) < 1e-6
        got[kmin] = want
    assert abs(got[400000.0] / got[399999.875] - 1) > 1e-3


def test_example_gradient_at_step_1_is_not_reproducible():
    """Member 0 of the CC tuning after one descent step (rai_frac 0.365,
    the reference history's step-1 best): the reference's own gradient
    w.r.t. rai_frac changes sign when rai_frac moves by one float32 ulp,
    so no implementation short of its exact backward arithmetic follows
    its third step; chip_smoke.py runs two."""
    import chip_smoke
    rsim, _ = _example_sims()
    h = chip_smoke.AUTOTUNE_REFERENCE["cc"]["history"][1]
    base = dict(rsim.policy.params)
    cost = rsim.soft_cost_fn()

    def grad_rai(rai):
        import jax
        import jax.numpy as jnp
        return float(jax.grad(lambda r: cost(dict(
            base, rai_frac=r, rhai_frac=jnp.float32(h["rhai_frac"]),
            g=jnp.float32(h["g"])), reng.FabricParams()))(jnp.float32(rai)))

    rai = np.float32(h["rai_frac"])
    g0 = grad_rai(rai)
    g1 = grad_rai(np.nextafter(rai, np.float32(1)))
    assert abs(g0) > 1e4 and np.sign(g0) != np.sign(g1)
