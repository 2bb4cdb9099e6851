"""Serial sweep driving of the port's engine (port of the serial part of
``repro.core.sweep.SweepRunner``).

``SweepRunner`` caches prepared scenarios (``engine._prep`` output on the
device) by content fingerprint, and pads flow and group counts up to the
next power of two (inert padding, see ``engine._prep``) so that schedules
of similar size share one set of shapes, as the reference does for its
compile cache.  ``run``, ``run_spec``, ``run_specs`` and ``run_policies``
run one scenario per call.  Batched lanes (``run_batch``, ``grid``,
``grid_spec``, the policy axis), the device mesh and calibration belong
to later slices.

    runner = SweepRunner(EngineConfig(dt=2e-6, max_steps=4000,
                                      queue_stride=0))   # device="cuda"
    results = runner.run_policies(topo, sched, ["pfc", "dcqcn", "hpcc"])
"""
from __future__ import annotations

import dataclasses
import hashlib

import numpy as np

from repro_torch.core import cc as cc_mod
from repro_torch.core.cc import Policy
from repro_torch.core.engine import (EngineConfig, FabricParams, Results,
                                     Simulator, _as_fabric, _FABRIC_DEFAULTS,
                                     _next_pow2, resolve_device)
from repro_torch.core.faults import FaultSpec
from repro_torch.core.scenario import _no_policy_axis


def _resolve(policy) -> Policy:
    return cc_mod.get_policy(policy) if isinstance(policy, str) else policy


def _bucket(n: int, lo: int = 32) -> int:
    return max(lo, _next_pow2(max(n, 1)))


def _policy_key(policy: Policy):
    """Identity of a policy's logic and defaults (init may bake them)."""
    return (policy.name, float(policy.wire_factor),
            getattr(policy.init, "__code__", policy.init),
            getattr(policy.update, "__code__", policy.update),
            tuple(sorted((k, float(v)) for k, v in policy.params.items())))


class SweepRunner:
    """Prepare-once, run-many driver for ``repro_torch.core.engine`` on
    ``device`` (the card by default)."""

    MAX_SIMS = 64

    def __init__(self, cfg: EngineConfig | None = None, bucket: bool = True,
                 device="cuda"):
        self.cfg = cfg or EngineConfig()
        self.bucket = bucket
        self.device = resolve_device(device)
        self._sims: dict = {}

    @staticmethod
    def _scenario_key(topo, sched):
        """Content fingerprint of a (topology, schedule) pair."""
        h = hashlib.sha1()
        for a in (sched.path, sched.size, sched.group, sched.dep,
                  sched.delay, topo.cap, topo.lat, topo.src_dev,
                  topo.dst_dev, topo.ecn_on, topo.fabric, topo.link_class,
                  topo.dev_is_switch, topo.dev_buf):
            h.update(np.ascontiguousarray(a).tobytes())
        return (topo.name, sched.n_flows, sched.n_groups, h.hexdigest())

    def simulator(self, topo, sched, policy: Policy,
                  cfg: EngineConfig | None = None) -> Simulator:
        cfg = cfg or self.cfg
        # fabric scalars arrive per run, so configs differing only there
        # share one prepared Simulator
        key = (self._scenario_key(topo, sched),
               dataclasses.replace(cfg, **_FABRIC_DEFAULTS),
               _policy_key(policy))
        sim = self._sims.get(key)
        if sim is None:
            pf = _bucket(sched.n_flows) if self.bucket else None
            pg = _bucket(sched.n_groups, lo=8) if self.bucket else None
            sim = Simulator(topo, sched, policy, cfg, pad_flows=pf,
                            pad_groups=pg, device=self.device)
            while len(self._sims) >= self.MAX_SIMS:
                self._sims.pop(next(iter(self._sims)))
            self._sims[key] = sim
        return sim

    def run(self, topo, sched, policy: Policy | str,
            cc_params: dict | None = None,
            cfg: EngineConfig | None = None,
            fabric_params: FabricParams | None = None,
            fault_spec: FaultSpec | None = None) -> Results:
        policy = _resolve(policy)
        cfg = cfg or self.cfg
        fab = _as_fabric(fabric_params, cfg)
        return self.simulator(topo, sched, policy, cfg).run(
            cc_params, fabric_params=fab, fault_spec=fault_spec)

    def run_policies(self, topo, sched, policies=None,
                     cfg: EngineConfig | None = None,
                     fabric_params: FabricParams | None = None) -> list:
        """One scenario under each CC policy, serially."""
        return [self.run(topo, sched, p, cfg=cfg, fabric_params=fabric_params)
                for p in (policies or cc_mod.ALL_POLICIES)]

    def run_spec(self, spec, cfg: EngineConfig | None = None) -> Results:
        """Simulate one ``ScenarioSpec``."""
        _no_policy_axis(spec.policy)
        topo, sched, policy = spec.build()
        cc = None
        if spec.cc_params:
            policy.check_tunable(spec.cc_params)
            cc = dict(policy.params, **spec.cc_params)
        return self.run(topo, sched, policy, cc_params=cc, cfg=cfg,
                        fabric_params=spec.fabric_params,
                        fault_spec=spec.fault_spec)

    def run_specs(self, specs, cfg: EngineConfig | None = None) -> list:
        return [self.run_spec(s, cfg=cfg) for s in specs]
