"""Declarative scenario layer: every simulation point as one spec (port of
``repro.core.scenario``).

    FabricSpec    -- topology family + BW/latency/buffer/oversubscription
    ScenarioSpec  -- fabric x workload x CC policy x FabricParams

    spec = ScenarioSpec(fabric=FabricSpec(n_racks=2),
                        workload=CollectiveSpec("ring", 64e6),
                        policy="dcqcn")
    res = spec.run()                   # on the card; device="cpu" for the CPU

A tuple policy declares a whole policy axis: ``build`` stacks it into one
product policy (``cc.stack_policies``) and ``run`` / ``SweepRunner``
simulate it as one batch (``grid_spec``), returning ``BatchResults``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

from repro_torch.core import topology as topo_mod
from repro_torch.core.cc import get_policy, stack_policies
from repro_torch.core.collectives import Schedule, get_collective, incast
from repro_torch.core.engine import EngineConfig, FabricParams
from repro_torch.core.topology import (NIC_BW, NIC_LAT, NVLINK_BW,
                                       NVLINK_LAT, SWITCH_BUF, Topology)

TOPOLOGIES: dict[str, Callable] = {}


def register_topology(name: str):
    """Register ``fn(spec: FabricSpec) -> Topology`` under ``name``."""
    def deco(fn):
        if name in TOPOLOGIES:
            raise ValueError(f"topology family {name!r} already registered")
        TOPOLOGIES[name] = fn
        return fn
    return deco


@dataclasses.dataclass(frozen=True)
class FabricSpec:
    """Declarative fabric.  ``n_spines=None`` derives the spine count from
    ``oversubscription``: full bisection gives every ToR one uplink per
    NIC downlink, oversubscription > 1 divides that."""
    family: str = "clos"
    n_racks: int = 2
    nodes_per_rack: int = 2
    gpus_per_node: int = 8
    n_spines: int | None = None
    oversubscription: float = 1.0
    nic_bw: float = NIC_BW
    nic_lat: float = NIC_LAT
    nv_bw: float = NVLINK_BW
    nv_lat: float = NVLINK_LAT
    buf: float = SWITCH_BUF

    @property
    def n_gpus(self) -> int:
        return self.n_racks * self.nodes_per_rack * self.gpus_per_node

    @property
    def spine_count(self) -> int:
        if self.n_spines is not None:
            return self.n_spines
        full = self.nodes_per_rack * self.gpus_per_node
        return max(1, round(full / self.oversubscription))

    def build(self) -> Topology:
        """Build (or fetch the cached) Topology for this spec."""
        topo = _TOPO_CACHE.get(self)
        if topo is None:
            try:
                builder = TOPOLOGIES[self.family]
            except KeyError:
                raise KeyError(f"unknown topology family {self.family!r}; "
                               f"registered: {sorted(TOPOLOGIES)}") from None
            topo = builder(self)
            while len(_TOPO_CACHE) >= _TOPO_CACHE_MAX:
                _TOPO_CACHE.pop(next(iter(_TOPO_CACHE)))
            _TOPO_CACHE[self] = topo
        return topo


_TOPO_CACHE: dict = {}
_TOPO_CACHE_MAX = 32
_SCHED_CACHE: dict = {}
_SCHED_CACHE_MAX = 64


@register_topology("clos")
def _build_clos(spec: FabricSpec) -> Topology:
    return topo_mod.clos(n_racks=spec.n_racks,
                         nodes_per_rack=spec.nodes_per_rack,
                         gpus_per_node=spec.gpus_per_node,
                         n_spines=spec.spine_count,
                         nic_bw=spec.nic_bw, nic_lat=spec.nic_lat,
                         nv_bw=spec.nv_bw, nv_lat=spec.nv_lat,
                         buf=spec.buf)


@register_topology("single")
def _build_single(spec: FabricSpec) -> Topology:
    return topo_mod.single_switch(spec.n_gpus, bw=spec.nic_bw,
                                  lat=spec.nic_lat, buf=spec.buf)


@dataclasses.dataclass(frozen=True)
class CollectiveSpec:
    """One collective from the registry over all (or selected) GPUs."""
    kind: str                      # name in collectives.COLLECTIVES
    total_bytes: float
    n_chunks: int = 4
    gpus: tuple | None = None      # None -> every fabric GPU

    def build_schedule(self, topo: Topology) -> Schedule:
        gpus = (list(self.gpus) if self.gpus is not None
                else list(range(topo.n_gpus)))
        return get_collective(self.kind)(topo, gpus, self.total_bytes,
                                         n_chunks=self.n_chunks)


@dataclasses.dataclass(frozen=True)
class IncastSpec:
    """N senders into one receiver."""
    n_senders: int
    size_each: float
    dst: int = 0

    def build_schedule(self, topo: Topology) -> Schedule:
        senders = [g for g in range(topo.n_gpus) if g != self.dst]
        if len(senders) < self.n_senders:
            raise ValueError(
                f"IncastSpec wants {self.n_senders} senders but the fabric "
                f"has only {len(senders)} GPUs besides dst={self.dst}")
        return incast(topo, senders[:self.n_senders], self.dst,
                      self.size_each)


@dataclasses.dataclass(frozen=True)
class ScenarioSpec:
    """One fully-specified simulation point.  ``policy`` is a registry name,
    a ``Policy``, or a tuple of either (a policy axis, run as one batch);
    ``cc_params``, ``fabric_params`` and ``fault_spec`` are per-run
    overrides; a faulty ``fault_spec`` runs the engine's faulty step."""
    fabric: object                 # FabricSpec | Topology
    workload: object               # has build_schedule(topo) -> Schedule
    policy: object = "pfc"         # str | Policy | tuple (policy axis)
    cc_params: dict | None = None
    fabric_params: FabricParams | None = None
    fault_spec: object | None = None
    name: str = ""

    def build(self):
        """-> (topo, sched, policy), with topology and schedule cached by
        value; a tuple policy builds the stacked product policy."""
        topo = (self.fabric if isinstance(self.fabric, Topology)
                else self.fabric.build())
        key = None
        if isinstance(self.fabric, FabricSpec):
            try:
                hash(self.workload)
                key = (self.fabric, self.workload)
            except TypeError:
                key = None
        sched = _SCHED_CACHE.get(key) if key is not None else None
        if sched is None:
            sched = self.workload.build_schedule(topo)
            if key is not None:
                while len(_SCHED_CACHE) >= _SCHED_CACHE_MAX:
                    _SCHED_CACHE.pop(next(iter(_SCHED_CACHE)))
                _SCHED_CACHE[key] = sched
        if isinstance(self.policy, (tuple, list)):
            pol = stack_policies(self.policy)
        elif isinstance(self.policy, str):
            pol = get_policy(self.policy)
        else:
            pol = self.policy
        return topo, sched, pol

    def run(self, runner=None, cfg: EngineConfig | None = None,
            device="cuda"):
        """Simulate this spec (convenience; prefer a shared SweepRunner).
        A tuple-policy spec runs its policy axis as one batch and returns
        ``BatchResults``."""
        from repro_torch.core.sweep import SweepRunner
        runner = runner or SweepRunner(cfg, device=device)
        if isinstance(self.policy, (tuple, list)):
            return runner.grid_spec(self, cfg=cfg)
        return runner.run_spec(self, cfg=cfg)


def scenario_matrix(fabrics, workloads, policies,
                    fabric_params=None, stacked=False,
                    fault_spec=None) -> list[ScenarioSpec]:
    """Cross-product helper: one spec per (fabric, workload, policy).
    ``stacked=True`` folds the policies into one policy-axis spec per
    (fabric, workload), which ``SweepRunner`` runs as one batch."""
    fabrics = [fabrics] if isinstance(fabrics, (FabricSpec, Topology)) \
        else list(fabrics)
    out = []
    for fab in fabrics:
        fname = (f"{fab.family}{fab.n_gpus}" if isinstance(fab, FabricSpec)
                 else fab.name)
        for wl in workloads:
            wname = getattr(wl, "kind", type(wl).__name__)
            if stacked:
                out.append(ScenarioSpec(
                    fabric=fab, workload=wl, policy=tuple(policies),
                    fabric_params=fabric_params, fault_spec=fault_spec,
                    name=f"{fname}_{wname}_stack"))
                continue
            for pol in policies:
                pname = pol if isinstance(pol, str) else pol.name
                out.append(ScenarioSpec(
                    fabric=fab, workload=wl, policy=pol,
                    fabric_params=fabric_params, fault_spec=fault_spec,
                    name=f"{fname}_{wname}_{pname}"))
    return out
