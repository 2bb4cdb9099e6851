"""End-to-end bridge: (architecture x mesh) collective schedule -> CLOS
fluid simulation under each CC policy (port of ``repro.core.predict``).

The collective mix is a list of ``hlo_comm.CollectiveOp`` (parsed from a
compiled dry run's HLO by ``hlo_comm.extract``); the mesh axes are mapped
onto the paper's CLOS fabric, and one training iteration's communication
is simulated under each CC policy on ``device`` (the card by default).

The HLO replay is a scenario workload (``HLOReplaySpec``): drivers build
``ScenarioSpec(fabric, HLOReplaySpec(...), policy)`` per policy and hand
the list to a shared ``SweepRunner``.

Mesh->fabric mapping: mesh devices are laid out row-major (pod, data,
model); chips are packed 8 per node.  A "model"-axis collective therefore
spans consecutive chips (mostly intra-node NVLink + intra-rack NICs) while
"data"/"pod"-axis collectives stride across nodes and racks.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core import cc as cc_mod
from repro_torch.core.collectives import (Schedule, ScheduleBuilder,
                                          _direct_phase)
from repro_torch.core.engine import EngineConfig
from repro_torch.core.hlo_comm import CollectiveOp
from repro_torch.core.scenario import FabricSpec, ScenarioSpec
from repro_torch.core.sweep import SweepRunner
from repro_torch.core.topology import Topology


@dataclasses.dataclass
class PredictReport:
    policy: str
    comm_time: float
    pauses: float
    finished: bool
    # the step budget (max_steps x max_extends) ran out before the last
    # flow finished: comm_time is a LOWER BOUND, not a measurement
    extend_exhausted: bool = False


def mesh_groups(mesh_shape: tuple[int, ...], axis: int,
                n_gpus: int) -> list[list[int]]:
    """Device groups for a collective over ``axis`` of the mesh, mapped to
    GPU ids (device i -> gpu i % n_gpus when the mesh is larger than the
    modeled fabric slice)."""
    n = int(np.prod(mesh_shape))
    ids = np.arange(n).reshape(mesh_shape)
    moved = np.moveaxis(ids, axis, -1).reshape(-1, mesh_shape[axis])
    return [[int(g) % n_gpus for g in row] for row in moved]


def schedule_from_ops(topo: Topology, ops: list[CollectiveOp],
                      mesh_shape: tuple[int, ...],
                      axis_of_op: list[int], n_chunks: int = 4) -> Schedule:
    """Build a flow schedule replaying ``ops`` (op k over mesh axis
    ``axis_of_op[k]``), chunked and chained like the workload layer does."""
    b = ScheduleBuilder(topo)
    prev = -1
    for k, op in enumerate(ops):
        groups = mesh_groups(mesh_shape, axis_of_op[k], topo.n_gpus)
        per_group_bytes = op.bytes_total * op.count / max(len(groups), 1)
        factor = {"all-reduce": 2.0, "all-gather": 1.0, "reduce-scatter": 1.0,
                  "all-to-all": 1.0, "collective-permute": 1.0}[op.kind]
        for c in range(n_chunks):
            g = b.new_group(f"op{k}_c{c}")
            for gi, members in enumerate(groups):
                m = sorted(set(members))
                if len(m) < 2:
                    continue
                P = len(m)
                pair_bytes = per_group_bytes * factor / n_chunks / P
                _direct_phase(b, m, pair_bytes, g, prev, 0.0,
                              salt=k * 65537 + c * 104729 + gi)
            prev = g
    return b.build()


@dataclasses.dataclass(frozen=True)
class HLOReplaySpec:
    """Scenario workload replaying a dry-run's collective mix."""
    ops: tuple                     # tuple[CollectiveOp, ...]
    mesh_shape: tuple
    axis_of_op: tuple
    n_chunks: int = 4

    def build_schedule(self, topo: Topology) -> Schedule:
        return schedule_from_ops(topo, list(self.ops), self.mesh_shape,
                                 list(self.axis_of_op), self.n_chunks)


def predict_policies(ops, mesh_shape, axis_of_op, policies=None,
                     topo: Topology | None = None,
                     cfg: EngineConfig | None = None,
                     runner: SweepRunner | None = None,
                     fabric: FabricSpec | None = None,
                     batched: bool | None = None,
                     device="cuda") -> list[PredictReport]:
    """One training iteration's collective mix under each CC policy.

    ``batched=True`` stacks the policies into one product policy and runs
    the whole comparison as one batch (``SweepRunner.run_policy_axis``, on
    the op path).  ``batched=False`` runs serially per policy (each run
    early-exits; on the card each runs on the kernel path).  The default
    (None) follows ``SweepRunner.policy_axis_pays_off``, the crossover
    table of the runner's device type.  Reports don't consume queue
    timelines, so recording is off; pass a shared ``runner`` (it then
    decides the device) to reuse prepared scenarios across calls."""
    # oversubscription=2.0 == the seed clos() default of 8 spines
    fab = fabric if fabric is not None else \
        (topo if topo is not None
         else FabricSpec(family="clos", n_racks=2, nodes_per_rack=2,
                         gpus_per_node=8, oversubscription=2.0))
    cfg = cfg or EngineConfig(dt=2e-6, max_steps=4000, max_extends=6,
                              queue_stride=0)
    runner = runner or SweepRunner(cfg, device=device)
    workload = HLOReplaySpec(tuple(ops), tuple(mesh_shape), tuple(axis_of_op))
    policies = tuple(policies or cc_mod.ALL_POLICIES)
    topo_b, sched, _ = ScenarioSpec(fabric=fab, workload=workload,
                                    policy=policies).build()
    if batched is None:
        batched = runner.policy_axis_pays_off()
    if batched:
        batch = runner.run_policy_axis(topo_b, sched, policies, cfg=cfg)
        return [PredictReport(batch.policy_of(i),
                              float(batch.completion_time[i]),
                              float(batch.pause_count[i].sum()),
                              bool(batch.finished[i]),
                              extend_exhausted=bool(
                                  batch.extend_exhausted[i]))
                for i in range(batch.n)]
    specs = [ScenarioSpec(fabric=fab, workload=workload, policy=p)
             for p in policies]
    return [PredictReport(res.meta["policy"], res.completion_time,
                          float(res.pause_count.sum()), res.finished,
                          extend_exhausted=res.extend_exhausted)
            for res in runner.run_specs(specs, cfg=cfg)]
