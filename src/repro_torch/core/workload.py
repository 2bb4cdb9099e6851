"""Workload layer: DLRM training iteration -> flow schedule with
compute/comm dependencies (port of ``repro/core/workload.py``).

The paper's DLRM iteration (Fig 10, §IV-D):
  fwd:  bottom-MLP compute  ||  embedding lookup -> All-To-All (fwd half)
        -> interaction + top-MLP compute
  bwd:  top-MLP backprop -> All-To-All (bwd half) || bottom-MLP backprop
        -> per-chunk All-Reduce of MLP grads (2D or 1D), overlapping bwd
  Totals per iteration: 109.5 MB All-Reduce + 8 MB All-To-All.

Compute segment durations are the reference's V100 profile constants (the
paper profiles NVIDIA V100s); the *exposed* communication =
iteration_time - total_compute is the reported metric.

One difference from the reference: the All-To-All's ECMP salt is
``zlib.crc32(tag)``, where the reference uses Python's ``hash(tag)``,
which changes from process to process (``PYTHONHASHSEED``) and with it
the flows' paths and the simulated results.  The port's schedule is the
same in every process.  Feeding the reference ``hash = crc32`` gives the
two packages the same schedule.

``simulate_dlrm_policies`` runs the policies one after another, or with
``batched=True`` as one batch over a policy axis.
"""
from __future__ import annotations

import dataclasses
import zlib

from repro_torch.core.collectives import (Schedule, ScheduleBuilder,
                                          _direct_phase)
from repro_torch.core.engine import EngineConfig, simulate
from repro_torch.core.scenario import ScenarioSpec
from repro_torch.core.topology import Topology


# V100-profile compute constants (s) for the paper's DLRM (Table II) with
# per-GPU batch ~256 (the reference's workload model).
@dataclasses.dataclass(frozen=True)
class DLRMComputeProfile:
    bot_mlp_fwd: float = 350e-6
    emb_lookup: float = 80e-6
    interact_top_fwd: float = 800e-6
    top_bwd: float = 1400e-6
    bot_bwd: float = 700e-6
    opt_update: float = 250e-6

    @property
    def total(self) -> float:
        return (self.bot_mlp_fwd + self.emb_lookup + self.interact_top_fwd
                + self.top_bwd + self.bot_bwd + self.opt_update)


@dataclasses.dataclass(frozen=True)
class DLRMCommSpec:
    allreduce_bytes: float = 109.5 * 1024 * 1024
    alltoall_fwd_bytes: float = 4 * 1024 * 1024
    alltoall_bwd_bytes: float = 4 * 1024 * 1024
    n_chunks: int = 4
    allreduce_algo: str = "2d"    # "1d" | "2d"


def build_dlrm_iteration(topo: Topology, gpus: list,
                         prof: DLRMComputeProfile = DLRMComputeProfile(),
                         comm: DLRMCommSpec = DLRMCommSpec()) -> Schedule:
    """One DLRM training iteration as a dependency-tagged flow schedule."""
    b = ScheduleBuilder(topo)

    # ---- forward ----------------------------------------------------------
    # embedding lookup finishes at emb_lookup; fwd A2A starts then
    g_emb = b.new_group("emb_done")
    b.add_marker(g_emb, dep=-1, delay=prof.emb_lookup)
    a2a_f = _add_a2a(b, gpus, comm.alltoall_fwd_bytes, comm.n_chunks,
                     dep=g_emb, tag="a2a_fwd")
    # bottom MLP fwd runs concurrently; top MLP needs both
    g_bot = b.new_group("bot_fwd_done")
    b.add_marker(g_bot, dep=-1, delay=prof.bot_mlp_fwd)
    g_top = b.new_group("top_fwd_done")
    b.add_marker(g_top, dep=a2a_f, delay=prof.interact_top_fwd)

    # ---- backward ---------------------------------------------------------
    g_topb = b.new_group("top_bwd_done")
    b.add_marker(g_topb, dep=g_top, delay=prof.top_bwd)
    _add_a2a(b, gpus, comm.alltoall_bwd_bytes, comm.n_chunks,
             dep=g_topb, tag="a2a_bwd")
    g_botb = b.new_group("bot_bwd_done")
    b.add_marker(g_botb, dep=g_topb, delay=prof.bot_bwd)

    # ---- gradient all-reduce (per chunk, overlapping bwd) ------------------
    if comm.allreduce_algo == "2d":
        _add_ar2d(b, topo, gpus, comm.allreduce_bytes, comm.n_chunks,
                  dep=g_topb)
    else:
        _add_ar1d(b, gpus, comm.allreduce_bytes, comm.n_chunks, dep=g_topb)
    return b.build()


def a2a_salt(tag: str) -> int:
    """The All-To-All's ECMP salt base for ``tag``: the same in every
    process (the reference's ``hash(tag)`` is not)."""
    return zlib.crc32(tag.encode())


def _add_a2a(b, gpus, total, n_chunks, dep, tag):
    P = len(gpus)
    per_pair = total / n_chunks / P
    prev = dep
    for c in range(n_chunks):
        g = b.new_group(f"{tag}_c{c}")
        _direct_phase(b, gpus, per_pair, g, prev, 0.0,
                      salt=a2a_salt(tag) % 65536 + c * 104729)
        prev = g
    # umbrella group: completion of the last chunk == collective done
    return prev


def _add_ar1d(b, gpus, total, n_chunks, dep):
    P = len(gpus)
    seg = total / n_chunks / P
    prev_rs = dep
    for c in range(n_chunks):
        rs = b.new_group(f"ar_c{c}_rs")
        _direct_phase(b, gpus, seg, rs, prev_rs, 0.0, salt=c * 7919)
        ag = b.new_group(f"ar_c{c}_ag")
        _direct_phase(b, gpus, seg, ag, rs, 0.0, salt=c * 7919 + 31)
        prev_rs = rs
    return ag


def _add_ar2d(b, topo, gpus, total, n_chunks, dep):
    gpn = topo.meta.get("gpus_per_node", 8)
    nodes: dict = {}
    for g in gpus:
        nodes.setdefault(g // gpn, []).append(g)
    node_list = sorted(nodes)
    n_nodes = len(node_list)
    chunk = total / n_chunks
    prev1 = dep
    last = None
    for c in range(n_chunks):
        g1 = b.new_group(f"ar_c{c}_rs_local")
        for node in node_list:
            _direct_phase(b, nodes[node], chunk / gpn, g1, prev1, 0.0,
                          salt=c * 7919 + node)
        g2 = b.new_group(f"ar_c{c}_rs_xnode")
        for r in range(gpn):
            members = [nodes[n][r] for n in node_list]
            _direct_phase(b, members, chunk / (gpn * n_nodes), g2, g1, 0.0,
                          salt=c * 7919 + 101 + r)
        g3 = b.new_group(f"ar_c{c}_ag_xnode")
        for r in range(gpn):
            members = [nodes[n][r] for n in node_list]
            _direct_phase(b, members, chunk / (gpn * n_nodes), g3, g2, 0.0,
                          salt=c * 7919 + 211 + r)
        g4 = b.new_group(f"ar_c{c}_ag_local")
        for node in node_list:
            _direct_phase(b, nodes[node], chunk / gpn, g4, g3, 0.0,
                          salt=c * 7919 + 307 + node)
        prev1 = g1
        last = g4
    return last


@dataclasses.dataclass(frozen=True)
class DLRMIterationSpec:
    """Scenario workload: one DLRM training iteration (compute markers +
    A2A halves + per-chunk gradient All-Reduce)."""
    prof: DLRMComputeProfile = DLRMComputeProfile()
    comm: DLRMCommSpec = DLRMCommSpec()
    gpus: tuple | None = None      # None -> every fabric GPU

    def build_schedule(self, topo: Topology) -> Schedule:
        gpus = (list(self.gpus) if self.gpus is not None
                else list(range(topo.n_gpus)))
        return build_dlrm_iteration(topo, gpus, self.prof, self.comm)


@dataclasses.dataclass
class IterationReport:
    iteration_time: float
    total_compute: float
    exposed_comm: float
    pfc_pauses: int
    policy: str
    finished: bool


def simulate_dlrm_policies(topo: Topology, gpus: list, policies=None,
                           prof: DLRMComputeProfile = DLRMComputeProfile(),
                           comm: DLRMCommSpec = DLRMCommSpec(),
                           cfg: EngineConfig = EngineConfig(dt=2e-6),
                           runner=None, batched: bool | None = None,
                           device="cuda") -> list[IterationReport]:
    """The Fig-10 per-policy loop: the same DLRM iteration under each CC
    policy.  ``batched=True`` runs the policies as one batch over a policy
    axis (``SweepRunner.run_policy_axis``, on the op path as in the
    reference); ``batched=False`` runs them one after another (on the
    card, each on the kernel path).  ``batched=None`` defers to
    ``SweepRunner.policy_axis_pays_off``, the crossover table of the
    runner's device type (same reports either way)."""
    from repro_torch.core import cc as cc_mod
    from repro_torch.core.sweep import SweepRunner
    runner = runner or SweepRunner(cfg, device=device)
    policies = tuple(policies or cc_mod.ALL_POLICIES)
    if batched is None:
        batched = runner.policy_axis_pays_off()
    if not batched:
        return [simulate_dlrm_iteration(
                    topo, gpus,
                    cc_mod.get_policy(p) if isinstance(p, str) else p,
                    prof, comm, cfg=cfg, runner=runner)
                for p in policies]
    sched = build_dlrm_iteration(topo, gpus, prof, comm)
    batch = runner.run_policy_axis(topo, sched, policies, cfg=cfg)
    out = []
    for i in range(batch.n):
        iter_time = float(batch.completion_time[i]) + prof.opt_update
        out.append(IterationReport(
            iteration_time=iter_time,
            total_compute=prof.total,
            exposed_comm=max(iter_time - prof.total, 0.0),
            pfc_pauses=int(batch.pause_count[i].sum()),
            policy=batch.policy_of(i),
            finished=bool(batch.finished[i]),
        ))
    return out


def simulate_dlrm_iteration(topo: Topology, gpus: list, policy,
                            prof: DLRMComputeProfile = DLRMComputeProfile(),
                            comm: DLRMCommSpec = DLRMCommSpec(),
                            cfg: EngineConfig = EngineConfig(dt=2e-6),
                            runner=None, device="cuda") -> IterationReport:
    """Pass a ``repro_torch.core.sweep.SweepRunner`` to reuse prepared
    scenarios across the per-policy / per-algo loops of Figs 10-11 (it
    then decides the device)."""
    spec = ScenarioSpec(fabric=topo, policy=policy,
                        workload=DLRMIterationSpec(prof, comm, tuple(gpus)))
    if runner is not None:
        res = runner.run_spec(spec, cfg=cfg)
    else:
        topo, sched, policy = spec.build()
        res = simulate(topo, sched, policy, cfg, device=device)
    # iteration ends when every flow (incl. compute markers) is done, plus
    # the optimizer update after the last gradient arrives
    iter_time = res.completion_time + prof.opt_update
    total_compute = prof.total
    return IterationReport(
        iteration_time=iter_time,
        total_compute=total_compute,
        exposed_comm=max(iter_time - total_compute, 0.0),
        pfc_pauses=int(res.pause_count.sum()),
        policy=policy.name,
        finished=res.finished,
    )
