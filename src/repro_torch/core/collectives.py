"""System layer: collective algorithms -> dependency-tagged flow schedules.

Mirrors ASTRA-Sim's system layer: each collective is decomposed into
send/recv *messages* (flows); hierarchical algorithms chain stages through
dependency groups; each collective is split into ``n_chunks`` equal chunks
processed in a pipeline (paper §III-D: 4 chunks).

A Schedule is plain numpy; the engine consumes it as static arrays.
This is the port's numpy-only copy of ``repro.core.collectives``.

All-reduce algorithms are registered in ``COLLECTIVES`` (the paper's
1D/2D/ring/a2a axis), so scenario specs and sweeps can enumerate them by
name: ``get_collective("ring")(topo, gpus, bytes)``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np

from repro_torch.core.topology import MAXHOP, Topology, route


# ---------------------------------------------------------------------------
# collective-algorithm registry (the paper's workload axis)
# ---------------------------------------------------------------------------

COLLECTIVES: dict[str, Callable] = {}


def register_collective(name: str, *aliases: str):
    """Register ``fn(topo, gpus, total_bytes, n_chunks=4) -> Schedule``."""
    def deco(fn):
        for n in (name,) + aliases:
            if n in COLLECTIVES:
                raise ValueError(f"collective {n!r} already registered")
            COLLECTIVES[n] = fn
        return fn
    return deco


def get_collective(name: str) -> Callable:
    try:
        return COLLECTIVES[name]
    except KeyError:
        raise KeyError(f"unknown collective {name!r}; registered: "
                       f"{sorted(COLLECTIVES)}") from None


@dataclasses.dataclass
class Schedule:
    """Flat flow schedule.  All sizes in bytes; times in seconds."""
    path: np.ndarray          # (F, MAXHOP) int32 link ids, -1 pad
    n_hops: np.ndarray        # (F,)
    size: np.ndarray          # (F,) bytes
    group: np.ndarray         # (F,) completion-group id
    dep: np.ndarray           # (F,) dep group id or -1
    delay: np.ndarray         # (F,) start delay after dep completion (s)
    n_groups: int
    group_names: list

    @property
    def n_flows(self) -> int:
        return len(self.size)

    def total_bytes(self) -> float:
        return float(self.size.sum())


class ScheduleBuilder:
    def __init__(self, topo: Topology):
        self.topo = topo
        self.rows: list = []          # (path, size, group, dep, delay)
        self.group_names: list = []

    def new_group(self, name: str) -> int:
        self.group_names.append(name)
        return len(self.group_names) - 1

    def add_flow(self, src: int, dst: int, size: float, group: int,
                 dep: int = -1, delay: float = 0.0, ecmp_salt: int = 0):
        key = (src * 131071 + dst * 8191 + ecmp_salt * 524287 + group) & 0x7FFFFFFF
        p = route(self.topo, src, dst, key)
        self.rows.append((p, size, group, dep, delay))

    def add_marker(self, group: int, dep: int = -1, delay: float = 0.0):
        """Zero-byte flow: pure time/dependency node (compute segments)."""
        self.rows.append(([-1], 0.0, group, dep, delay))

    def build(self) -> Schedule:
        F = len(self.rows)
        path = np.full((F, MAXHOP), -1, np.int32)
        n_hops = np.zeros(F, np.int32)
        size = np.zeros(F, np.float64)
        group = np.zeros(F, np.int32)
        dep = np.full(F, -1, np.int32)
        delay = np.zeros(F, np.float64)
        for i, (p, s, g, d, dl) in enumerate(self.rows):
            if p != [-1]:
                path[i, :len(p)] = p
                n_hops[i] = len(p)
            size[i] = s
            group[i] = g
            dep[i] = d
            delay[i] = dl
        # A flow may only depend on a strictly earlier group (-1 = none).
        # A dep on the flow's own group or a forward reference would stall
        # the simulation silently until max_steps; fail loudly instead.
        bad = np.nonzero(dep >= group)[0]
        if bad.size:
            f = int(bad[0])
            g, d = int(group[f]), int(dep[f])

            def gname(i):
                return (repr(self.group_names[i]) if i < len(self.group_names)
                        else f"<undefined group {i}>")

            kind = ("its own group" if d == g else
                    f"the later group {gname(d)}")
            raise ValueError(
                f"invalid dependency: flow {f} in group {g} ({gname(g)}) "
                f"depends on {kind} (dep={d}); dependencies must point to "
                "strictly earlier groups — this schedule would deadlock")
        return Schedule(path, n_hops, size, group, dep, delay,
                        n_groups=len(self.group_names),
                        group_names=self.group_names)


# ---------------------------------------------------------------------------
# collective algorithms
# ---------------------------------------------------------------------------

def incast(topo: Topology, senders: list, dst: int, size_each: float) -> Schedule:
    b = ScheduleBuilder(topo)
    g = b.new_group("incast")
    for s in senders:
        b.add_flow(s, dst, size_each, g, ecmp_salt=s)
    return b.build()


def _direct_phase(b: ScheduleBuilder, members, seg_bytes, group, dep, delay,
                  salt):
    """Direct (all-to-all-style) phase among ``members``: every member sends
    its segment to every other member simultaneously."""
    for i, u in enumerate(members):
        for j, v in enumerate(members):
            if u == v:
                continue
            b.add_flow(u, v, seg_bytes, group, dep, delay, ecmp_salt=salt + i * 1009 + j)


@register_collective("allreduce_1d", "1d")
def allreduce_1d(topo: Topology, gpus: list, total_bytes: float,
                 n_chunks: int = 4) -> Schedule:
    """Basic direct All-Reduce: RS then AG across all GPUs (paper "1D")."""
    b = ScheduleBuilder(topo)
    P = len(gpus)
    chunk = total_bytes / n_chunks
    seg = chunk / P
    for c in range(n_chunks):
        rs = b.new_group(f"c{c}_rs")
        dep_rs = -1 if c == 0 else rs - 2   # pipeline: chunk c RS after chunk c-1 RS
        _direct_phase(b, gpus, seg, rs, dep_rs, 0.0, salt=c * 7919)
        ag = b.new_group(f"c{c}_ag")
        _direct_phase(b, gpus, seg, ag, rs, 0.0, salt=c * 7919 + 31)
    return b.build()


@register_collective("allreduce_2d", "2d")
def allreduce_2d(topo: Topology, gpus: list, total_bytes: float,
                 n_chunks: int = 4) -> Schedule:
    """Hierarchical All-Reduce (paper "2D"): RS within each node over
    NVLink, RS across same-local-rank GPUs over NICs, then AG in reverse."""
    b = ScheduleBuilder(topo)
    gpn = topo.meta.get("gpus_per_node", 8)
    nodes: dict = {}
    for g in gpus:
        nodes.setdefault(g // gpn, []).append(g)
    node_list = sorted(nodes)
    n_nodes = len(node_list)
    P_local = gpn
    chunk = total_bytes / n_chunks
    # chunk pipelining: chunk c's first stage waits on chunk c-1's *first*
    # stage (same-stage pipeline), tracked explicitly — not on a hardcoded
    # group-id offset
    prev_stage1 = -1
    for c in range(n_chunks):
        g1 = b.new_group(f"c{c}_rs_local")
        dep1 = prev_stage1
        for node in node_list:
            _direct_phase(b, nodes[node], chunk / P_local, g1, dep1, 0.0,
                          salt=c * 7919 + node)
        g2 = b.new_group(f"c{c}_rs_xnode")
        for r in range(P_local):  # same local-rank groups across nodes
            members = [nodes[n][r] for n in node_list]
            _direct_phase(b, members, chunk / (P_local * n_nodes), g2, g1, 0.0,
                          salt=c * 7919 + 101 + r)
        g3 = b.new_group(f"c{c}_ag_xnode")
        for r in range(P_local):
            members = [nodes[n][r] for n in node_list]
            _direct_phase(b, members, chunk / (P_local * n_nodes), g3, g2, 0.0,
                          salt=c * 7919 + 211 + r)
        g4 = b.new_group(f"c{c}_ag_local")
        for node in node_list:
            _direct_phase(b, nodes[node], chunk / P_local, g4, g3, 0.0,
                          salt=c * 7919 + 307 + node)
        prev_stage1 = g1
    return b.build()


@register_collective("alltoall", "a2a")
def alltoall(topo: Topology, gpus: list, total_bytes: float,
             n_chunks: int = 4) -> Schedule:
    """Direct All-To-All: each GPU sends size/P to every other GPU."""
    b = ScheduleBuilder(topo)
    P = len(gpus)
    chunk = total_bytes / n_chunks
    per_pair = chunk / P
    for c in range(n_chunks):
        g = b.new_group(f"c{c}_a2a")
        dep = -1 if c == 0 else g - 1
        _direct_phase(b, gpus, per_pair, g, dep, 0.0, salt=c * 104729)
    return b.build()


def _ring_phase(b: ScheduleBuilder, rings: list, seg_of_ring: list, tag: str,
                dep: int, salt: int):
    """Parallel rings advancing in lockstep: step ``s`` is one group holding
    the i -> i+1 neighbor send of every ring (ring k sends
    ``seg_of_ring[k]`` bytes per step); step s+1 depends on step s.

    Returns ``(first_group, last_group)`` of the chain, or ``(dep, dep)``
    when every ring is trivial (fewer than 2 members)."""
    nsteps = max((len(r) for r in rings), default=0) - 1
    if nsteps < 1:
        return dep, dep
    first = None
    prev = dep
    for s in range(nsteps):
        g = b.new_group(f"{tag}_s{s}")
        for k, ring in enumerate(rings):
            if s >= len(ring) - 1:      # shorter rings finished earlier
                continue
            for i, u in enumerate(ring):
                v = ring[(i + 1) % len(ring)]
                b.add_flow(u, v, seg_of_ring[k], g, prev, 0.0,
                           ecmp_salt=salt + s * 1009 + k * 101 + i)
        if first is None:
            first = g
        prev = g
    return first, prev


@register_collective("allreduce_ring", "ring")
def allreduce_ring(topo: Topology, gpus: list, total_bytes: float,
                   n_chunks: int = 4) -> Schedule:
    """Topology-aware ring All-Reduce: members ordered by GPU id, so
    consecutive ring neighbors are intra-node (NVLink) wherever possible
    and only node-boundary hops cross the NIC fabric.  RS = P-1 neighbor
    steps of S/P each, AG = P-1 more; chunks pipeline on the RS chain."""
    b = ScheduleBuilder(topo)
    members = sorted(gpus)
    P = len(members)
    if P < 2:
        raise ValueError("ring all-reduce needs at least 2 GPUs")
    chunk = total_bytes / n_chunks
    prev_first = -1
    for c in range(n_chunks):
        rs_first, rs_last = _ring_phase(b, [members], [chunk / P],
                                        f"c{c}_rs", prev_first, salt=c * 7919)
        _ring_phase(b, [members], [chunk / P], f"c{c}_ag", rs_last,
                    salt=c * 7919 + 31)
        prev_first = rs_first
    return b.build()


@register_collective("allreduce_hring", "hring")
def allreduce_hring(topo: Topology, gpus: list, total_bytes: float,
                    n_chunks: int = 4) -> Schedule:
    """Hierarchical ring All-Reduce: ring RS inside each node (scale-up
    fabric), ring RS across nodes per local rank (NIC fabric), then the AG
    rings mirror in reverse — the ring counterpart of the paper's 2D
    algorithm, with each direct phase replaced by neighbor rings."""
    b = ScheduleBuilder(topo)
    gpn = topo.meta.get("gpus_per_node", 8)
    nodes: dict = {}
    for g in sorted(gpus):
        nodes.setdefault(g // gpn, []).append(g)
    node_list = sorted(nodes)
    n_nodes = len(node_list)
    local_rings = [nodes[n] for n in node_list]
    # cross-node segment sizing assumes every node holds the same number of
    # members (each rank's post-RS shard is chunk / P_local); uneven nodes
    # would silently mis-size the cross-node traffic
    sizes = {len(r) for r in local_rings}
    if len(sizes) > 1:
        raise ValueError(
            f"hierarchical ring needs equally-populated nodes; got member "
            f"counts {sorted(sizes)} across nodes {node_list}")
    P_local = sizes.pop()
    # cross-node rings: one per local rank, over every node
    xnode_rings = [[nodes[n][r] for n in node_list] for r in range(P_local)]
    chunk = total_bytes / n_chunks
    seg_local = [chunk / P_local] * len(local_rings)
    seg_x = [chunk / (P_local * n_nodes)] * len(xnode_rings)
    prev_first = -1
    for c in range(n_chunks):
        f1, l1 = _ring_phase(b, local_rings, seg_local, f"c{c}_rs_local",
                             prev_first, salt=c * 7919)
        _, l2 = _ring_phase(b, xnode_rings, seg_x, f"c{c}_rs_xnode", l1,
                            salt=c * 7919 + 101)
        _, l3 = _ring_phase(b, xnode_rings, seg_x, f"c{c}_ag_xnode", l2,
                            salt=c * 7919 + 211)
        _ring_phase(b, local_rings, seg_local, f"c{c}_ag_local", l3,
                    salt=c * 7919 + 307)
        prev_first = f1
    return b.build()


def collective_bytes_on_nics(sched: Schedule, topo: Topology) -> float:
    """Bytes crossing scale-out NICs (for 1D-vs-2D traffic checks)."""
    nic = set(int(x) for x in topo.up_link)
    on = np.isin(sched.path, list(nic)).any(axis=1)
    return float((sched.size * on).sum())
