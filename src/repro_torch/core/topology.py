"""Network topologies: single-switch star and the paper's two-level CLOS
(Fig 2: 8 GPUs + NVSwitch scale-up per node, 2 nodes/rack, dedicated NIC
per GPU to the ToR, full-bisection spine layer).

Everything is flat numpy arrays over *directed links*; devices exist only
as PFC domains and metric groups.  Table I parameters are the defaults.

A numpy-only copy of ``repro.core.topology``: the port keeps its own so
that it never imports the JAX package (whose ``core/__init__`` imports
jax).  Arrays are identical to the reference's (``tests/test_torch_fabric``).
"""
from __future__ import annotations

import dataclasses

import numpy as np

GB = 1024 ** 3
MB = 1024 ** 2
KB = 1024.0

# Table I defaults
NIC_BW = 200e9 / 8            # 200 Gbps -> bytes/s
NIC_LAT = 500e-9
NVLINK_BW = 200 * 1e9         # 200 GBps (total, scale-up)
NVLINK_LAT = 25e-9
SWITCH_BUF = 32 * MB

# Canonical fabric-link classes.  Every directed link belongs to exactly
# one class; ``FabricParams`` (engine layer) may carry per-class arrays of
# ECN/PFC knobs indexed by these ids, so tuning e.g. spine-downlink ECN
# separately from ToR downlinks is one array entry, not a new topology.
LINK_CLASSES = ("nvlink", "host_nic", "tor_down", "tor_up", "spine_down")
N_LINK_CLASSES = len(LINK_CLASSES)
LINK_CLASS_ID = {n: i for i, n in enumerate(LINK_CLASSES)}


@dataclasses.dataclass
class Topology:
    name: str
    n_devices: int
    # per directed link
    cap: np.ndarray            # bytes/s
    lat: np.ndarray            # s
    src_dev: np.ndarray        # device owning the egress queue
    dst_dev: np.ndarray        # device whose ingress port this link feeds
    ecn_on: np.ndarray         # bool: switch egress queues mark ECN
    fabric: np.ndarray         # bool: RoCE fabric link (PFC-capable port)
    link_class: np.ndarray     # int32 index into LINK_CLASSES
    # devices
    dev_is_switch: np.ndarray  # bool (PFC domain + metric group)
    dev_buf: np.ndarray        # bytes (PFC threshold base)
    dev_name: list
    # host routing helpers
    n_gpus: int
    up_link: np.ndarray        # gpu -> host->first-switch link id
    meta: dict

    @property
    def n_links(self) -> int:
        return len(self.cap)

    def gpu_dev(self, g: int) -> int:
        return g


class _Builder:
    def __init__(self, name):
        self.name = name
        self.cap, self.lat, self.src, self.dst, self.ecn = [], [], [], [], []
        self.fabric = []
        self.link_class = []
        self.dev_is_switch, self.dev_buf, self.dev_name = [], [], []

    def add_dev(self, name, is_switch, buf=SWITCH_BUF) -> int:
        self.dev_name.append(name)
        self.dev_is_switch.append(is_switch)
        self.dev_buf.append(buf if is_switch else 1e18)
        return len(self.dev_name) - 1

    def add_link(self, u, v, cap, lat, ecn, fabric=True,
                 cls="host_nic") -> int:
        self.cap.append(cap)
        self.lat.append(lat)
        self.src.append(u)
        self.dst.append(v)
        self.ecn.append(ecn)
        self.fabric.append(fabric)
        self.link_class.append(LINK_CLASS_ID[cls])
        return len(self.cap) - 1

    def build(self, n_gpus, up_link, meta) -> Topology:
        return Topology(
            name=self.name,
            n_devices=len(self.dev_name),
            cap=np.asarray(self.cap, np.float64),
            lat=np.asarray(self.lat, np.float64),
            src_dev=np.asarray(self.src, np.int32),
            dst_dev=np.asarray(self.dst, np.int32),
            ecn_on=np.asarray(self.ecn, bool),
            fabric=np.asarray(self.fabric, bool),
            link_class=np.asarray(self.link_class, np.int32),
            dev_is_switch=np.asarray(self.dev_is_switch, bool),
            dev_buf=np.asarray(self.dev_buf, np.float64),
            dev_name=self.dev_name,
            n_gpus=n_gpus,
            up_link=np.asarray(up_link, np.int32),
            meta=meta,
        )


def single_switch(n_gpus: int = 8, bw: float = NIC_BW, lat: float = NIC_LAT,
                  buf: float = SWITCH_BUF) -> Topology:
    """n GPUs on one switch (the paper's incast / §IV-B microbenchmarks)."""
    b = _Builder(f"single_switch_{n_gpus}")
    for g in range(n_gpus):
        b.add_dev(f"gpu{g}", False)
    sw = b.add_dev("sw0", True, buf)
    up, down = [], []
    for g in range(n_gpus):
        up.append(b.add_link(g, sw, bw, lat, ecn=False))   # host NIC egress
    for g in range(n_gpus):
        down.append(b.add_link(sw, g, bw, lat, ecn=True,
                               cls="tor_down"))            # switch egress
    meta = {"down_link": np.asarray(down, np.int32), "kind": "single",
            "switches": [sw]}
    return b.build(n_gpus, up, meta)


def clos(n_racks: int = 8, nodes_per_rack: int = 2, gpus_per_node: int = 8,
         n_spines: int = 8, nic_bw: float = NIC_BW, nic_lat: float = NIC_LAT,
         nv_bw: float = NVLINK_BW, nv_lat: float = NVLINK_LAT,
         buf: float = SWITCH_BUF) -> Topology:
    """The paper's two-level CLOS (Fig 2).  Defaults = 128 GPUs / 8 racks."""
    n_nodes = n_racks * nodes_per_rack
    n_gpus = n_nodes * gpus_per_node
    b = _Builder(f"clos_{n_gpus}")
    for g in range(n_gpus):
        b.add_dev(f"gpu{g}", False)
    nvsw = [b.add_dev(f"nvsw{n}", True, 16 * SWITCH_BUF) for n in range(n_nodes)]
    tors = [b.add_dev(f"tor{r}", True, buf) for r in range(n_racks)]
    spines = [b.add_dev(f"spine{s}", True, buf) for s in range(n_spines)]

    up = np.zeros(n_gpus, np.int32)
    nv_up = np.zeros(n_gpus, np.int32)
    nv_down = np.zeros(n_gpus, np.int32)
    tor_down = np.zeros(n_gpus, np.int32)
    for g in range(n_gpus):
        node = g // gpus_per_node
        rack = node // nodes_per_rack
        # scale-up (proprietary lossless fabric: credit-based, not PFC)
        nv_up[g] = b.add_link(g, nvsw[node], nv_bw, nv_lat, ecn=False,
                              fabric=False, cls="nvlink")
        nv_down[g] = b.add_link(nvsw[node], g, nv_bw, nv_lat, ecn=False,
                                fabric=False, cls="nvlink")
        # scale-out
        up[g] = b.add_link(g, tors[rack], nic_bw, nic_lat, ecn=False)
        tor_down[g] = b.add_link(tors[rack], g, nic_bw, nic_lat, ecn=True,
                                 cls="tor_down")
    tor_up = np.zeros((n_racks, n_spines), np.int32)
    spine_down = np.zeros((n_spines, n_racks), np.int32)
    for r in range(n_racks):
        for s in range(n_spines):
            tor_up[r, s] = b.add_link(tors[r], spines[s], nic_bw, nic_lat,
                                      ecn=True, cls="tor_up")
            spine_down[s, r] = b.add_link(spines[s], tors[r], nic_bw, nic_lat,
                                          ecn=True, cls="spine_down")

    meta = {
        "kind": "clos",
        "gpus_per_node": gpus_per_node,
        "nodes_per_rack": nodes_per_rack,
        "n_racks": n_racks,
        "n_spines": n_spines,
        "nv_up": nv_up, "nv_down": nv_down,
        "tor_down": tor_down, "tor_up": tor_up, "spine_down": spine_down,
        "tor_devs": np.asarray(tors, np.int32),
        "spine_devs": np.asarray(spines, np.int32),
        "switches": tors + spines,
    }
    return b.build(n_gpus, up, meta)


MAXHOP = 4


def route(topo: Topology, src: int, dst: int, ecmp_key: int) -> list[int]:
    """Directed link path src GPU -> dst GPU."""
    m = topo.meta
    if m["kind"] == "single":
        return [int(topo.up_link[src]), int(m["down_link"][dst])]
    gpn = m["gpus_per_node"]
    npr = m["nodes_per_rack"]
    s_node, d_node = src // gpn, dst // gpn
    s_rack, d_rack = s_node // npr, d_node // npr
    if s_node == d_node:
        return [int(m["nv_up"][src]), int(m["nv_down"][dst])]
    if s_rack == d_rack:
        return [int(topo.up_link[src]), int(m["tor_down"][dst])]
    spine = _ecmp_hash(ecmp_key) % m["n_spines"]
    return [int(topo.up_link[src]), int(m["tor_up"][s_rack, spine]),
            int(m["spine_down"][spine, d_rack]), int(m["tor_down"][dst])]


def _ecmp_hash(x: int) -> int:
    # deterministic avalanche mix (splitmix-ish) — per-flow ECMP
    x = (x ^ 61) ^ (x >> 16)
    x = (x + (x << 3)) & 0xFFFFFFFF
    x = x ^ (x >> 4)
    x = (x * 0x27D4EB2D) & 0xFFFFFFFF
    return (x ^ (x >> 15)) & 0x7FFFFFFF
