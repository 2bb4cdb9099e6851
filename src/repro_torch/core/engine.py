"""Network layer: fixed-timestep, vectorized fluid-flow simulator in
PyTorch (port of ``repro.core.engine``).

Per step Δt:
  1. delayed signals (ECN fraction, RTT, HPCC INT utilisation) read from a
     per-link history ring at t - base_rtt(flow)
  2. CC policy update -> per-flow rate / window
  3. paced, window-gated injection into the source NIC egress queue
  4. PFC gates: paused ports transmit nothing
  5. hop-ordered fluid forwarding with per-link capacity accounting and
     proportional backlog drain
  6. per-link and per-ingress-port queues
  7. PFC per-port X_OFF/X_ON hysteresis; PAUSE frames are counted
  8. completion, per flow and per dependency group
  9. history ring + soft cost integrand
 10. run-health observers: pause storm, pause-cycle deadlock, non-finite
     freeze

Two step implementations, as in the reference (``step_impl``):

* ``"torch"`` — the op path: plain PyTorch operations, on the CPU or the
  card.  It is the reference's jnp step, operation for operation.
* ``"cuda"`` — stages 1+2 run in the fused CUDA kernel and every
  reduction whose plan is ``"gather"`` (fan-in <= 64) runs in the segment
  kernels (``repro_torch.kernels.engine_step``); the PFC hysteresis fuses
  into the per-port reduction where that plan is ``"gather"``.  Reductions
  whose plan is ``"gather2"`` stay on the op path, exactly as the
  reference's Pallas path leaves them to jnp.

``"auto"`` resolves to ``"cuda"`` on a CUDA device and to ``"torch"`` on
the CPU; ``"cuda"`` on the CPU raises.

Lanes: every carry tensor has a leading lane axis ``B``, the explicit
form of the reference's ``vmap``.  ``Simulator.run`` is one lane;
``SweepRunner.run_batch`` steps B lanes of per-lane CC params and fabric
knobs (and, on a policy axis, per-lane policies) in one loop, each kernel
launch covering all B lanes.

Early exit: a run integrates at most ``max_steps * (max_extends + 1)``
steps in chunks of ``chunk_steps``.  A lane's step is a no-op once every
flow is done or the lane diverged (a per-step host read of those flags;
such a lane is frozen bit for bit while the others step), and the run
stops at the first chunk boundary after every lane has halted, so results
never depend on ``chunk_steps`` and ``meta["steps_run"]`` is the
reference's chunk-rounded count.

Faults (``core.faults.FaultSpec``): a spec that injects any fault
(``is_faulty``) runs the reference's faulty step — per-hop loss on fabric
links with IRN or go-back-N recovery and a per-flow loss signal (carry
``lost``, ``dup``, ``loss_sig``), degradation windows and link flaps on
fabric links, scaled ECN marking and ``pfc_on``-gated pausing — on both
step paths; the default spec runs the lossless step unchanged, so every
lossless result is bit for bit what it was.  Fault leaves are scalars or
per-link-class arrays for one lane, stacked on a leading lane axis for B.

Gradients (``Simulator.soft_cost_fn``): the soft cost, the integral of
the undelivered fraction, is differentiable through autograd w.r.t. the
CC params and the fabric knobs, on the op path only (the reference's
kernels have no VJP either).  It runs the fixed-length loop: under
autograd the step writes its carry out of place, and ``remat`` re-runs
``chunk_steps``-step segments in the backward pass (``_RematSoft``)
instead of keeping every step's activations.  Where the reference
writes ``jnp.maximum``/``jnp.minimum``/``jnp.clip`` the port takes
``torch.maximum``/``torch.minimum`` against a tensor bound
(``cc.bound``), whose gradient at a tie is split evenly, as JAX's is.
"""
from __future__ import annotations

import copy
import dataclasses
import warnings

import numpy as np
import torch

from repro_torch.core.arith import (_grad_wanted, fma, rdiv, row_prod,
                                    row_sum)
from repro_torch.core.cc import (FlowCtx, ParamSpec, Policy, Signals, _clip,
                                 _max, _min, kernel_state_keys, pack_params)
from repro_torch.core.collectives import Schedule
from repro_torch.core.faults import (FaultSpec, LaneStatus, _as_fault,
                                     classify_lane, is_faulty)
from repro_torch.core.topology import (LINK_CLASS_ID, MAXHOP,
                                       N_LINK_CLASSES, Topology)
from repro_torch.kernels.engine_step import ops as es_ops


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    dt: float = 1e-6
    max_steps: int = 20_000
    max_extends: int = 4          # extra step budget: total = max_steps*(1+extends)
    hist: int = 512               # feedback delay ring cap (steps)
    # ECN / PFC defaults: these only seed the default FabricParams
    kmin: float = 400e3
    kmax: float = 1600e3
    pmax: float = 0.2
    xoff: float = 1e6
    xon: float = 0.8e6
    t_base_util: float = 10e-6    # HPCC qlen->util horizon
    eps_done: float = 512.0       # completion slack (bytes)
    pause_resend: float = 5e-6    # PAUSE frame refresh while a port is paused
    # knobs that do not change simulated physics
    chunk_steps: int = 256        # early-exit check granularity
    queue_stride: int = 1         # record dev_queue every k steps; 0 = off
    step_impl: str = "auto"       # "auto" | "torch" | "cuda"
    deadlock_check_every: int = 64   # pause-cycle check cadence (steps)
    storm_frac: float = 0.5          # pause storm: fraction of ports paused
    storm_steps: int = 50            # ... for this many consecutive steps


_FABRIC_DEFAULTS = dict(kmin=400e3, kmax=1600e3, pmax=0.2, xoff=1e6, xon=0.8e6)

# search spaces of the fabric knobs, in the CC policies' ParamSpec
# currency: ``autotune`` reads their scales and bounds
FABRIC_PARAM_SPECS = {
    "kmin": ParamSpec(_FABRIC_DEFAULTS["kmin"], lo=1e3, hi=64e6, scale="log"),
    "kmax": ParamSpec(_FABRIC_DEFAULTS["kmax"], lo=4e3, hi=256e6, scale="log"),
    "pmax": ParamSpec(_FABRIC_DEFAULTS["pmax"], lo=0.01, hi=1.0,
                      scale="linear"),
    "xoff": ParamSpec(_FABRIC_DEFAULTS["xoff"], lo=10e3, hi=64e6,
                      scale="log"),
    "xon": ParamSpec(_FABRIC_DEFAULTS["xon"], lo=10e3, hi=64e6, scale="log"),
}

@dataclasses.dataclass(frozen=True)
class FabricParams:
    """Fabric tuning knobs: each leaf is a scalar (uniform fabric) or a
    per-link-class array of shape ``(N_LINK_CLASSES,)`` indexed by
    ``topology.LINK_CLASSES``."""
    kmin: object = _FABRIC_DEFAULTS["kmin"]   # ECN marking ramp start (bytes)
    kmax: object = _FABRIC_DEFAULTS["kmax"]   # ECN marking ramp end (bytes)
    pmax: object = _FABRIC_DEFAULTS["pmax"]   # max marking probability
    xoff: object = _FABRIC_DEFAULTS["xoff"]   # PFC pause threshold (bytes)
    xon: object = _FABRIC_DEFAULTS["xon"]     # PFC resume threshold (bytes)

    FIELDS = ("kmin", "kmax", "pmax", "xoff", "xon")

    @classmethod
    def from_config(cls, cfg: EngineConfig) -> "FabricParams":
        return cls(kmin=cfg.kmin, kmax=cfg.kmax, pmax=cfg.pmax,
                   xoff=cfg.xoff, xon=cfg.xon)

    @classmethod
    def check_fields(cls, keys):
        """Reject names that are not FabricParams fields."""
        unknown = set(keys) - set(cls.FIELDS)
        if unknown:
            raise ValueError(f"unknown fabric params {sorted(unknown)}; "
                             f"known: {list(cls.FIELDS)}")

    def replace(self, **kw) -> "FabricParams":
        return dataclasses.replace(self, **kw)

    def with_class(self, **field_overrides) -> "FabricParams":
        """``fab.with_class(kmin={"spine_down": 100e3})``: expand a field
        to a per-class array with the named classes replaced."""
        out = {}
        for field, overrides in field_overrides.items():
            base = np.broadcast_to(
                np.asarray(getattr(self, field), np.float32),
                (N_LINK_CLASSES,)).copy()
            for cls_name, v in overrides.items():
                base[LINK_CLASS_ID[cls_name]] = v
            out[field] = base
        return dataclasses.replace(self, **out)


def _as_fabric(fabric_params, cfg: EngineConfig) -> FabricParams:
    return (FabricParams.from_config(cfg) if fabric_params is None
            else fabric_params)


def resolve_device(device) -> torch.device:
    """The device a simulation runs on; a CUDA device must exist (no
    silent CPU run)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: the engine runs on the "
                           "card by default; pass device='cpu' to run the "
                           "op path on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def _canonical(device: torch.device) -> torch.device:
    """``device`` with the index a bare ``"cuda"`` stands for (the current
    device), so that two names of one card compare equal."""
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(device.type) if device.type == "cpu" else device


def resolve_step_impl(cfg: EngineConfig, device) -> str:
    """``"auto"`` -> ``"cuda"`` on a CUDA device, ``"torch"`` on the CPU;
    ``"cuda"`` on a CPU device raises."""
    impl = cfg.step_impl
    dev = torch.device(device)
    if impl == "auto":
        return "cuda" if dev.type == "cuda" else "torch"
    if impl not in ("torch", "cuda"):
        raise ValueError(f"step_impl must be 'auto', 'torch' or 'cuda', "
                         f"got {impl!r}")
    if impl == "cuda" and dev.type != "cuda":
        raise ValueError("step_impl='cuda' runs the CUDA kernels and needs "
                         f"a CUDA device, got {dev}")
    return impl


def _cfg_static(cfg: EngineConfig, device) -> EngineConfig:
    """The identity of a config's step on ``device``: fabric scalars arrive
    per run (``FabricParams``), so they are normalized out; ``step_impl``
    is resolved, so "auto" names the step path it runs on."""
    return dataclasses.replace(cfg, step_impl=resolve_step_impl(cfg, device),
                               **_FABRIC_DEFAULTS)


@dataclasses.dataclass
class Results:
    finished: bool
    completion_time: float        # max flow finish (s)
    t_finish: np.ndarray          # (F,)
    group_time: np.ndarray        # (G,)
    group_names: list
    pause_count: np.ndarray       # (D,) PFC pause frames per device
    dev_queue: np.ndarray         # (T//queue_stride, D) queue-bytes timeline
    dt: float
    delivered: np.ndarray
    soft_cost: float
    meta: dict
    deadlocked: bool = False      # a PFC pause-graph cycle was detected
    deadlock_step: int = -1       # first step the cycle was seen (-1 = never)
    storm_step: int = -1          # first step a pause storm was sustained
    diverged: bool = False        # non-finite state; lane frozen at detection
    extend_exhausted: bool = False  # step budget ran out before completion
    lost: np.ndarray | None = None  # (F,) bytes dropped in-network (faulty)

    @property
    def status(self) -> LaneStatus:
        return classify_lane(self.diverged, self.deadlocked, self.finished)


# ---------------------------------------------------------------------------
# static gather plans (scatter-free segment reductions)
# ---------------------------------------------------------------------------

def _next_pow2(n: int) -> int:
    return 1 << max(int(n) - 1, 0).bit_length() if n > 1 else 1


# single-level padded-gather width cap: wider segments use the two-level
# split-row plan
_SPLIT_C = 64


def _padded_rows(kept_ids, kept_pos, counts, n_out, n_in, width):
    """(n_out, width) index matrix; slot ``n_in`` means "+0"."""
    idx = np.full((n_out, width), n_in, np.int64)
    order = np.argsort(kept_ids, kind="stable")
    sid = kept_ids[order]
    starts = np.concatenate([[0], np.cumsum(counts)])
    slot = np.arange(len(sid)) - starts[sid]
    idx[sid, slot] = kept_pos[order]
    return idx


def _reduce_plan(ids: np.ndarray, n_in: int, n_out: int,
                 drop: np.ndarray | None = None):
    """Static plan for ``out[s] = sum(vals[ids == s])``, entries with
    ``drop`` excluded.  Returns ``(numpy arrays, strategy)``:

      empty    no live entries — the reduction is identically zero
      gather   (n_out, C) padded gather + row sum, C = max segment size
      gather2  split-row: segments padded to multiples of _SPLIT_C, one
               flat gather + block sum, then a second padded gather over
               the per-block partial sums; ``boff`` (the first block of
               each segment, and the block count at the end) is the
               segment kernels' form of ``bidx``
    """
    ids = np.asarray(ids, np.int64).reshape(-1)
    keep = (np.ones(ids.shape, bool) if drop is None
            else ~np.asarray(drop).reshape(-1))
    kept_ids = ids[keep]
    kept_pos = np.nonzero(keep)[0]
    if kept_ids.size == 0:
        return {}, ("empty", n_out)
    counts = np.bincount(kept_ids, minlength=n_out)
    C = _next_pow2(int(counts.max()))
    if C <= _SPLIT_C:
        idx = _padded_rows(kept_ids, kept_pos, counts, n_out, n_in, C)
        return {"idx": idx.reshape(-1)}, ("gather", n_out, C)
    nblk = -(-counts // _SPLIT_C)
    blk_start = np.concatenate([[0], np.cumsum(nblk)])
    n_blocks = int(blk_start[-1])
    perm = np.full(n_blocks * _SPLIT_C, n_in, np.int64)
    order = np.argsort(kept_ids, kind="stable")
    starts = np.concatenate([[0], np.cumsum(counts)])
    for s in np.nonzero(counts)[0]:
        lo = blk_start[s] * _SPLIT_C
        perm[lo:lo + counts[s]] = kept_pos[order[starts[s]:starts[s] + counts[s]]]
    C2 = _next_pow2(int(nblk.max()))
    bidx = np.full((n_out, C2), n_blocks, np.int64)
    for s in np.nonzero(nblk)[0]:
        bidx[s, :nblk[s]] = np.arange(blk_start[s], blk_start[s + 1])
    return {"perm": perm, "bidx": bidx.reshape(-1), "boff": blk_start}, \
        ("gather2", n_out, n_blocks, C2)


def _plan_tensors(arrs: dict, device) -> dict:
    """Plan index arrays on the device: int64 for the op path's indexing,
    plus the int32 copies the segment kernels take (``idx32``; ``perm32``
    and ``boff32``, and the split-row CTA table ``ctas32``)."""
    out = {k: torch.as_tensor(v, dtype=torch.int64, device=device)
           for k, v in arrs.items()}

    for k in ("idx", "perm", "boff"):
        if k in arrs:
            out[k + "32"] = torch.as_tensor(arrs[k], dtype=torch.int32,
                                            device=device)
    if "boff" in arrs:
        C2 = len(arrs["bidx"]) // (len(arrs["boff"]) - 1)
        out["ctas32"] = torch.as_tensor(es_ops.split_ctas(arrs["boff"], C2),
                                        device=device)
    return out


def _inverse(arrs: dict, key: str, n_in: int) -> tuple:
    """Where each of the ``n_in`` inputs sits in plan array ``key`` (a
    plan holds an input at most once; slot ``n_in`` is the fill):
    ``(position, present)`` tensors, made at first use and kept in
    ``arrs``."""
    name = f"{key}_inv{n_in}"
    if name not in arrs:
        idx = arrs[key].cpu().numpy()
        pos = np.full(n_in, -1, np.int64)
        live = idx < n_in
        pos[idx[live]] = np.nonzero(live)[0]
        dev = arrs[key].device
        arrs[name] = (torch.as_tensor(np.maximum(pos, 0), device=dev),
                      torch.as_tensor(pos >= 0, device=dev))
    return arrs[name]


class _PlanGather(torch.autograd.Function):
    """``_zero_ext(vals)[..., idx]`` whose backward gathers through the
    plan's inverse map (a plan holds each input at most once) instead of
    scatter-adding into the fill slot's thousands of duplicates."""

    @staticmethod
    def forward(ctx, vals, idx, inv, has):
        ctx.save_for_backward(inv, has)
        return _zero_ext(vals)[..., idx]

    @staticmethod
    def backward(ctx, g):
        inv, has = ctx.saved_tensors
        return torch.where(has, g[..., inv], 0.0), None, None, None


class _GatherCols(torch.autograd.Function):
    """``x[:, idx]`` for a ``(B, n)`` ``x`` whose backward adds the
    gradient back with ``index_add_``.  Autograd's own backward of an
    index with repeats (every flow of a link reads that link) sorts the
    indices and sums each run of repeats serially: at 128 GPUs, 88% of
    the backward's device time (PERF.md §6).  ``index_add_`` is
    deterministic on the CPU; on the card it adds with atomics, so the
    last bits of a gradient may differ between runs."""

    @staticmethod
    def forward(ctx, x, idx):
        ctx.save_for_backward(idx)
        ctx.n = x.shape[-1]
        return x[:, idx]

    @staticmethod
    def backward(ctx, g):
        idx, = ctx.saved_tensors
        B = g.shape[0]
        out = g.new_zeros((B, ctx.n))
        return out.index_add_(1, idx.reshape(-1), g.reshape(B, -1)), None


def _gather_cols(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[:, idx]``; under autograd through ``_GatherCols``."""
    if _grad_wanted(x):
        return _GatherCols.apply(x, idx)
    return x[:, idx]


def _take(vals: torch.Tensor, arrs: dict, key: str) -> torch.Tensor:
    """The gather of plan array ``key`` over ``vals`` and its fill slot."""
    if _grad_wanted(vals):
        return _PlanGather.apply(vals, arrs[key],
                                 *_inverse(arrs, key, vals.shape[-1]))
    return _zero_ext(vals)[..., arrs[key]]


def _zero_ext(vals: torch.Tensor) -> torch.Tensor:
    """``vals`` with one appended zero on its last axis: the OOB-fill slot
    of a plan."""
    return torch.cat([vals, vals.new_zeros(vals.shape[:-1] + (1,))], dim=-1)


def _reduce(strategy, arrs, vals):
    """Apply a ``_reduce_plan`` on the op path: (..., n_in) -> (...,
    n_out), any leading (lane) axes."""
    kind = strategy[0]
    lead = tuple(vals.shape[:-1])
    if kind == "empty":
        return vals.new_zeros(lead + (strategy[1],))
    if kind == "gather":
        _, n_out, C = strategy
        return row_sum(_take(vals, arrs, "idx").reshape(lead + (n_out, C)))
    _, n_out, n_blocks, C2 = strategy
    bsum = row_sum(_take(vals, arrs, "perm")
                   .reshape(lead + (n_blocks, _SPLIT_C)))
    return row_sum(_take(bsum, arrs, "bidx").reshape(lead + (n_out, C2)),
                   lanes=True)


def _kernel_plan(strategy, arrs) -> tuple:
    """A non-empty plan as the segment kernels' arguments ``(idx, n_out,
    C, boff, C2, ctas)`` (``kernels.engine_step.ops.segment_reduce``)."""
    if strategy[0] == "gather":
        return arrs["idx32"], strategy[1], strategy[2], None, 1, None
    _, n_out, _, C2 = strategy
    return (arrs["perm32"], n_out, _SPLIT_C, arrs["boff32"], C2,
            arrs["ctas32"])


def _lane_sum_plan(plan: "_Plan", device) -> tuple:
    """``(strategy, plan tensors)`` of a lane's sum over its real flows in
    an order fixed by the row: consecutive flows in segments of at most
    ``MAX_C2`` blocks (one segment up to 262,144 flows), whose sums
    ``_lane_sum`` adds left to right."""
    Fp = plan.n_flows_pad
    per = es_ops.MAX_C2 * _SPLIT_C
    arrs, strategy = _reduce_plan(np.arange(Fp) // per, Fp,
                                  max(1, -(-plan.n_flows // per)),
                                  drop=np.arange(Fp) >= plan.n_flows)
    return strategy, _plan_tensors(arrs, device)


def _lane_sum(reduce_, lane_plan: tuple, vals):
    """(B,) sums of ``vals`` (B, Fp) over the real flows, through
    ``_lane_sum_plan``'s plan."""
    parts = reduce_(*lane_plan, vals)
    out = parts[:, 0]
    for j in range(1, parts.shape[1]):
        out = out + parts[:, j]
    return out


def _reduce_kernel(strategy, arrs, vals):
    """Kernel-path reduction of ``(B, n_in)`` lanes: every non-empty plan,
    "gather" and split-row "gather2" alike, is one segment-kernel launch;
    an empty plan is zeros."""
    if strategy[0] == "empty":
        return _reduce(strategy, arrs, vals)
    return es_ops.segment_reduce(vals, *_kernel_plan(strategy, arrs))


@dataclasses.dataclass(frozen=True)
class _Plan:
    """Static description of one prepared scenario (shapes + strategies)."""
    n_flows: int                  # real flows (pre-padding)
    n_flows_pad: int
    n_groups: int
    n_groups_pad: int
    n_links: int
    n_dev: int
    ring: int                     # feedback history slots (pow2)
    hop: tuple                    # per-hop demand reduction strategies
    qlink: tuple
    qport: tuple
    group: tuple
    pause: tuple
    qdev: tuple


def _prep(topo: Topology, sched: Schedule, cfg: EngineConfig,
          pad_flows: int | None = None, pad_groups: int | None = None,
          device="cpu"):
    """Precompute static per-flow/per-link tensors + gather plans (numpy
    on the host, then moved to ``device``).  ``pad_flows``/``pad_groups``
    pad the flow and group axes with inert entries (done at t=0, zero
    bytes, null links) that no reduction plan includes."""
    Lk = topo.n_links
    F = sched.n_flows
    G = sched.n_groups
    Fp = max(pad_flows or F, F)
    Gp = max(pad_groups or G, G)

    path = np.where(sched.path < 0, Lk, sched.path).astype(np.int32)
    cap = np.concatenate([topo.cap, [1e18]]).astype(np.float32)
    lat = np.concatenate([topo.lat, [0.0]]).astype(np.float32)
    ecn_on = np.concatenate([topo.ecn_on, [False]])
    dst_dev = np.concatenate([topo.dst_dev, [topo.n_devices]]).astype(np.int32)
    link_class = np.concatenate([topo.link_class, [0]]).astype(np.int32)

    # ingress map: backlog at hop h arrived via link path[:, h-1] (h >= 1)
    ingress = np.full_like(path, Lk)
    ingress[:, 1:] = np.where(sched.path[:, 1:] >= 0, path[:, :-1], Lk)
    dev_sw_ext = np.concatenate([topo.dev_is_switch, [False]])
    fabric_ext = np.concatenate([topo.fabric, [False]])
    can_pause = dev_sw_ext[dst_dev] & fabric_ext
    sw_sw = (topo.dev_is_switch[topo.src_dev]
             & topo.dev_is_switch[topo.dst_dev] & topo.fabric)

    # static fan-in: concurrent (same-group) flows sharing each flow's
    # most-contended link
    link_load = np.zeros(Lk + 1, np.float64)
    for g in range(max(G, 1)):
        in_g = (sched.group == g) & (sched.size > 0)
        if not in_g.any():
            continue
        load_g = np.zeros(Lk + 1, np.float64)
        for h in range(path.shape[1]):
            np.add.at(load_g, path[in_g, h], 1.0)
        link_load = np.maximum(link_load, load_g)
    link_load[Lk] = 1.0
    fanin = np.ones(F, np.float64)
    for h in range(path.shape[1]):
        valid = sched.path[:, h] >= 0
        fanin = np.maximum(fanin, np.where(valid, link_load[path[:, h]], 1.0))

    hopmask = (sched.path >= 0)
    base_rtt = 2.0 * (lat[path] * hopmask).sum(1)
    base_rtt = np.maximum(base_rtt, 1e-7).astype(np.float32)
    delay_steps = np.clip(np.round(base_rtt / cfg.dt), 1,
                          cfg.hist - 1).astype(np.int32)
    first = path[:, 0]
    line = cap[first].astype(np.float32)
    bdp = (line * base_rtt).astype(np.float32)
    gsize = np.zeros(G, np.float32)
    np.add.at(gsize, sched.group, 1.0)

    def fpad(a, fill):
        if Fp == a.shape[0]:
            return a
        pad = np.full((Fp - a.shape[0],) + a.shape[1:], fill, a.dtype)
        return np.concatenate([a, pad])

    active = np.zeros(Fp, bool)
    active[:F] = True
    path = fpad(path, Lk)
    ingress = fpad(ingress, Lk)
    hopmask = fpad(hopmask, False)
    n_hops = fpad(sched.n_hops.astype(np.int32), 0)
    base_rtt = fpad(base_rtt, 1e-7)
    delay_steps = fpad(delay_steps, 1)
    line = fpad(line, 1.0)
    bdp = fpad(bdp, 1.0)
    fanin = fpad(fanin.astype(np.float32), 1.0)
    size = fpad(sched.size.astype(np.float32), 0.0)
    group = fpad(sched.group.astype(np.int32), 0)
    dep = fpad(sched.dep.astype(np.int32), -1)
    sdelay = fpad(sched.delay.astype(np.float32), 0.0)
    gsize = np.concatenate([gsize, np.zeros(Gp - G, np.float32)])

    invalid = ~hopmask
    hop_arrs, hop_strats = [], []
    for h in range(MAXHOP):
        a, s = _reduce_plan(path[:, h], Fp, Lk + 1, drop=invalid[:, h])
        hop_arrs.append(a)
        hop_strats.append(s)
    ql_a, ql_s = _reduce_plan(path.reshape(-1), Fp * MAXHOP, Lk + 1,
                              drop=invalid.reshape(-1))
    qp_a, qp_s = _reduce_plan(ingress.reshape(-1), Fp * MAXHOP, Lk + 1,
                              drop=(ingress == Lk).reshape(-1))
    gr_a, gr_s = _reduce_plan(group, Fp, Gp, drop=~active)
    pa_a, pa_s = _reduce_plan(dst_dev[:Lk], Lk, topo.n_devices)
    qd_a, qd_s = _reduce_plan(topo.src_dev, Lk, topo.n_devices)

    ring = _next_pow2(int(delay_steps.max()) + 1)

    plan = _Plan(
        n_flows=F, n_flows_pad=Fp, n_groups=G, n_groups_pad=Gp,
        n_links=Lk, n_dev=topo.n_devices, ring=ring,
        hop=tuple(hop_strats), qlink=ql_s, qport=qp_s,
        group=gr_s, pause=pa_s, qdev=qd_s,
    )

    def T(a, dtype=None):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                               device=device)

    pp = dict(
        path=T(path, torch.int64), cap=T(cap),
        dst_dev=T(dst_dev, torch.int64), can_pause=T(can_pause),
        hopmask=T(hopmask),
        caps_path=T(cap[path]),
        ecn_mask=T((ecn_on[path] & hopmask).astype(np.float32)),
        link_class=T(link_class, torch.int64),
        src_dev=T(topo.src_dev, torch.int64),
        sw_sw=T(sw_sw),
        fabric_link=T(fabric_ext.astype(np.float32)),
        fabric_path=T((fabric_ext[path] & hopmask).astype(np.float32)),
        cls_path=T(link_class[path], torch.int64),
        n_hops=T(n_hops, torch.int64),
        base_rtt=T(base_rtt), delay_steps=T(delay_steps, torch.int64),
        line=T(line), bdp=T(bdp), fanin=T(fanin), size=T(size),
        group=T(group, torch.int64), dep=T(dep, torch.int64),
        sdelay=T(sdelay), gsize=T(gsize), active=T(active),
        dev_buf=T(topo.dev_buf.astype(np.float32)),
        r_hop=tuple(_plan_tensors(a, device) for a in hop_arrs),
        r_qlink=_plan_tensors(ql_a, device),
        r_qport=_plan_tensors(qp_a, device),
        r_group=_plan_tensors(gr_a, device),
        r_pause=_plan_tensors(pa_a, device),
        r_qdev=_plan_tensors(qd_a, device),
    )
    return pp, plan


def _f32(x: float) -> float:
    return float(np.float32(x))


def _flow_ctx(pp: dict, F: int) -> FlowCtx:
    return FlowCtx(line=pp["line"], bdp=pp["bdp"], fanin=pp["fanin"],
                   n_flows=F)


def _n_qrows(cfg: EngineConfig) -> int:
    total = cfg.max_steps * (cfg.max_extends + 1)
    return -(-total // cfg.queue_stride) if cfg.queue_stride > 0 else 0


def _tree_map(fn, *trees):
    """``fn`` over the tensors of a carry (nested dicts and tuples)."""
    t0 = trees[0]
    if isinstance(t0, dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in t0}
    if isinstance(t0, tuple):
        return tuple(_tree_map(fn, *xs) for xs in zip(*trees))
    return fn(*trees)


def _column(v, lanes: int, device) -> torch.Tensor:
    """A scalar or length-B value as a ``(B, 1)`` float32 column; a tensor
    keeps its autograd graph."""
    if isinstance(v, torch.Tensor):
        return v.to(device=device, dtype=torch.float32) \
            .reshape(-1, 1).expand(lanes, 1)
    return torch.as_tensor(np.broadcast_to(
        np.asarray(v, np.float32).reshape(-1), (lanes,)).copy(),
        device=device).reshape(lanes, 1)


def _lane_params(policy: Policy, cc_params: dict | None, lanes: int,
                 device) -> dict:
    """The cc params a step reads: ``(B, 1)`` float32 columns for ``B``
    lanes (each value a scalar or a length-B array or tensor).  A serial
    run is one lane of the same form, so every run computes with the same
    tensors."""
    merged = dict(policy.params, **(cc_params or {}))
    return {k: _column(v, lanes, device) for k, v in merged.items()}


def _wire_of(policy: Policy, params: dict):
    """Wire factor: the policy's own, or the per-lane ``_wire`` param of a
    stacked policy (members differ: HPCC's INT carries +4.8%)."""
    return params["_wire"] if "_wire" in params else _f32(policy.wire_factor)


def _class_table(v, lanes: int, device) -> torch.Tensor:
    """A FabricParams or FaultSpec leaf as a ``(B, N_LINK_CLASSES)``
    float32 table: a scalar or per-class leaf for one lane, or a stacked
    ``(B,)`` or ``(B, N_LINK_CLASSES)`` leaf for B lanes.  A tensor leaf
    keeps its autograd graph."""
    if isinstance(v, torch.Tensor):
        return v.to(device=device, dtype=torch.float32) \
            .reshape(lanes, -1).expand(lanes, N_LINK_CLASSES)
    a = np.asarray(v, np.float32).reshape(lanes, -1)
    return torch.as_tensor(np.broadcast_to(
        a, (a.shape[0], N_LINK_CLASSES)).copy(), device=device)


def _lane_col(v, lanes: int, device) -> torch.Tensor:
    """A scalar FaultSpec leaf (a time, ``gbn``, ``mtu``) as a ``(B, 1)``
    float32 column: a scalar for one lane, or a stacked ``(B,)`` leaf."""
    if isinstance(v, torch.Tensor):
        return v.to(device=device, dtype=torch.float32).reshape(lanes, 1)
    return torch.as_tensor(np.array(v, np.float32).reshape(lanes, 1),
                           device=device)


def _broadcast_leaves(obj, lanes: int):
    """A one-lane FabricParams or FaultSpec with every leaf stacked on a
    leading axis of ``lanes``."""
    return dataclasses.replace(obj, **{
        f: np.broadcast_to(np.asarray(getattr(obj, f), np.float32),
                           (lanes,) + np.shape(getattr(obj, f)))
        for f in obj.FIELDS})


def _init_carry(pp, plan: _Plan, policy: Policy, cfg: EngineConfig,
                cc_params: dict | None = None, lanes: int = 1,
                faulty: bool = False):
    """The starting state of ``lanes`` lanes, every tensor with a leading
    lane axis ``B``; ``faulty`` adds the fault step's carry."""
    B = lanes
    Fp, Lk, D = plan.n_flows_pad, plan.n_links, plan.n_dev
    dev = pp["line"].device
    f32 = dict(dtype=torch.float32, device=dev)
    i32 = dict(dtype=torch.int32, device=dev)
    wire = _wire_of(policy, _lane_params(policy, cc_params, lanes, dev))

    def rows(x):
        return torch.broadcast_to(x, (B,) + tuple(x.shape[-1:])).clone()

    carry = dict(
        backlog=torch.zeros((B, Fp, MAXHOP), **f32),
        remaining=rows(pp["size"] * wire),
        injected=torch.zeros((B, Fp), **f32),
        delivered=torch.zeros((B, Fp), **f32),
        done=rows(~pp["active"]),       # padded flows are born finished
        t_finish=torch.full((B, Fp), float("inf"), **f32),
        g_count=torch.zeros((B, plan.n_groups_pad), **f32),
        # empty groups complete at t=0
        g_time=rows(torch.where(pp["gsize"] < 0.5, 0.0, float("inf"))),
        paused=torch.zeros((B, Lk + 1), dtype=torch.bool, device=dev),
        pause_count=torch.zeros((B, D), **f32),
        hist_q=torch.zeros((B, plan.ring, Lk + 1), **f32),
        hist_tx=torch.zeros((B, plan.ring, Lk + 1), **f32),
        cc=_tree_map(rows, policy.init(_flow_ctx(pp, Fp))),
        soft=torch.zeros(B, **f32),
        diverged=torch.zeros(B, dtype=torch.bool, device=dev),
        deadlock_step=torch.full((B,), -1, **i32),
        storm_run=torch.zeros(B, **i32),
        storm_step=torch.full((B,), -1, **i32),
    )
    if faulty:
        carry["lost"] = torch.zeros((B, Fp), **f32)      # dropped in-network
        carry["dup"] = torch.zeros((B, Fp), **f32)       # GBN resend overhead
        carry["loss_sig"] = torch.zeros((B, Fp), **f32)  # EWMA loss fraction
    if cfg.queue_stride > 0:
        carry["qbuf"] = torch.zeros((B, _n_qrows(cfg), D), **f32)
    return carry


# carry entries the step updates in place, row by row
_IN_PLACE = ("hist_q", "hist_tx", "qbuf")


def _make_step(policy: Policy, cfg: EngineConfig, plan: _Plan, pp: dict,
               cc_params: dict, fab: FabricParams, use_kernels: bool,
               lanes: int = 1, fault: FaultSpec | None = None,
               grad: bool = False):
    """The step ``step(carry, it, live=None) -> carry`` for one run of
    ``lanes`` lanes: the lossless step, or the faulty one where ``fault``
    injects any fault (``is_faulty``; its carry comes from
    ``_init_carry(faulty=True)``).

    ``cc_params`` values and the leaves of ``fab`` and ``fault`` are
    scalars (or per-class arrays) shared by every lane, or stacked on a
    leading lane axis (``(B,)`` params, ``(B,)`` or ``(B, C)`` leaves).
    Per-run constants (per-class fabric and fault knobs gathered per hop
    or link, wire sizes, thresholds) are computed once here; they are the
    values the reference recomputes every step.  ``use_kernels`` routes
    stages 1+2, every non-empty reduction plan and the PFC hysteresis
    through the CUDA kernel wrappers (which run their plain versions on
    CPU tensors), all B lanes in one launch.  The history ring and the
    queue timeline are updated in place.  ``live`` ((B,) bool) freezes
    the lanes that are False bit for bit, as the reference's per-lane
    step gate does under ``vmap``.

    ``grad`` is the step autograd differentiates (``soft_cost_fn``): op
    path only and no queue timeline; it writes the backlog's hop columns,
    the null link's capacity and the ring rows out of place, with the
    same values (autograd would mis-save an in-place write, and
    ``_RematSoft`` re-runs steps from carries that must not change).
    """
    B = lanes
    dt = cfg.dt
    dt32 = _f32(dt)
    Lk = plan.n_links
    D = plan.n_dev
    Fp = plan.n_flows_pad
    stride = cfg.queue_stride
    dl_rounds = max(1, (max(D, 2) - 1).bit_length())
    dev = pp["line"].device
    params = _lane_params(policy, cc_params, lanes, dev)
    reduce_ = _reduce_kernel if use_kernels else _reduce
    # the soft cost's sum over flows.  PyTorch's CUDA reduction spreads a
    # row over more blocks the fewer rows there are, so its order would
    # follow the lane count: on the card a lane adds through
    # ``_lane_sum_plan`` (one launch on the kernel path), as its serial run
    # adds.  A CPU sum adds each row in one order whatever the lane count.
    lane_plan = _lane_sum_plan(plan, dev) if dev.type == "cuda" else None
    if grad and (use_kernels or stride):
        raise ValueError("the differentiable step runs the op path "
                         "without a queue timeline (queue_stride=0)")
    null_link = torch.arange(Lk + 1, device=dev) == Lk

    path, hopmask = pp["path"], pp["hopmask"]
    cls_path = pp["cls_path"]
    kmin_h = _class_table(fab.kmin, lanes, dev)[:, cls_path]  # (B, F, MAXHOP)
    kmax_h = _class_table(fab.kmax, lanes, dev)[:, cls_path]
    pmax_h = _class_table(fab.pmax, lanes, dev)[:, cls_path]
    link_class = pp["link_class"]
    xoff_l = _class_table(fab.xoff, lanes, dev)[:, link_class].contiguous()
    xon_l = _class_table(fab.xon, lanes, dev)[:, link_class].contiguous()
    caps = pp["caps_path"]
    can = pp["can_pause"]
    wire_size = pp["size"] * _wire_of(policy, params)    # (F,) or (B, F)
    done_thresh = wire_size - cfg.eps_done
    # one total per lane, each summed as a one-lane run sums it
    wire_total = torch.stack([torch.clamp_min(w.sum(), 1.0) for w in
                              torch.broadcast_to(wire_size, (B, Fp))])
    gthresh = pp["gsize"] - 0.5
    dep_valid = pp["dep"] >= 0
    dep_c = torch.clamp_min(pp["dep"], 0)
    n_hops = pp["n_hops"]
    has_hops = n_hops > 0
    path_h = [path[:, h].contiguous() for h in range(MAXHOP)]
    last_h = [n_hops == (h + 1) for h in range(MAXHOP)]
    cap_dt = pp["cap"] * dt
    n_pausable = torch.clamp_min(can[:Lk].to(torch.float32).sum(), 1.0)
    frame_refresh = dt / cfg.pause_resend
    inv_dt = _f32(1.0 / np.float32(dt))
    # adjacency slot (src, dst) of each link in the pause-cycle check
    pair = pp["src_dev"] * D + pp["dst_dev"][:Lk]

    faulty = fault is not None and is_faulty(fault)
    if faulty:
        # ECN misconfiguration scales the marking probability (0 = broken)
        ecn_h = _class_table(fault.ecn_scale, lanes, dev)[:, cls_path]
        # per-hop drop probability: fabric links only (NVLink is lossless)
        loss_p = (_class_table(fault.loss_rate, lanes, dev)[:, cls_path]
                  * pp["fabric_path"])
        loss_h = [loss_p[..., h] for h in range(MAXHOP)]
        # degradation windows and flaps act on fabric links only
        is_fab = pp["fabric_link"] > 0
        deg_l = _class_table(fault.degrade, lanes, dev)[:, link_class]
        deg_t0 = _lane_col(fault.degrade_t0, lanes, dev)
        deg_t1 = _lane_col(fault.degrade_t1, lanes, dev)
        period = _lane_col(fault.flap_period, lanes, dev)
        period_safe = torch.clamp_min(period, _f32(1e-9))
        flap_t0 = _lane_col(fault.flap_t0, lanes, dev)
        flap_dn = _lane_col(fault.flap_down, lanes, dev)
        gbn = _lane_col(fault.gbn, lanes, dev)
        two_mtu = 2.0 * torch.clamp_min(_lane_col(fault.mtu, lanes, dev),
                                        1.0)
        # GBN's outstanding window is capped at the path BDP
        bdp_cap = pp["line"] * pp["base_rtt"]
        # loss EWMA weight per flow, dt / base RTT
        ewma_a = torch.clamp_max(rdiv(dt32, pp["base_rtt"]), 1.0)
        ewma_keep = 1.0 - ewma_a
        # pfc_on = 0 disables pausing on that link class
        can = can & (_class_table(fault.pfc_on, lanes, dev)[:, link_class]
                     > 0.5)

    if use_kernels:
        # hop-major (B, MAXHOP, F) inputs of the fused kernel
        def hm(x):
            x = x.to(torch.float32).transpose(-1, -2)
            return torch.broadcast_to(x, (B,) + tuple(x.shape[-2:])) \
                .contiguous()
        k_caps, k_emask, k_hmask = hm(caps), hm(pp["ecn_mask"]), hm(hopmask)
        # the ECN scale folds into the marking ceiling, as the
        # reference's kernel path does
        k_kmin, k_kmax = hm(kmin_h), hm(kmax_h)
        k_pmax = hm(pmax_h * ecn_h if faulty else pmax_h)
        path_t = path.T.contiguous()
        k_brtt = pp["base_rtt"].expand(B, Fp).contiguous()
        k_line = pp["line"].expand(B, Fp).contiguous()
        k_zero_loss = torch.zeros_like(k_line)    # lossless: no loss signal
        k_params = pack_params(policy, params, device=dev, lanes=B)
        k_can = can.expand(B, Lk + 1).contiguous()
        state_keys = kernel_state_keys(policy)
        k_dummy = torch.zeros((B, 1, Fp), dtype=torch.float32, device=dev)

    def pause_cycle(paused):
        """Per lane: any cycle in the switch->switch PFC wait-for graph?
        Link l paused means src_dev(l) waits on dst_dev(l) to resume.  The
        0/1 reachability is exact in float64 (no TF32 path)."""
        e = (paused[:, :Lk] & pp["sw_sw"]).to(torch.float64)
        adj = torch.zeros((B, D * D), dtype=torch.float64, device=dev)
        adj.index_add_(1, pair, e)
        S = torch.clamp_max(adj.view(B, D, D), 1.0)
        for _ in range(dl_rounds):
            S = torch.clamp_max(S + S @ S, 1.0)
        return torch.any(torch.diagonal(S, dim1=-2, dim2=-1) > 0.5, dim=-1)

    def step(c, it: int, live=None):
        t = _f32(np.float32(it) * np.float32(dt))
        t_end = _f32(np.float32(t) + np.float32(dt))
        # the reference's compiler contracts the group stamp t + dt =
        # it * dt + dt into one multiply-add (the flow stamp it does not)
        t_end_g = _f32(float(np.float32(it)) * dt32 + dt32)
        # ---- 1. delayed signals ------------------------------------------
        slot = torch.clamp_min(it - pp["delay_steps"], 0) % plan.ring
        hq = c["hist_q"].reshape(B, -1)
        htx = c["hist_tx"].reshape(B, -1)
        if use_kernels:
            # ---- 1+2 fused: signals + CC update in one kernel --------------
            flat_t = slot[None, :] * (Lk + 1) + path_t          # (MAXHOP, F)
            q_d = hq[:, flat_t].contiguous()                 # (B, MAXHOP, F)
            tx_d = htx[:, flat_t].contiguous()
            state = (torch.stack([c["cc"][k] for k in state_keys], dim=1)
                     if state_keys else k_dummy)
            k_loss = (c["loss_sig"].contiguous() if faulty
                      else k_zero_loss)
            st_out, rate, win = es_ops.fused_signals_policy(
                policy, q_d, tx_d, k_caps, k_emask, k_hmask, k_kmin, k_kmax,
                k_pmax, k_brtt, k_line, k_loss, state, k_params, t,
                cfg.t_base_util, dt32)
            cc = {k: st_out[:, j] for j, k in enumerate(state_keys)}
        else:
            flat = slot[:, None] * (Lk + 1) + path               # (F, MAXHOP)
            q_d = _gather_cols(hq, flat)                      # (B, F, MAXHOP)
            tx_d = _gather_cols(htx, flat)
            rtt = pp["base_rtt"] + row_sum(q_d / caps * hopmask)
            mark = _clip((q_d - kmin_h) / _max(kmax_h - kmin_h, 1.0),
                         0.0, 1.0) * pmax_h
            if faulty:
                mark = mark * ecn_h
            mark = mark * pp["ecn_mask"]
            ecn = 1.0 - row_prod(1.0 - mark)
            util_l = tx_d / caps + q_d / (caps * cfg.t_base_util)
            util = torch.amax(torch.where(hopmask, util_l, 0.0), dim=-1)
            sig = Signals(ecn=ecn, rtt=rtt, util=util, t=t, dt=dt32,
                          line=pp["line"], base_rtt=pp["base_rtt"],
                          loss=c["loss_sig"] if faulty else 0.0)
            # ---- 2. CC update ---------------------------------------------
            cc, rate, win = policy.update(params, c["cc"], sig)

        # ---- 3. injection --------------------------------------------------
        g_done = c["g_count"] >= gthresh
        dep_ok = torch.where(dep_valid, g_done[:, dep_c], True)
        dep_t = torch.where(dep_valid, c["g_time"][:, dep_c], 0.0)
        started = dep_ok & (t >= dep_t + pp["sdelay"])
        inflight = c["injected"] - c["delivered"]
        if faulty:
            # lost bytes are not in flight (the NIC saw the NACK/timeout)
            inflight = inflight - c["lost"]
        room = _max(win - inflight, 0.0)
        inj = torch.minimum(torch.minimum(rate * dt, room), c["remaining"])
        inj = torch.where(started & has_hops, _max(inj, 0.0), 0.0)
        if grad:        # the backlog as hop columns, stacked after stage 5
            cols = list(c["backlog"].unbind(-1))
            cols[0] = cols[0] + inj
        else:
            backlog = c["backlog"].clone()
            backlog[..., 0] += inj
        remaining = c["remaining"] - inj
        injected = c["injected"] + inj

        # ---- 4. PFC gates (per-port) ---------------------------------------
        rem_cap = cap_dt * ~c["paused"]
        if faulty:
            # degradation windows and periodic flaps (down for flap_down
            # out of every flap_period seconds) on fabric links
            in_deg = (t >= deg_t0) & (t < deg_t1)
            capmul = torch.where(in_deg & is_fab, deg_l, 1.0)
            phase = torch.remainder(t - flap_t0, period_safe)
            down = (period > 0) & (t >= flap_t0) & (phase < flap_dn)
            capmul = torch.where(down & is_fab, 0.0, capmul)
            rem_cap = rem_cap * capmul
        if grad:
            rem_cap = torch.where(null_link, 1e18, rem_cap)
        else:
            rem_cap[:, Lk] = 1e18

        # ---- 5. hop-ordered forwarding -------------------------------------
        delivered = c["delivered"]
        tx_bytes = None
        lost_step = None
        for h in range(MAXHOP):
            if plan.hop[h][0] == "empty":   # no flow ever uses this hop slot
                continue
            b_h = cols[h] if grad else backlog[..., h]
            dem = reduce_(plan.hop[h], pp["r_hop"][h], b_h)
            frac = torch.where(dem > 0,
                               _min(rem_cap / _max(dem, 1e-9), 1.0), 0.0)
            frac_f = _gather_cols(frac, path_h[h])
            moved = b_h * frac_f
            # backlog - backlog*frac and the capacity/tx updates are
            # multiply-adds the reference contracts (see cc.fma)
            if grad:
                cols[h] = fma(-b_h, frac_f, b_h)
            else:
                backlog[..., h] = fma(-b_h, frac_f, b_h)
            if faulty:
                # bytes dropped on this hop consumed upstream capacity but
                # leave the network; they re-enter `remaining` below
                # the reference's compiler fuses each later hop's drop
                # product into the running sum: m0*l0, fma(m1, l1, .), ...
                drop = moved * loss_h[h]
                lost_step = (drop if lost_step is None
                             else fma(moved, loss_h[h], lost_step))
                moved = moved - drop
            delivered = delivered + torch.where(last_h[h], moved, 0.0)
            if h + 1 < MAXHOP:
                fwd = torch.where(last_h[h], 0.0, moved)
                if grad:
                    cols[h + 1] = cols[h + 1] + fwd
                else:
                    backlog[..., h + 1] += fwd
            # frac * dem == per-link sum of `moved`
            rem_cap = _max(fma(-frac, dem, rem_cap), 0.0)
            # the reference's tx = 0 + m0 + m1 + ... folds to m0 + m1 + ...,
            # whose first add contracts m0's multiply: fma(f0, d0, f1*d1)
            if tx_bytes is None:
                tx_bytes = (frac, dem)
            elif isinstance(tx_bytes, tuple):
                tx_bytes = fma(tx_bytes[0], tx_bytes[1], frac * dem)
            else:
                tx_bytes = fma(frac, dem, tx_bytes)
        if isinstance(tx_bytes, tuple):
            tx_bytes = tx_bytes[0] * tx_bytes[1]
        if grad:
            backlog = torch.stack(cols, dim=-1)

        if faulty:
            # ---- 5b. loss recovery (IRN vs go-back-N) ----------------------
            if lost_step is None:           # no flow uses any hop slot
                lost_step = torch.zeros_like(delivered)
            lost = c["lost"] + lost_step
            live_b = _max(injected - delivered - lost, 0.0)
            # IRN resends the lost bytes only; go-back-N also resends, per
            # lost packet, half the outstanding window (in-network bytes
            # capped at the path BDP, else incast GBN never drains)
            w_out = torch.minimum(live_b, bdp_cap)
            dup_step = gbn * torch.minimum(lost_step * w_out / two_mtu,
                                           live_b)
            remaining = remaining + lost_step + dup_step
            dup = c["dup"] + dup_step
            # per-flow EWMA loss fraction: the next step's loss signal
            traf = lost_step + (delivered - c["delivered"])
            frac_l = lost_step / _max(traf, 1.0)
            # (1 - a) * sig + a * frac: the first product is fused
            loss_sig = torch.where(traf > 0,
                                   fma(ewma_keep, c["loss_sig"],
                                       ewma_a * frac_l),
                                   c["loss_sig"])

        # ---- 6. queues ------------------------------------------------------
        flat_backlog = backlog.reshape(B, -1)
        q_link = reduce_(plan.qlink, pp["r_qlink"], flat_backlog)
        if use_kernels and plan.qport[0] != "empty":
            # ---- 6b+7 fused: per-port occupancy + hysteresis -------------
            idx, n_out, C, *split = _kernel_plan(plan.qport, pp["r_qport"])
            _, paused = es_ops.segment_reduce_pfc(
                flat_backlog, idx, n_out, C, xoff_l, xon_l, k_can,
                c["paused"], *split)
        else:
            q_port = reduce_(plan.qport, pp["r_qport"], flat_backlog)
            # ---- 7. PFC per-port hysteresis ---------------------------------
            over = (q_port > xoff_l) & can
            under = q_port < xon_l
            paused = torch.where(over, True,
                                 torch.where(under, False, c["paused"]))
        # PAUSE frames: one per off-transition + refreshes while paused
        frames = ((paused & ~c["paused"])[:, :Lk].to(torch.float32)
                  + paused[:, :Lk].to(torch.float32) * frame_refresh)
        pause_count = c["pause_count"] + reduce_(plan.pause, pp["r_pause"],
                                                 frames)

        # ---- 8. completion --------------------------------------------------
        if faulty:
            # duplicates arrive and are discarded: goodput = delivered - dup
            data_done = delivered >= wire_size + dup - cfg.eps_done
        else:
            data_done = delivered >= done_thresh
        marker_done = ~has_hops & started
        newly = ~c["done"] & torch.where(has_hops, data_done, marker_done)
        done = c["done"] | newly
        # completion happens at the END of this step's transfer window
        t_finish = torch.where(newly, t_end, c["t_finish"])
        g_count = c["g_count"] + reduce_(plan.group, pp["r_group"],
                                         newly.to(torch.float32))
        g_done_new = (g_count >= gthresh) & ~g_done
        g_time = torch.where(g_done_new, t_end_g, c["g_time"])

        # ---- 9. history + soft cost ----------------------------------------
        hist_q, hist_tx = c["hist_q"], c["hist_tx"]
        row = it % plan.ring
        # the reference's compiler turns x / dt into x * (1/dt)
        tx_rate = tx_bytes * inv_dt
        if live is not None:        # frozen lanes keep their ring rows
            q_link_w = torch.where(live[:, None], q_link, hist_q[:, row])
            tx_rate = torch.where(live[:, None], tx_rate, hist_tx[:, row])
        else:
            q_link_w = q_link
        if grad:
            hist_q = torch.cat([hist_q[:, :row], q_link_w[:, None],
                                hist_q[:, row + 1:]], dim=1)
            hist_tx = torch.cat([hist_tx[:, :row], tx_rate[:, None],
                                 hist_tx[:, row + 1:]], dim=1)
        else:
            hist_q[:, row] = q_link_w
            hist_tx[:, row] = tx_rate
        if faulty:
            goodput = _min(_max(delivered - dup, 0.0), wire_size)
        else:
            goodput = torch.minimum(delivered, wire_size)
        short = wire_size - goodput
        undeliv = (torch.sum(short, dim=-1) if lane_plan is None
                   else _lane_sum(reduce_, lane_plan, short))
        soft = c["soft"] + dt * undeliv / wire_total

        # ---- 10. run health (observers) ------------------------------------
        pfrac = torch.sum(paused[:, :Lk].to(torch.float32), dim=-1) \
            / n_pausable
        storm_run = torch.where(pfrac >= cfg.storm_frac,
                                c["storm_run"] + 1, 0).to(torch.int32)
        storm_step = torch.where((c["storm_step"] < 0)
                                 & (storm_run >= cfg.storm_steps),
                                 it, c["storm_step"]).to(torch.int32)
        deadlock_step = c["deadlock_step"]
        if it % cfg.deadlock_check_every == 0:
            # checked while switch->switch pauses exist and no cycle was
            # seen yet
            do_check = (torch.any(paused[:, :Lk] & pp["sw_sw"], dim=-1)
                        & (deadlock_step < 0))
            cycle = do_check & pause_cycle(paused)
            deadlock_step = torch.where(cycle, it,
                                        deadlock_step).to(torch.int32)
        probe = (torch.sum(backlog, dim=(-2, -1)) + torch.sum(remaining, -1)
                 + torch.sum(rate, -1) + torch.sum(q_link, -1) + soft)
        diverged = c["diverged"] | ~torch.isfinite(probe)

        new = dict(
            backlog=backlog, remaining=remaining, injected=injected,
            delivered=delivered, done=done, t_finish=t_finish,
            g_count=g_count, g_time=g_time, paused=paused,
            pause_count=pause_count, hist_q=hist_q, hist_tx=hist_tx,
            cc=cc, soft=soft, diverged=diverged,
            deadlock_step=deadlock_step, storm_run=storm_run,
            storm_step=storm_step)
        if faulty:
            new.update(lost=lost, dup=dup, loss_sig=loss_sig)
        if stride > 0:
            qbuf = c["qbuf"]
            if it % stride == 0:
                q_dev = reduce_(plan.qdev, pp["r_qdev"], q_link[:, :Lk])
                if live is not None:
                    q_dev = torch.where(live[:, None], q_dev,
                                        qbuf[:, it // stride])
                qbuf[:, it // stride] = q_dev
            new["qbuf"] = qbuf
        if live is not None:
            def keep(n, o):
                return torch.where(live.view((B,) + (1,) * (n.dim() - 1)),
                                   n, o)
            new = {k: v if k in _IN_PLACE else _tree_map(keep, v, c[k])
                   for k, v in new.items()}
        return new

    return step


def _halted_lanes(c) -> torch.Tensor:
    """(B,) bool on the device: the step no-op gate of each lane (every
    flow done, or the lane diverged)."""
    return c["done"].all(dim=-1) | c["diverged"]


def _gate(c, select: bool = False):
    """One host read per step: ``(stop, live, stepping)``.  ``stop`` says
    every later step is a no-op; ``live`` is the (B,) mask of lanes still
    stepping on the device, or None while no lane has halted (the step
    then skips the per-lane freeze); ``stepping`` is the same mask on the
    host.

    ``select`` gives the gradient of the reference's vmapped fixed-length
    scan, whose per-lane gate is a select: a halted lane's step is still
    computed and discarded, so its backward multiplies zeros into the
    step's partial derivatives.  Those are finite at a finished lane's
    finite state, so the run may stop once every lane has halted; but a
    diverged lane's need not be (0 * inf is NaN, as in the reference),
    so while any lane has diverged the run goes on to the full length
    with every halted lane frozen."""
    halted = _halted_lanes(c)
    if not select:
        h = halted.cpu().numpy()
        if h.all():
            return True, None, ~h
        return False, (~halted if h.any() else None), ~h
    h, d = torch.stack([halted, c["diverged"]]).cpu().numpy()
    if h.all() and not d.any():
        return True, None, ~h
    return False, (~halted if h.any() else None), ~h


def _steps(step, c, lo: int, hi: int, select: bool):
    """Steps ``lo`` .. ``hi - 1``, each gated as ``_gate(select)`` says:
    ``(carry, steps_executed, lane_steps, stopped)``."""
    executed, lane_steps = 0, 0
    for it in range(lo, hi):
        stop, live, stepping = _gate(c, select)
        if stop:                # every later step is a no-op
            return c, executed, lane_steps, True
        c = step(c, it, live)
        executed += 1
        lane_steps = lane_steps + stepping
    return c, executed, lane_steps, False


def _float_leaves(carry) -> list:
    """The carry's float tensors (the ones a gradient flows through), in
    a fixed order."""
    out = []
    _tree_map(lambda x: out.append(x) if x.is_floating_point() else None,
              carry)
    return out


# steps the rematerialized backward runs from the start to find the carry
# leaves that carry a gradient (they all do after the first step or two)
_GRAD_PROBE_STEPS = 8


class _RematSoft(torch.autograd.Function):
    """The soft cost of the fixed-length loop, rematerialized: the forward
    runs every step without autograd and keeps the carry at each segment
    boundary; the backward re-runs the segments last to first under
    autograd, one at a time, and carries the cotangent of the carry from
    each segment's end to its start.  Memory: one carry per segment plus
    one segment's activations.  ``build(xs) -> (step, carry0)`` makes the
    step and the starting carry from the differentiable inputs ``xs``."""

    @staticmethod
    def forward(ctx, build, total, seg, select, *xs):
        step, carry = build(xs)
        bounds = []
        for lo in range(0, total, seg):
            hi = min(lo + seg, total)
            bounds.append((lo, hi, carry))
            carry, _, _, stop = _steps(step, carry, lo, hi, select)
            if stop:
                break
        ctx.build, ctx.bounds, ctx.select = build, bounds, select
        ctx.save_for_backward(*xs)
        return carry["soft"]

    @staticmethod
    def backward(ctx, g_soft):
        xs = [x.detach().requires_grad_(x.requires_grad)
              for x in ctx.saved_tensors]
        diff = [x for x in xs if x.requires_grad]
        gx = {id(x): None for x in diff}
        with torch.enable_grad():
            step, carry0 = ctx.build(xs)
            # the carry's leaves that depend on the inputs (state, not
            # timestamps or counters), found by a few steps from the start
            probe = _steps(step, carry0, 0, min(_GRAD_PROBE_STEPS,
                                                ctx.bounds[-1][1]),
                           ctx.select)[0]
            tracked = [t.requires_grad for t in _float_leaves(probe)]
            del probe
            cot = None                  # cotangent of each float leaf
            for i in reversed(range(len(ctx.bounds))):
                lo, hi, saved = ctx.bounds[i]
                if i == 0:
                    c_in, ins = carry0, []
                else:
                    c_in = _tree_map(lambda t: t.detach(), saved)
                    ins = [t.requires_grad_() for t, keep in
                           zip(_float_leaves(c_in), tracked) if keep]
                c_out = _steps(step, c_in, lo, hi, ctx.select)[0]
                outs = _float_leaves(c_out)
                if any(o.requires_grad and not keep
                       for o, keep in zip(outs, tracked)):
                    raise RuntimeError("a carry leaf came to depend on the "
                                       "inputs after the probe's steps")
                if cot is None:         # the last segment: d soft only
                    cot = [g_soft if o is c_out["soft"] else None
                           for o in outs]
                pairs = [(o, g) for o, g in zip(outs, cot)
                         if g is not None and o.requires_grad]
                grads = torch.autograd.grad(
                    [o for o, _ in pairs], ins + diff,
                    [g for _, g in pairs], allow_unused=True,
                    retain_graph=True) if pairs else [None] * len(ins + diff)
                if ins:                 # the cotangent at the start
                    it = iter(grads[:len(ins)])
                    cot = [next(it) if keep else None for keep in tracked]
                for x, g in zip(diff, grads[len(ins):]):
                    if g is not None:
                        gx[id(x)] = g if gx[id(x)] is None else gx[id(x)] + g
        return (None, None, None, None,
                *(gx[id(x)] if x.requires_grad else None for x in xs))


def _run_loop(step, carry, cfg: EngineConfig, early_exit: bool,
              select: bool = False):
    """Chunked stepping: returns ``(carry, steps_run, steps_executed,
    lane_steps)`` with the reference's chunk-rounded ``steps_run``, the
    number of steps that were not no-ops and, per lane, the number of
    steps in which that lane stepped (its own work, where
    ``steps_executed`` also counts the steps it sat frozen).  A halted
    lane is frozen while the others step; the loop stops at the first
    chunk boundary where every lane has halted, or inside a chunk once
    they all have (the rest of it would be no-ops), so results never
    depend on ``chunk_steps``.

    ``early_exit=False`` is the reference's fixed-length scan, the one
    autograd differentiates, each step gated as ``_gate(select)`` says
    (``_run_remat`` is its rematerialized form)."""
    total = cfg.max_steps * (cfg.max_extends + 1)
    chunk = max(1, min(cfg.chunk_steps, total))
    if not early_exit:
        carry, executed, lane_steps, _ = _steps(step, carry, 0, total,
                                                select)
        return carry, total, executed, np.zeros(
            carry["soft"].shape[0], np.int64) + lane_steps
    executed = 0
    lane_steps = np.zeros(carry["soft"].shape[0], np.int64)
    it0 = 0
    while it0 < total:
        stop, live, stepping = _gate(carry)
        if stop:
            break
        for it in range(it0, min(it0 + chunk, total)):
            if it > it0:
                stop, live, stepping = _gate(carry)
                if stop:
                    break
            carry = step(carry, it, live)
            executed += 1
            lane_steps += stepping
        it0 += chunk
    return carry, min(it0, total), executed, lane_steps


def _run_remat(build, xs, cfg: EngineConfig, early_exit: bool = False,
               select: bool = False) -> torch.Tensor:
    """The soft cost of the fixed-length loop in rematerialized segments
    of ``cfg.chunk_steps`` steps (``_RematSoft``); the reference's
    ``_make_run(remat=True)``, which refuses early exit as it does."""
    if early_exit:
        raise ValueError("remat applies to the fixed-length loop only "
                         "(early_exit=False), as in the reference")
    total = cfg.max_steps * (cfg.max_extends + 1)
    chunk = max(1, min(cfg.chunk_steps, total))
    return _RematSoft.apply(build, total, chunk, select, *xs)


class Simulator:
    """Fluid simulation of one (topology, schedule, policy) on ``device``
    (the card by default).  ``pad_flows``/``pad_groups`` pad the flow and
    group axes with inert entries (see ``_prep``).  A stacked policy
    (``cc.stack_policies``) has no device function and runs on the op
    path, as in the reference."""

    def __init__(self, topo: Topology, sched: Schedule, policy: Policy,
                 cfg: EngineConfig = EngineConfig(),
                 pad_flows: int | None = None, pad_groups: int | None = None,
                 fabric_params: FabricParams | None = None,
                 fault_spec: FaultSpec | None = None, device="cuda"):
        self.device = resolve_device(device)
        self.step_impl = resolve_step_impl(cfg, self.device)
        if policy.members:
            self.step_impl = "torch"
        if self.step_impl == "cuda" and policy.kernel_id is None:
            raise NotImplementedError(
                f"policy {policy.name!r} has no device function in the "
                "fused CUDA step kernel; use step_impl='torch'")
        self.topo, self.sched, self.policy, self.cfg = topo, sched, policy, cfg
        self.fabric = _as_fabric(fabric_params, cfg)
        self.fault = _as_fault(fault_spec)
        self.pp, self.plan = _prep(topo, sched, cfg, pad_flows, pad_groups,
                                   self.device)
        self._replicas: dict = {}

    def on(self, device) -> "Simulator":
        """This simulation prepared on ``device``, a device of this one's
        type: itself on its own device, else a copy whose prepared tensors
        were moved there at the first call (kept with this simulator)."""
        device = resolve_device(device)
        if device.type != self.device.type:
            raise ValueError(f"a simulator on {self.device} has no replica "
                             f"on {device}: the step path follows the "
                             "device type")
        if _canonical(device) == _canonical(self.device):
            return self
        key = _canonical(device)
        rep = self._replicas.get(key)
        if rep is None:
            rep = copy.copy(self)
            rep.device, rep._replicas = key, {}
            rep.pp = _tree_map(lambda x: x.to(key), self.pp)
            self._replicas[key] = rep
        return rep

    def run(self, cc_params: dict | None = None, early_exit: bool = True,
            fabric_params: FabricParams | None = None,
            fault_spec: FaultSpec | None = None) -> Results:
        fab = fabric_params if fabric_params is not None else self.fabric
        flt = fault_spec if fault_spec is not None else self.fault
        carry, steps, executed, _ = self.run_carry(cc_params, fab, 1,
                                                   early_exit, flt)
        return self._results(_tree_map(lambda x: x[0], carry), steps,
                             executed)

    def run_carry(self, cc_params: dict | None, fab: FabricParams,
                  lanes: int, early_exit: bool = True,
                  fault: FaultSpec | None = None):
        """Step ``lanes`` lanes in one loop and return ``_run_loop``'s
        ``(carry, steps_run, steps_executed, lane_steps)``, the carry with
        its leading lane axis.  ``cc_params`` values and the leaves of
        ``fab`` and ``fault`` (default: the inert spec) are shared by
        every lane or stacked on a leading axis of length ``lanes``."""
        fault = _as_fault(fault)
        step = _make_step(self.policy, self.cfg, self.plan, self.pp,
                          cc_params, fab, self.step_impl == "cuda", lanes,
                          fault)
        carry = _init_carry(self.pp, self.plan, self.policy, self.cfg,
                            cc_params, lanes, is_faulty(fault))
        return _run_loop(step, carry, self.cfg, early_exit)

    def _results(self, carry, steps_run: int,
                 steps_executed: int) -> Results:
        F, G = self.plan.n_flows, self.plan.n_groups

        def host(x):
            return x.detach().cpu().numpy()

        t_fin = host(carry["t_finish"])[:F]
        done = host(carry["done"])[:F]
        if self.cfg.queue_stride > 0:
            rows = -(-steps_run // self.cfg.queue_stride)
            dev_queue = host(carry["qbuf"])[:rows]
        else:
            dev_queue = np.zeros((0, self.plan.n_dev), np.float32)
        finished = bool(done.all())
        diverged = bool(carry["diverged"])
        deadlock_step = int(carry["deadlock_step"])
        extend_exhausted = not finished and not diverged
        if extend_exhausted:
            total = self.cfg.max_steps * (self.cfg.max_extends + 1)
            warnings.warn(
                f"step budget exhausted: {int((~done).sum())}/{F} flows "
                f"unfinished after {total} steps (max_steps="
                f"{self.cfg.max_steps}, max_extends={self.cfg.max_extends}) "
                f"for policy {self.policy.name!r} on {self.topo.name!r}; "
                "completion_time is a lower bound — raise max_steps/"
                "max_extends or treat this cell as invalid",
                RuntimeWarning, stacklevel=3)
        return Results(
            finished=finished,
            completion_time=float(np.max(np.where(np.isfinite(t_fin),
                                                  t_fin, 0.0))),
            t_finish=t_fin,
            group_time=host(carry["g_time"])[:G],
            group_names=self.sched.group_names,
            pause_count=host(carry["pause_count"]),
            dev_queue=dev_queue,
            dt=self.cfg.dt,
            delivered=host(carry["delivered"])[:F],
            soft_cost=float(carry["soft"]),
            meta={"policy": self.policy.name, "topo": self.topo.name,
                  "n_flows": self.sched.n_flows, "steps_run": steps_run,
                  "steps_executed": steps_executed,
                  "queue_stride": self.cfg.queue_stride,
                  "step_impl": self.step_impl, "device": str(self.device)},
            deadlocked=deadlock_step >= 0,
            deadlock_step=deadlock_step,
            storm_step=int(carry["storm_step"]),
            diverged=diverged,
            extend_exhausted=extend_exhausted,
            lost=host(carry["lost"])[:F] if "lost" in carry else None,
        )

    # -- differentiable objective -------------------------------------------
    def soft_cost_fn(self, remat: bool = False, lanes: int | None = None):
        """``cost(cc_params=None, fabric_params=None) -> soft cost``,
        differentiable by autograd w.r.t. every tensor among the CC params
        and the fabric leaves (a value or leaf that is not a tensor is a
        constant).  ``cc_params`` overrides the policy's defaults.

        It runs the fixed-length loop (``early_exit=False``) on the op
        path on this simulator's device: the reference's kernels have no
        VJP, and neither do the port's, so ``step_impl="auto"`` resolves to
        the op path for this entry point only and an explicit
        ``step_impl="cuda"`` raises.  The value is ``Results.soft_cost`` of
        a forward run to the bit.  ``remat=True`` keeps one carry per
        ``cfg.chunk_steps`` steps and re-runs each segment in the backward
        pass (``_RematSoft``): the same value, O(total/chunk + chunk)
        carries live instead of O(total).

        ``lanes=None`` is one lane, the reference's ``soft_cost_fn``: the
        loop stops once the lane has halted, as its ``lax.cond`` gate
        does, and the cost is a 0-dim tensor.  ``lanes=B`` is the
        reference's cost under ``vmap`` over B members, one (B,) tensor:
        each ``cc_params`` value is a scalar or has B entries, each
        fabric leaf is stacked on a leading axis of B (``(B,)`` or ``(B,
        N_LINK_CLASSES)``), this simulator's fault spec is every lane's,
        and halted lanes are gated as a select (``_gate``)."""
        if self.cfg.step_impl == "cuda":
            raise NotImplementedError(
                "soft_cost_fn differentiates the op path: the fused "
                "engine-step kernel (fused_signals_policy) and the segment "
                "kernels (segment_reduce, segment_reduce_pfc) have no "
                "backward kernels, as the reference's have no VJP; use "
                "step_impl='auto' or 'torch'")
        cfg = dataclasses.replace(self.cfg, queue_stride=0)
        B = 1 if lanes is None else int(lanes)
        fault = (self.fault if lanes is None
                 else _broadcast_leaves(self.fault, B))
        faulty = is_faulty(self.fault)

        def cost(cc_params: dict | None = None,
                 fabric_params: FabricParams | None = None):
            fab = self.fabric if fabric_params is None else fabric_params
            if lanes is not None and fabric_params is None:
                fab = _broadcast_leaves(fab, B)
            # the differentiable inputs: every tensor among the params
            cc_params = dict(cc_params or {})
            cc_keys = [k for k, v in cc_params.items()
                       if isinstance(v, torch.Tensor)]
            fab_keys = [f for f in FabricParams.FIELDS
                        if isinstance(getattr(fab, f), torch.Tensor)]
            xs = [cc_params[k] for k in cc_keys] + \
                [getattr(fab, f) for f in fab_keys]

            def build(ts):
                p = dict(cc_params, **dict(zip(cc_keys, ts)))
                f = dataclasses.replace(
                    fab, **dict(zip(fab_keys, ts[len(cc_keys):])))
                return (_make_step(self.policy, cfg, self.plan, self.pp, p,
                                   f, False, B, fault, grad=True),
                        _init_carry(self.pp, self.plan, self.policy, cfg, p,
                                    B, faulty))

            if remat:
                soft = _run_remat(build, xs, cfg, select=lanes is not None)
            else:
                step, carry = build(xs)
                soft = _run_loop(step, carry, cfg, early_exit=False,
                                 select=lanes is not None)[0]["soft"]
            return soft[0] if lanes is None else soft

        return cost

    def soft_cost(self, cc_params: dict | None = None,
                  fabric_params: FabricParams | None = None) -> torch.Tensor:
        """The differentiable objective, the integral of the undelivered
        fraction: ``soft_cost_fn()(cc_params, fabric_params)``."""
        return self.soft_cost_fn()(cc_params, fabric_params)


def simulate(topo, sched, policy, cfg: EngineConfig = EngineConfig(),
             fabric_params: FabricParams | None = None,
             fault_spec: FaultSpec | None = None, device="cuda") -> Results:
    return Simulator(topo, sched, policy, cfg, fabric_params=fabric_params,
                     fault_spec=fault_spec, device=device).run()
