"""RoCE congestion-control policies (paper §II-D) as vectorized fluid
update rules over flat per-flow float32 tensors (port of
``repro.core.cc``, Policy API v2).

Each policy is a pair of plain functions:

    init(ctx: FlowCtx)                       -> dict of (F,) tensors
    update(params, state, sig: Signals)      -> (state, rate, window)

``params`` is a flat dict whose values are Python floats (one lane) or
``(B, 1)`` float32 columns (one value per sweep lane, broadcast against
the ``(B, F)`` state).  Where the reference combines two parameters
before touching a tensor (``1 - g``), the port rounds that scalar to
float32 (``_f32``), as the reference does when its parameters arrive as
traced float32 arrays; tensor-scalar arithmetic in PyTorch already rounds
the scalar to float32 first, and a float32 column computes ``1 - g`` in
float32 itself, so a lane gives the same bits either way.

Every policy also carries ``kernel_id``: the template argument that picks
its device function in the fused CUDA step kernel
(``repro_torch/kernels/engine_step/csrc/engine_step.cu``).  A policy
without one runs on the op path only.  ``stack_policies`` builds the
product policy of a policy axis (op path only, as in the reference).  The
registry holds the reference's eight policies in its order, the learned
``mlp`` last (``repro_torch.learn.net``, imported on first use).
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from repro_torch.core.arith import expf, fma, rdiv, sdiv

INF = 1e18


def _f32(x):
    """Round a Python scalar to the nearest float32 value; a per-lane
    parameter column is float32 already and passes through."""
    return x if isinstance(x, torch.Tensor) else float(np.float32(x))


def _lossy(sig) -> bool:
    """Does ``sig`` carry a per-flow loss tensor?  The lossless engine
    passes the scalar 0.0, for which every loss branch is skipped; with a
    tensor, ``where(loss > 0, ...)`` keeps loss == 0 flows bitwise
    unchanged, as in the reference."""
    return isinstance(sig.loss, torch.Tensor)


def _loss_ecn(sig):
    """Loss treated like extra marking (DCQCN's NACK-driven cuts, DCTCP's
    congested-traffic EWMA)."""
    if not _lossy(sig):
        return sig.ecn
    return torch.where(sig.loss > 0, _min(sig.ecn + 2.0 * sig.loss, 1.0),
                       sig.ecn)


_BOUNDS: dict = {}


def bound(v):
    """A Python scalar bound as a 0-dim float32 tensor on the CPU (cached
    per value); a tensor passes through.  Against it ``torch.maximum`` and
    ``torch.minimum`` give each side half the gradient of a tie, as
    ``jnp.maximum``/``jnp.minimum`` do, where ``clamp_min``/``clamp_max``
    give all of it to ``x``; the values are the same.  A 0-dim CPU
    tensor rides an op on the card as a scalar, with no copy."""
    if isinstance(v, torch.Tensor):
        return v
    t = _BOUNDS.get(v)
    if t is None:
        t = _BOUNDS[v] = torch.tensor(v, dtype=torch.float32)
    return t


def _max(x, v):
    """``jnp.maximum(x, v)``, its tie rule included."""
    return torch.maximum(x, bound(v))


def _min(x, v):
    """``jnp.minimum(x, v)``, its tie rule included."""
    return torch.minimum(x, bound(v))


def _clip(x, lo, hi):
    """``jnp.clip``: ``min(max(x, lo), hi)`` with scalar or tensor bounds,
    its tie rule included.  With scalar bounds and no gradient to carry it
    is one ``torch.clamp``, the same values in one operation."""
    if not (x.requires_grad or isinstance(lo, torch.Tensor)
            or isinstance(hi, torch.Tensor)):
        return torch.clamp(x, lo, hi)
    return _min(_max(x, lo), hi)


# ---------------------------------------------------------------------------
# typed engine<->policy contract
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Signals:
    """Per-step feedback the engine feeds every policy; all path signals
    are delayed by the flow's base RTT."""
    ecn: torch.Tensor      # marked-traffic fraction seen along the path (F,)
    rtt: torch.Tensor      # base RTT + queueing delay along the path    (F,)
    util: torch.Tensor     # max_l (tx_l/cap_l + q_l/(cap_l*T)), HPCC INT (F,)
    t: float               # sim time (float32 value)
    dt: float              # step size
    line: torch.Tensor     # line rate bytes/s                           (F,)
    base_rtt: torch.Tensor  # propagation-only RTT                       (F,)
    # recent loss fraction; 0.0 on a lossless fabric, where every policy
    # is a bitwise no-op on its loss branch
    loss: object = 0.0     # (F,) tensor or scalar 0.0

    def replace(self, **kw) -> "Signals":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class FlowCtx:
    """Per-flow context for ``Policy.init``: line rate, BDP and the
    schedule's static fan-in (flows sharing the most-contended link)."""
    line: torch.Tensor     # first-hop line rate bytes/s (F,)
    bdp: torch.Tensor      # line * base_rtt bytes       (F,)
    fanin: torch.Tensor    # static schedule fan-in      (F,)
    n_flows: int = 0       # flow count (== F, incl. padding)

    @classmethod
    def make(cls, line, bdp, fanin=None) -> "FlowCtx":
        line = torch.as_tensor(line, dtype=torch.float32)
        fanin = (torch.ones_like(line) if fanin is None
                 else _max(torch.as_tensor(
                     fanin, dtype=torch.float32, device=line.device), 1.0))
        return cls(line=line,
                   bdp=torch.as_tensor(bdp, dtype=torch.float32,
                                       device=line.device),
                   fanin=fanin, n_flows=int(line.shape[0]))


# ---------------------------------------------------------------------------
# declarative parameter spaces
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ParamSpec:
    """One CC/fabric parameter: default value + search-space metadata."""
    default: float
    lo: float | None = None
    hi: float | None = None
    scale: str = "linear"          # "linear" | "log"
    integer: bool = False
    init_baked: bool = False

    def __post_init__(self):
        if self.scale not in ("linear", "log"):
            raise ValueError(f"scale must be 'linear' or 'log', "
                             f"got {self.scale!r}")
        if self.scale == "log" and self.lo is not None and self.lo <= 0:
            raise ValueError("log-scale params need a positive lo bound")

    @property
    def bounded(self) -> bool:
        return self.lo is not None and self.hi is not None

    def clip(self, v: float) -> float:
        if self.lo is not None:
            v = max(v, self.lo)
        if self.hi is not None:
            v = min(v, self.hi)
        return v


def _specs(meta: dict, **defaults) -> dict:
    return {k: dataclasses.replace(meta[k], default=float(v))
            for k, v in defaults.items()}


@dataclasses.dataclass(frozen=True)
class Policy:
    name: str
    spec: dict                     # {param name: ParamSpec}
    init: Callable                 # FlowCtx -> dict of (F,) tensors
    update: Callable               # (params, state, Signals) -> (state, rate, win)
    wire_factor: float = 1.0       # per-packet header overhead (HPCC INT)
    kind: str = "rate"             # "rate" | "window"
    loss_aware: bool = False       # reacts to Signals.loss (lossy RoCE)
    kernel_id: int | None = None   # device function in the fused CUDA step
    members: tuple = ()            # stacked product policy: member labels

    @property
    def params(self) -> dict:
        return {k: s.default for k, s in self.spec.items()}

    @property
    def init_params(self) -> tuple:
        return tuple(k for k, s in self.spec.items() if s.init_baked)

    @property
    def tunable(self) -> tuple:
        return tuple(k for k, s in self.spec.items() if not s.init_baked)

    def param_spec(self, key: str) -> ParamSpec:
        try:
            return self.spec[key]
        except KeyError:
            raise KeyError(f"unknown {self.name} param {key!r}; known: "
                           f"{sorted(self.spec)}") from None

    def check_tunable(self, keys):
        """Reject params that cc_params cannot actually influence."""
        unknown = set(keys) - set(self.spec)
        if unknown:
            raise ValueError(
                f"unknown {self.name} params {sorted(unknown)}; tunable: "
                f"{sorted(self.tunable)}")
        baked = [k for k in keys if self.spec[k].init_baked]
        if baked:
            raise ValueError(
                f"{self.name} params {sorted(baked)} are consumed by init "
                "(baked into the starting state) and cannot be overridden "
                "via cc_params; rebuild the policy via its factory instead")


def _full(like: torch.Tensor, v) -> torch.Tensor:
    return torch.full(like.shape, v, dtype=torch.float32, device=like.device)


# fixed policy ids of the fused step kernel's device functions
KERNEL_POLICY_ID = {"pfc": 0, "dcqcn": 1, "dctcp": 2, "timely": 3,
                    "hpcc": 4, "hpcc_pint": 5, "static_window": 6, "mlp": 7}


# ---------------------------------------------------------------------------
# Baseline: PFC only (no end-to-end CC; link-layer pauses do the work)
# ---------------------------------------------------------------------------

def make_pfc_only() -> Policy:
    def init(ctx):
        return {}

    def update(params, st, sig):
        return st, sig.line, _full(sig.line, INF)

    return Policy("pfc", {}, init, update, kind="rate",
                  kernel_id=KERNEL_POLICY_ID["pfc"])


# ---------------------------------------------------------------------------
# DCQCN (Zhu et al., SIGCOMM'15)
# ---------------------------------------------------------------------------

_DCQCN_SPECS = {
    "g": ParamSpec(1 / 256, lo=1e-4, hi=1.0, scale="log"),
    "rai_frac": ParamSpec(0.03, lo=1e-4, hi=0.5, scale="log"),
    "rhai_frac": ParamSpec(0.05, lo=1e-4, hi=1.0, scale="log"),
    "timer": ParamSpec(55e-6, lo=1e-6, hi=5e-3, scale="log"),
    "cut_gap": ParamSpec(50e-6, lo=1e-6, hi=5e-3, scale="log"),
    "fast_rounds": ParamSpec(5, lo=0, hi=20, integer=True),
    "hai_after": ParamSpec(5, lo=0, hi=20, integer=True),
    "ecn_thresh": ParamSpec(0.01, lo=1e-4, hi=1.0, scale="log"),
    "mss": ParamSpec(1000.0, lo=256.0, hi=9000.0, scale="log"),
}


def dcqcn_jitter(n_flows: int, device=None) -> torch.Tensor:
    """The +-10% per-flow timer jitter, computed in float32 exactly as the
    reference writes it: above F = 2^24 / 7919 the product rounds, so an
    integer formula would give other values."""
    f = torch.arange(n_flows, dtype=torch.float32, device=device) * 7919
    return 0.9 + 0.2 * (torch.fmod(f, 97) / 97.0)


def make_dcqcn(g: float = 1 / 256, rai_frac: float = 0.03,
               rhai_frac: float = 0.05, timer: float = 55e-6,
               cut_gap: float = 50e-6, fast_rounds: int = 5,
               hai_after: int = 5, ecn_thresh: float = 0.01,
               mss: float = 1000.0) -> Policy:
    spec = _specs(_DCQCN_SPECS, g=g, rai_frac=rai_frac, rhai_frac=rhai_frac,
                  timer=timer, cut_gap=cut_gap, fast_rounds=fast_rounds,
                  hai_after=hai_after, ecn_thresh=ecn_thresh, mss=mss)

    def init(ctx):
        line = ctx.line
        return {
            "rc": _full(line, 0) + line, "rt": _full(line, 0) + line,
            "alpha": _full(line, 1.0),
            "jit": dcqcn_jitter(ctx.n_flows, line.device),
            "t_cut": _full(line, -1.0), "t_inc": _full(line, 0.0),
            "t_alpha": _full(line, 0.0), "inc_count": _full(line, 0.0),
        }

    def update(p, st, sig):
        t, line = sig.t, sig.line
        # P(>=1 CNP per window) = 1 - exp(-pkts_in_window * mark_prob)
        jit = st["jit"]
        pkts = sdiv(st["rc"] * p["cut_gap"], p["mss"])
        # lossy RoCE: NACK-driven cuts — treat loss like extra marking
        ecn_eff = _loss_ecn(sig)
        p_cnp = 1.0 - expf(-pkts * ecn_eff)
        cong = p_cnp > p["ecn_thresh"]
        docut = cong & ((t - st["t_cut"]) >= p["cut_gap"] * jit)
        rt = torch.where(docut, st["rc"], st["rt"])
        rc = torch.where(docut, st["rc"] * fma(-(st["alpha"] / 2), p_cnp, 1.0),
                         st["rc"])
        alpha = torch.where(docut,
                            fma(fma(_f32(-p["g"]), p_cnp, 1.0), st["alpha"],
                                p["g"] * p_cnp),
                            st["alpha"])
        t_cut = torch.where(docut, t, st["t_cut"])
        inc_count = torch.where(docut, 0.0, st["inc_count"])
        t_inc = torch.where(docut, t, st["t_inc"])

        # alpha decay when no CNP for `timer`
        dodec = (~cong) & ((t - st["t_alpha"]) >= p["timer"] * jit)
        alpha = torch.where(dodec, _f32(1 - p["g"]) * alpha, alpha)
        t_alpha = torch.where(dodec | docut, t, st["t_alpha"])

        # rate increase every `timer`: fast recovery -> additive -> hyper
        doinc = (t - t_inc) >= p["timer"] * jit
        inc_count = torch.where(doinc, inc_count + 1, inc_count)
        additive = inc_count > p["fast_rounds"]
        hyper = inc_count > _f32(p["fast_rounds"] + p["hai_after"])
        frac = torch.where(hyper, _f32(p["rhai_frac"]), _f32(p["rai_frac"]))
        rt = torch.where(doinc & additive, fma(frac, line, rt), rt)
        rc = torch.where(doinc, 0.5 * (rt + rc), rc)
        t_inc = torch.where(doinc, t, t_inc)

        rc = _clip(rc, 0.001 * line, line)
        rt = _clip(rt, 0.001 * line, line)
        st2 = {"rc": rc, "rt": rt, "alpha": alpha, "jit": jit, "t_cut": t_cut,
               "t_inc": t_inc, "t_alpha": t_alpha, "inc_count": inc_count}
        return st2, rc, _full(rc, INF)

    return Policy("dcqcn", spec, init, update, kind="rate", loss_aware=True,
                  kernel_id=KERNEL_POLICY_ID["dcqcn"])


# ---------------------------------------------------------------------------
# DCTCP (Alizadeh et al., SIGCOMM'10), line-rate start as in HPCC's port
# ---------------------------------------------------------------------------

_DCTCP_SPECS = {
    "g": ParamSpec(1 / 16, lo=1e-3, hi=1.0, scale="log"),
    "mss": ParamSpec(1000.0, lo=256.0, hi=9000.0, scale="log"),
    "ecn_thresh": ParamSpec(0.01, lo=1e-4, hi=1.0, scale="log"),
    "wmax_bdp": ParamSpec(32.0, lo=1.0, hi=128.0, scale="log"),
}


def make_dctcp(g: float = 1 / 16, mss: float = 1000.0,
               ecn_thresh: float = 0.01, wmax_bdp: float = 32.0) -> Policy:
    spec = _specs(_DCTCP_SPECS, g=g, mss=mss, ecn_thresh=ecn_thresh,
                  wmax_bdp=wmax_bdp)

    def init(ctx):
        return {"w": ctx.bdp * 1.0, "alpha": _full(ctx.line, 0.0),
                "t_rtt": _full(ctx.line, 0.0), "bdp": ctx.bdp.clone()}

    def update(p, st, sig):
        t = sig.t
        rtt = _max(sig.rtt, 1e-6)
        do = (t - st["t_rtt"]) >= rtt
        ecn_eff = _loss_ecn(sig)
        alpha = torch.where(do, fma(_f32(1 - p["g"]), st["alpha"],
                                    p["g"] * ecn_eff), st["alpha"])
        marked = ecn_eff > p["ecn_thresh"]
        w = torch.where(do & marked, st["w"] * (1 - alpha / 2), st["w"])
        w = torch.where(do & ~marked, w + p["mss"], w)
        t_rtt = torch.where(do, t, st["t_rtt"])
        w = _clip(w, p["mss"], p["wmax_bdp"] * st["bdp"])
        rate = sig.line
        return ({"w": w, "alpha": alpha, "t_rtt": t_rtt, "bdp": st["bdp"]},
                rate, w)

    return Policy("dctcp", spec, init, update, kind="window",
                  loss_aware=True, kernel_id=KERNEL_POLICY_ID["dctcp"])


# ---------------------------------------------------------------------------
# TIMELY (Mittal et al., SIGCOMM'15)
# ---------------------------------------------------------------------------

_TIMELY_SPECS = {
    "tlow": ParamSpec(30e-6, lo=1e-6, hi=1e-3, scale="log"),
    "thigh": ParamSpec(300e-6, lo=1e-5, hi=1e-2, scale="log"),
    "beta": ParamSpec(0.8, lo=0.01, hi=1.0, scale="linear"),
    "add_frac": ParamSpec(0.002, lo=1e-5, hi=0.1, scale="log"),
    "ewma": ParamSpec(0.3, lo=0.01, hi=1.0, scale="linear"),
    "hai_thresh": ParamSpec(5, lo=1, hi=20, integer=True),
}


def make_timely(tlow: float = 30e-6, thigh: float = 300e-6, beta: float = 0.8,
                add_frac: float = 0.002, ewma: float = 0.3,
                hai_thresh: int = 5) -> Policy:
    spec = _specs(_TIMELY_SPECS, tlow=tlow, thigh=thigh, beta=beta,
                  add_frac=add_frac, ewma=ewma, hai_thresh=hai_thresh)

    def init(ctx):
        return {"rate": _full(ctx.line, 0) + ctx.line,
                "rtt_prev": _full(ctx.line, 0.0),
                "grad": _full(ctx.line, 0.0), "t_upd": _full(ctx.line, 0.0),
                "neg_count": _full(ctx.line, 0.0)}

    def update(p, st, sig):
        t = sig.t
        line = sig.line
        rtt = sig.rtt
        minrtt = _max(sig.base_rtt, 1e-6)
        period = _max(minrtt, 20e-6)
        do = (t - st["t_upd"]) >= period

        grad_new = (rtt - st["rtt_prev"]) / minrtt
        grad = torch.where(do, fma(_f32(1 - p["ewma"]), st["grad"],
                                   p["ewma"] * grad_new), st["grad"])
        delta = p["add_frac"] * line
        neg = torch.where(do & (grad <= 0), st["neg_count"] + 1, 0.0)
        hai = neg >= p["hai_thresh"]

        r = st["rate"]
        r_low = r + torch.where(hai, 5.0 * delta, delta)
        beta = _f32(p["beta"])
        r_high = r * fma(-beta, 1 - rdiv(p["thigh"], _max(rtt, p["thigh"])), 1.0)
        gnorm = _clip(grad, 0.0, 1.0)
        r_grad = torch.where(grad <= 0,
                             fma(torch.where(hai, 5.0, 1.0), delta, r),
                             r * fma(-beta, gnorm, 1.0))
        r_new = torch.where(rtt < p["tlow"], r_low,
                            torch.where(rtt > p["thigh"], r_high, r_grad))
        rate = torch.where(do, _clip(r_new, 0.001 * line, line), r)
        # lossy RoCE: a multiplicative cut on update ticks, scaled by loss
        if _lossy(sig):
            rate = torch.where(
                (sig.loss > 0) & do,
                _clip(rate * fma(-beta, _min(2.0 * sig.loss, 1.0), 1.0),
                      0.001 * line, line),
                rate)
        rtt_prev = torch.where(do, rtt, st["rtt_prev"])
        t_upd = torch.where(do, t, st["t_upd"])
        st2 = {"rate": rate, "rtt_prev": rtt_prev, "grad": grad,
               "t_upd": t_upd, "neg_count": neg}
        return st2, rate, _full(rate, INF)

    return Policy("timely", spec, init, update, kind="rate",
                  loss_aware=True, kernel_id=KERNEL_POLICY_ID["timely"])


# ---------------------------------------------------------------------------
# HPCC (Li et al., SIGCOMM'19) — INT-based; +4.8% wire overhead
# ---------------------------------------------------------------------------

_HPCC_SPECS = {
    "eta": ParamSpec(0.95, lo=0.5, hi=1.0, scale="linear"),
    "wai_frac": ParamSpec(0.001, lo=1e-5, hi=0.1, scale="log"),
    "max_stage": ParamSpec(5, lo=0, hi=20, integer=True),
}


def _hpcc_update(p, st, sig):
    t = sig.t
    u = _max(sig.util, 1e-3)
    # lossy RoCE: force u above eta so the window takes the multiplicative
    # branch
    if _lossy(sig):
        u = torch.where(sig.loss > 0, torch.maximum(u, 1.0 + 2.0 * sig.loss),
                        u)
    wai = p["wai_frac"] * st["bdp"]
    # the reference's compiled step leaves this sum unfused (measured at
    # the 128-GPU scale), while it contracts the additive window below
    mult = st["wc"] * rdiv(p["eta"], u) + wai
    addv = fma(_f32(p["wai_frac"]), st["bdp"], st["wc"])
    use_mult = (u >= p["eta"]) | (st["stage"] >= p["max_stage"])
    w = torch.where(use_mult, mult, addv)
    w = _clip(w, wai, 16.0 * st["bdp"])
    rtt = _max(sig.base_rtt, 1e-6)
    do = (t - st["t_rtt"]) >= rtt
    wc = torch.where(do, w, st["wc"])
    stage = torch.where(do, torch.where(use_mult, 0.0, st["stage"] + 1),
                        st["stage"])
    t_rtt = torch.where(do, t, st["t_rtt"])
    rate = w / rtt
    st2 = {"w": w, "wc": wc, "t_rtt": t_rtt, "stage": stage,
           "bdp": st["bdp"]}
    return st2, torch.minimum(rate, sig.line), w


def _hpcc_init(ctx):
    return {"w": ctx.bdp * 1.0, "wc": ctx.bdp * 1.0,
            "t_rtt": _full(ctx.line, 0.0), "stage": _full(ctx.line, 0.0),
            "bdp": ctx.bdp.clone()}


def make_hpcc(eta: float = 0.95, wai_frac: float = 0.001, max_stage: int = 5,
              wire_factor: float = 1.048) -> Policy:
    spec = _specs(_HPCC_SPECS, eta=eta, wai_frac=wai_frac,
                  max_stage=max_stage)
    return Policy("hpcc", spec, _hpcc_init, _hpcc_update,
                  wire_factor=wire_factor, kind="window", loss_aware=True,
                  kernel_id=KERNEL_POLICY_ID["hpcc"])


def make_hpcc_pint(eta: float = 0.95, wai_frac: float = 0.001,
                   max_stage: int = 5) -> Policy:
    """HPCC with probabilistic INT: ~1 byte overhead, coarser feedback
    (modelled as 2x slower reference-window refresh)."""
    spec = _specs(_HPCC_SPECS, eta=eta, wai_frac=wai_frac,
                  max_stage=max_stage)

    def update(p, st, sig):
        sig = sig.replace(base_rtt=sig.base_rtt * 2.0)  # delayed feedback
        return _hpcc_update(p, st, sig)

    return Policy("hpcc_pint", spec, _hpcc_init, update, wire_factor=1.001,
                  kind="window", loss_aware=True,
                  kernel_id=KERNEL_POLICY_ID["hpcc_pint"])


# ---------------------------------------------------------------------------
# StaticWindow — the paper's §IV-E proposal
# ---------------------------------------------------------------------------

_STATIC_WINDOW_SPECS = {
    "margin": ParamSpec(2.0, lo=0.1, hi=32.0, scale="log", init_baked=True),
    "headroom": ParamSpec(0.5e6, lo=1e3, hi=64e6, scale="log",
                          init_baked=True),
    "min_w": ParamSpec(4000.0, lo=100.0, hi=1e6, scale="log",
                       init_baked=True),
}


def make_static_window(margin: float = 2.0, headroom: float = 0.5e6,
                       min_w: float = 4000.0) -> Policy:
    """Windows set statically from the deterministic schedule:
    W = margin*BDP/fanin + headroom/fanin, no feedback at all."""
    spec = _specs(_STATIC_WINDOW_SPECS, margin=margin, headroom=headroom,
                  min_w=min_w)

    def init(ctx):
        f = ctx.fanin
        w = margin * ctx.bdp / f + rdiv(headroom, f)
        return {"w": _max(w, min_w)}

    def update(p, st, sig):
        return st, sig.line, st["w"]

    return Policy("static_window", spec, init, update, kind="window",
                  kernel_id=KERNEL_POLICY_ID["static_window"])


def make_mlp(**kw) -> Policy:
    """The learned policy (``repro_torch.learn.net``), imported here on
    first use: that module imports this one's types."""
    from repro_torch.learn.net import make_mlp as _mk
    return _mk(**kw)


REGISTRY = {
    "pfc": make_pfc_only,
    "dcqcn": make_dcqcn,
    "dctcp": make_dctcp,
    "timely": make_timely,
    "hpcc": make_hpcc,
    "hpcc_pint": make_hpcc_pint,
    "static_window": make_static_window,
    "mlp": make_mlp,
}

ALL_POLICIES = tuple(REGISTRY)


def get_policy(name: str, **kw) -> Policy:
    try:
        factory = REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown policy {name!r}; the port has "
                       f"{sorted(REGISTRY)}") from None
    return factory(**kw)


# ---------------------------------------------------------------------------
# the policy axis: one product policy over several members
# ---------------------------------------------------------------------------

def stack_labels(policies) -> list:
    """Unique member labels for a policy stack (name, or name<i> on
    duplicates): the namespace prefix of the stacked param table."""
    names = [p if isinstance(p, str) else p.name for p in policies]
    return [n if names.count(n) == 1 else f"{n}{i}"
            for i, n in enumerate(names)]


def stack_policies(policies) -> Policy:
    """Product policy over ``policies`` (names or Policy objects).

    State is the tuple of every member's state.  ``update`` evaluates every
    member on every lane and selects per lane by the ``_which`` parameter,
    as the reference's ``lax.switch`` does under ``vmap``: member ``i``'s
    state changes only on the lanes that select it.  Member params are
    namespaced ``"<label>.<param>"``; ``_wire`` carries the selected
    member's wire factor (HPCC's INT overhead), which the engine reads per
    lane.  The product has no device function: it runs on the op path.
    """
    members = [get_policy(p) if isinstance(p, str) else p for p in policies]
    if len(members) < 2:
        raise ValueError("stack_policies needs at least two policies")
    labels = stack_labels(members)
    n = len(members)

    spec = {
        "_which": ParamSpec(0, lo=0, hi=n - 1, integer=True),
        "_wire": ParamSpec(float(members[0].wire_factor),
                           lo=1.0, hi=1.1, scale="linear"),
    }
    for lab, m in zip(labels, members):
        for k, s in m.spec.items():
            spec[f"{lab}.{k}"] = s

    def init(ctx):
        return tuple(m.init(ctx) for m in members)

    def update(p, st, sig):
        # lax.switch takes the integer part of the selector, clamped
        which = torch.clamp(torch.as_tensor(
            p["_which"], device=sig.line.device).to(torch.int32), 0, n - 1)
        new_st, rate, win = list(st), None, None
        for i, (lab, m) in enumerate(zip(labels, members)):
            sub, r, w = m.update({k: p[f"{lab}.{k}"] for k in m.spec},
                                 st[i], sig)
            sel = which == i
            new_st[i] = {k: torch.where(sel, v, st[i][k])
                         for k, v in sub.items()}
            rate = r if rate is None else torch.where(sel, r, rate)
            win = w if win is None else torch.where(sel, w, win)
        return tuple(new_st), rate, win

    return Policy(name="stack(" + "+".join(labels) + ")", spec=spec,
                  init=init, update=update, kind="mixed",
                  loss_aware=any(m.loss_aware for m in members),
                  members=tuple(labels))


# ---------------------------------------------------------------------------
# the kernel ABI: state -> (K, F) and params -> (P,), both in sorted-key
# order, as the reference's ``kernel_state_keys``/``kernel_param_keys``
# ---------------------------------------------------------------------------

_KERNEL_KEYS_CACHE: dict = {}


def kernel_state_keys(policy: Policy):
    """Sorted state-key order, or ``None`` if ``init`` does not return a
    dict of (F,) float32 tensors.  Probes ``init`` on an 8-flow context
    (memoized per policy logic and defaults)."""
    ck = (policy.name, getattr(policy.init, "__code__", policy.init),
          tuple(sorted((k, float(v)) for k, v in policy.params.items())))
    if ck not in _KERNEL_KEYS_CACHE:
        _KERNEL_KEYS_CACHE[ck] = _probe_state_keys(policy)
    return _KERNEL_KEYS_CACHE[ck]


def _probe_state_keys(policy: Policy):
    line = torch.full((8,), 25e9, dtype=torch.float32)
    probe = policy.init(FlowCtx(line=line, bdp=line * 5e-6,
                                fanin=torch.ones(8), n_flows=8))
    if (isinstance(probe, dict)
            and all(isinstance(v, torch.Tensor) and v.shape == (8,)
                    and v.dtype == torch.float32 for v in probe.values())):
        return tuple(sorted(probe))
    return None


def kernel_param_keys(policy: Policy) -> tuple:
    """Sorted param order for the packed (P,) kernel param vector."""
    return tuple(sorted(policy.spec))


def pack_state(policy: Policy, state: dict, n_flows: int | None = None,
               device=None) -> torch.Tensor:
    """dict of (F,) float32 -> (K, F) in ``kernel_state_keys`` order;
    a stateless policy gets one dummy zero row sized by ``n_flows``."""
    keys = kernel_state_keys(policy)
    if keys is None:
        raise ValueError(f"policy {policy.name!r} is not kernel-eligible")
    if not keys:
        if n_flows is None:
            raise ValueError("pack_state needs n_flows for a stateless "
                             "policy")
        return torch.zeros((1, n_flows), dtype=torch.float32, device=device)
    return torch.stack([state[k].to(torch.float32) for k in keys])


def unpack_state(policy: Policy, packed: torch.Tensor) -> dict:
    """(K, F) -> dict in ``kernel_state_keys`` order (inverse of pack)."""
    keys = kernel_state_keys(policy)
    if keys is None:
        raise ValueError(f"policy {policy.name!r} is not kernel-eligible")
    return {k: packed[j] for j, k in enumerate(keys)}


def pack_params(policy: Policy, params: dict | None = None,
                device=None, lanes: int | None = None) -> torch.Tensor:
    """Flat params dict -> (P,) float32 in ``kernel_param_keys`` order;
    P >= 1 (param-free policies get one dummy zero).  With ``lanes=B``
    the values may be per-lane (``(B,)`` arrays or ``(B, 1)`` columns;
    scalars broadcast) and the result is the ``(B, P)`` row per lane that
    the fused kernel reads.  Tensor values keep their autograd graph."""
    params = dict(policy.params, **(params or {}))
    keys = kernel_param_keys(policy)
    if lanes is None:
        if not keys:
            return torch.zeros((1,), dtype=torch.float32, device=device)
        if any(isinstance(params[k], torch.Tensor) for k in keys):
            return torch.stack([torch.as_tensor(
                params[k], dtype=torch.float32, device=device).reshape(())
                for k in keys])
        return torch.tensor([float(params[k]) for k in keys],
                            dtype=torch.float32, device=device)
    if not keys:
        return torch.zeros((lanes, 1), dtype=torch.float32, device=device)
    cols = [torch.as_tensor(params[k], dtype=torch.float32, device=device)
            .reshape(-1).expand(lanes) for k in keys]
    return torch.stack(cols, dim=1).contiguous()
