"""Fault-injection layer (port of ``repro.core.faults``): ``FaultSpec``,
its sweepable ``FAULT_PARAM_SPECS``, ``LaneStatus``, ``classify_lane``
and ``is_faulty``.

A ``FaultSpec`` injects time-scheduled fabric faults into the engine
(``repro_torch.core.engine``): random per-packet loss on fabric links with
IRN selective retransmit (``gbn=0``) or go-back-N (``gbn=1``) recovery,
link degradation over a window, periodic link flaps, ECN misconfiguration
(``ecn_scale``) and disabled PFC (``pfc_on=0``, the lossy-RoCE operating
point).  Leaves are scalars or per-link-class arrays indexed by
``topology.LINK_CLASSES`` (``loss_rate``, ``degrade``, ``ecn_scale``,
``pfc_on``; the engine expands each per class and gathers it per hop or
link once per run, as it does the fabric knobs), and stack on a leading
lane axis for ``SweepRunner.run_batch``/``grid(fault_grid=...)``.

The all-defaults spec is inert: ``is_faulty`` is False for it and the
engine then runs the lossless step, so lossless results are bit for bit
those without the fault layer.
"""
from __future__ import annotations

import dataclasses
import enum

import numpy as np

from repro_torch.core.cc import ParamSpec
from repro_torch.core.topology import LINK_CLASS_ID, N_LINK_CLASSES


class LaneStatus(str, enum.Enum):
    """Typed health verdict of one simulated lane (or serial run).

    Precedence (``classify_lane``): divergence trumps everything, an
    unfinished or finished lane that saw a pause cycle is ``DEADLOCKED``,
    an unfinished lane without one ran out of step budget (``EXHAUSTED``).
    """
    OK = "ok"
    DIVERGED = "diverged"
    DEADLOCKED = "deadlocked"
    EXHAUSTED = "exhausted"

    def __str__(self) -> str:          # f"{status}" -> "ok", not "LaneStatus.OK"
        return self.value


def classify_lane(diverged: bool, deadlocked: bool,
                  finished: bool) -> LaneStatus:
    """Map the engine's run-health observers onto one ``LaneStatus``."""
    if diverged:
        return LaneStatus.DIVERGED
    if deadlocked:
        return LaneStatus.DEADLOCKED
    if not finished:
        return LaneStatus.EXHAUSTED
    return LaneStatus.OK


_FAULT_DEFAULTS = dict(
    loss_rate=0.0, gbn=0.0, mtu=4096.0,
    degrade=1.0, degrade_t0=0.0, degrade_t1=0.0,
    flap_period=0.0, flap_down=0.0, flap_t0=0.0,
    ecn_scale=1.0, pfc_on=1.0,
)

# search spaces of the sweepable fault knobs, in the ParamSpec currency of
# the CC policies (consumed by grid drivers)
FAULT_PARAM_SPECS = {
    "loss_rate": ParamSpec(0.0, lo=0.0, hi=0.1, scale="linear"),
    "gbn": ParamSpec(0.0, lo=0.0, hi=1.0, integer=True),
    "mtu": ParamSpec(4096.0, lo=256.0, hi=9000.0, scale="log"),
    "degrade": ParamSpec(1.0, lo=0.01, hi=1.0, scale="linear"),
    "flap_period": ParamSpec(0.0, lo=0.0, hi=1.0, scale="linear"),
    "flap_down": ParamSpec(0.0, lo=0.0, hi=1.0, scale="linear"),
    "ecn_scale": ParamSpec(1.0, lo=0.0, hi=2.0, scale="linear"),
    "pfc_on": ParamSpec(1.0, lo=0.0, hi=1.0, integer=True),
}

RECOVERY_MODES = ("irn", "gbn")


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """Time-scheduled fabric faults.  Leaves are scalars or per-link-class
    ``(N_LINK_CLASSES,)`` arrays; the default instance is inert."""
    loss_rate: object = 0.0        # per-packet drop probability, fabric links
    gbn: object = 0.0              # recovery: 0 = IRN, 1 = go-back-N
    mtu: object = 4096.0           # packetization for the GBN resend model (B)
    degrade: object = 1.0          # capacity multiplier while degraded
    degrade_t0: object = 0.0       # degradation window [t0, t1) in seconds
    degrade_t1: object = 0.0
    flap_period: object = 0.0      # flap cycle length (s); 0 = no flapping
    flap_down: object = 0.0        # down time at the start of each cycle (s)
    flap_t0: object = 0.0          # first flap onset (s)
    ecn_scale: object = 1.0        # ECN marking-probability multiplier
    pfc_on: object = 1.0           # 0 disables PFC pausing (lossy RoCE)

    FIELDS = ("loss_rate", "gbn", "mtu", "degrade", "degrade_t0",
              "degrade_t1", "flap_period", "flap_down", "flap_t0",
              "ecn_scale", "pfc_on")

    @classmethod
    def check_fields(cls, keys):
        """Reject names that are not FaultSpec fields."""
        unknown = set(keys) - set(cls.FIELDS)
        if unknown:
            raise ValueError(f"unknown fault params {sorted(unknown)}; "
                             f"known: {list(cls.FIELDS)}")

    @classmethod
    def lossy_roce(cls, loss_rate: float, recovery: str = "irn",
                   pfc_on: bool = False, **kw) -> "FaultSpec":
        """Random loss, PFC off, and a named recovery model."""
        if recovery not in RECOVERY_MODES:
            raise ValueError(f"unknown recovery {recovery!r}; "
                             f"choose from {RECOVERY_MODES}")
        return cls(loss_rate=loss_rate, gbn=float(recovery == "gbn"),
                   pfc_on=float(bool(pfc_on)), **kw)

    def replace(self, **kw) -> "FaultSpec":
        return dataclasses.replace(self, **kw)

    def with_class(self, **field_overrides) -> "FaultSpec":
        """Per-link-class overrides:
        ``FaultSpec().with_class(loss_rate={"spine_down": 1e-3})``."""
        out = {}
        for field, overrides in field_overrides.items():
            base = np.broadcast_to(
                np.asarray(getattr(self, field), np.float32),
                (N_LINK_CLASSES,)).copy()
            for cls_name, v in overrides.items():
                base[LINK_CLASS_ID[cls_name]] = v
            out[field] = base
        return dataclasses.replace(self, **out)


def _as_fault(fault_spec) -> FaultSpec:
    return FaultSpec() if fault_spec is None else fault_spec


def is_faulty(flt: FaultSpec) -> bool:
    """Does this spec inject any fault at all?"""
    for f in FaultSpec.FIELDS:
        v = np.asarray(getattr(flt, f))
        if not np.all(v == _FAULT_DEFAULTS[f]):
            return True
    return False
