"""Extract the collective-communication schedule from compiled HLO (the
port's own copy of ``repro.core.hlo_comm``: plain ``re`` and
``dataclasses``, no jax).

This is the bridge between the *real* training framework and the paper's
network simulator: ``extract(lowered_text)`` parses every collective op
(all-reduce / all-gather / reduce-scatter / all-to-all / collective-permute)
out of the (possibly SPMD-partitioned) HLO, with operand bytes and replica
group structure, so ``core.predict`` can replay an architecture's actual
communication under each CC policy — generalizing the paper's DLRM-only
analysis to every arch in the zoo.  The same byte counts feed the
§Roofline collective term.
"""
from __future__ import annotations

import dataclasses
import re
from collections import defaultdict

_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "bf16": 2, "f16": 2,
    "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8, "f64": 8, "c64": 8,
    "c128": 16,
}

_COLL_KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")

# e.g.  %all-reduce.5 = f32[1024,512] all-reduce(...), replica_groups={{0,1},{2,3}}
_OP_RE = re.compile(
    r"=\s*((?:\(|)[a-z0-9\[\],{}() ]+?)\s+"
    r"(all-reduce-start|all-gather-start|reduce-scatter|all-to-all|"
    r"all-reduce|all-gather|collective-permute-start|collective-permute)"
    r"\(", re.I)

_SHAPE_RE = re.compile(r"(pred|bf16|f16|f32|f64|s8|u8|s16|u16|s32|u32|s64|u64|c64|c128)\[([0-9,]*)\]")

_GROUPS_RE = re.compile(r"replica_groups=\{(\{[0-9, ]+\}(?:,\{[0-9, ]+\})*)\}")
_GROUPS_IOTA_RE = re.compile(r"replica_groups=\[(\d+),(\d+)\]")


@dataclasses.dataclass(frozen=True)
class CollectiveOp:
    """Frozen (hashable) so HLO-replay scenario workloads can key the
    schedule memoization in ``scenario.ScenarioSpec.build``."""
    kind: str
    bytes_total: int        # sum of operand bytes (global, all shards)
    group_size: int         # participants per replica group
    n_groups: int
    count: int = 1          # duplicates (e.g. inside while loops x trip count)


def _shape_bytes(sig: str) -> int:
    total = 0
    for m in _SHAPE_RE.finditer(sig):
        dt, dims = m.groups()
        n = 1
        for d in dims.split(","):
            if d.strip():
                n *= int(d)
        total += n * _DTYPE_BYTES[dt]
    return total


def extract(hlo_text: str, trip_counts: dict | None = None) -> list[CollectiveOp]:
    """Parse collective ops out of HLO text.

    Note on loops: ops inside a `while` body appear once in the text; the
    scan trip count multiplies the actual traffic.  We detect the enclosing
    computation name and multiply by ``trip_counts[name]`` when provided;
    benchmarks pass the layer count for the scan body.
    """
    ops: list[CollectiveOp] = []
    for line in hlo_text.splitlines():
        m = _OP_RE.search(line)
        if m is None:
            continue
        sig, kind = m.groups()
        kind = kind.replace("-start", "")
        nbytes = _shape_bytes(sig)
        gm = _GROUPS_RE.search(line)
        if gm:
            groups = gm.group(1)
            first = groups.split("},")[0].strip("{}")
            gsize = len([x for x in first.split(",") if x.strip()])
            ngroups = groups.count("{")
        else:
            im = _GROUPS_IOTA_RE.search(line)
            if im:
                ngroups, gsize = int(im.group(1)), int(im.group(2))
            else:
                gsize, ngroups = 0, 1
        ops.append(CollectiveOp(kind, nbytes, gsize, ngroups))
    return ops


def summarize(ops: list[CollectiveOp]) -> dict:
    """Aggregate bytes by collective kind."""
    agg: dict = defaultdict(float)
    for op in ops:
        agg[op.kind] += op.bytes_total * op.count
    agg["total"] = sum(v for k, v in agg.items() if k != "total")
    return dict(agg)


def collective_link_bytes(ops: list[CollectiveOp], algo_bytes_factor: dict | None = None) -> float:
    """Wire bytes actually moved per chip group, using standard algorithm
    costs: ring all-reduce moves 2(n-1)/n x data, all-gather/reduce-scatter
    (n-1)/n, all-to-all (n-1)/n, permute 1x."""
    factors = {"all-reduce": lambda n: 2 * (n - 1) / max(n, 1),
               "all-gather": lambda n: (n - 1) / max(n, 1),
               "reduce-scatter": lambda n: (n - 1) / max(n, 1),
               "all-to-all": lambda n: (n - 1) / max(n, 1),
               "collective-permute": lambda n: 1.0}
    if algo_bytes_factor:
        factors.update(algo_bytes_factor)
    total = 0.0
    for op in ops:
        n = max(op.group_size, 1)
        total += op.bytes_total * op.count * factors[op.kind](n)
    return total
