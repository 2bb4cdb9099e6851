"""Trip-count-aware structural profiler over compiled HLO text (the
port's own copy of ``repro.core.hlo_counter``: plain ``re``,
``dataclasses`` and ``collections``, no jax), so the port reads the
reference's compiled dry runs without jax; ``repro_torch.launch.dryrun``
gives the port's own record in the same ``Totals`` terms.

XLA's HloCostAnalysis counts `while` (scan) bodies ONCE, so scanned-layer /
grad-accumulation programs under-report FLOPs, bytes and collective traffic
by their trip counts.  This module rebuilds the call graph from the HLO
text (fusion / call / while / conditional), reads each while's trip count
(XLA's ``known_trip_count`` backend config), and aggregates bottom-up with
trip multiplication:

* ``flops``       — dot FLOPs: 2 * prod(output_dims) * contracted_size.
                    Exact for matmuls (validated vs analytic counts);
                    elementwise FLOPs deliberately ignored (MXU dominates).
* ``coll``        — collective bytes by kind (operand bytes of all-reduce /
                    all-gather / reduce-scatter / all-to-all / c-permute).
* ``bytes``       — per-touch upper bound: every non-free op charged
                    operands+output (what a non-fusing backend would move).
* ``bytes_floor`` — write-once floor: every materialized intermediate
                    charged once (its output), computation parameters
                    charged once per execution with *slice discounts*
                    (a stacked weight array consumed only through
                    dynamic-slice — directly or transitively through a
                    fusion — is charged at slice size: per-layer weight
                    reads inside a scan, not the whole stack).  Reads of
                    already-materialized intermediates are free (perfect
                    fusion).  True traffic lies between floor and upper.

Validated in tests/test_hlo_tools.py; the port's copy against the
reference's in tests/test_torch_hlo_counter.py.
"""
from __future__ import annotations

import dataclasses
import re
from collections import defaultdict

_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "bf16": 2, "f16": 2,
    "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8, "f64": 8,
    "c64": 8, "c128": 16, "s4": 1, "u4": 1, "f8e4m3fn": 1, "f8e5m2": 1,
}

_SHAPE_RE = re.compile(r"\b([a-z0-9]+)\[([0-9,]*)\]")
_NAME_RE = re.compile(r"^\s*(?:ROOT\s+)?%([\w.\-]+)\s*=")
_OPND_RE = re.compile(r"%([\w.\-]+)")
_CALL_RE = re.compile(r"(?:calls|to_apply|body)=%?([\w.\-]+)")
_COND_RE = re.compile(r"condition=%?([\w.\-]+)")
_BRANCH_RE = re.compile(r"branch_computations=\{([^}]*)\}")
_CONST_RE = re.compile(r"constant\((\d+)\)")
_TRIP_RE = re.compile(r"known_trip_count[^0-9]*(\d+)")
_PARAM_RE = re.compile(r"=\s*[a-z0-9(][^=]*?parameter\((\d+)\)")
_OP_KIND_RE = re.compile(
    r"=\s*(?:\([^=]*\)|[a-z0-9]+\[[0-9,]*\](?:\{[^}]*\})?)\s*([a-z0-9\-]+)\(")
_COMMENT_RE = re.compile(r"/\*.*?\*/")

_COLLS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
          "collective-permute")
_FREE_OPS = {"get-tuple-element", "tuple", "parameter", "constant", "bitcast",
             "bitcast-convert", "after-all", "partition-id", "replica-id",
             "iota"}
_SLICE_OPS = {"dynamic-slice", "slice", "gather"}
# ops whose output is necessarily materialized to HBM even under fusion
_MATERIALIZE = {"dot", "convolution", "sort", "copy", "custom-call",
                "rng", "rng-bit-generator", "cholesky", "triangular-solve",
                "select-and-scatter", "reduce-window",
                *_SLICE_OPS, *_COLLS}


def _shape_list(text: str):
    out = []
    for m in _SHAPE_RE.finditer(text):
        dt, dims = m.groups()
        if dt not in _DTYPE_BYTES:
            continue
        n = 1
        for d in dims.split(","):
            if d.strip():
                n *= int(d)
        out.append((dt, n))
    return out


def _nbytes(shapes) -> float:
    return float(sum(n * _DTYPE_BYTES[dt] for dt, n in shapes))


@dataclasses.dataclass
class Comp:
    flops: float = 0.0
    bytes: float = 0.0
    bytes_floor: float = 0.0
    coll: dict = dataclasses.field(default_factory=lambda: defaultdict(float))
    children: list = dataclasses.field(default_factory=list)  # (name, kind, trip|None)
    max_const: int = 0
    param_charge: dict = dataclasses.field(default_factory=dict)  # idx -> bytes


def _split_computations(text: str) -> dict[str, list[str]]:
    comps: dict[str, list[str]] = {}
    cur = None
    for raw in text.splitlines():
        if raw and raw[0] not in " \t}":
            m = re.match(r"^(?:ENTRY\s+)?%([\w.\-]+)\s*\(", raw)
            if m and raw.rstrip().endswith("{"):
                cur = ("ENTRY::" if raw.startswith("ENTRY") else "") + m.group(1)
                comps[cur] = []
                continue
        if cur is not None:
            if raw.strip() == "}":
                cur = None
            else:
                comps[cur].append(_COMMENT_RE.sub("", raw))
    return comps


def parse(text: str) -> dict[str, Comp]:
    raw_comps = _split_computations(text)
    out: dict[str, Comp] = {}

    for cname, lines in raw_comps.items():  # callees precede callers in HLO
        c = Comp()
        shapes_of: dict[str, list] = {}
        param_names: dict[str, int] = {}
        op_rows = []  # (name, kind, opnd_names, out_bytes, line)

        for ln in lines:
            nm = _NAME_RE.match(ln)
            if not nm:
                cm = _CONST_RE.search(ln)
                if cm:
                    c.max_const = max(c.max_const, int(cm.group(1)))
                continue
            name = nm.group(1)
            head = ln.split("=", 1)[1]
            i = head.find("(")
            shapes_of[name] = _shape_list(head[:i] if i > 0 else head)
            pm = _PARAM_RE.search(ln)
            km = _OP_KIND_RE.search(ln)
            kind = km.group(1).replace("-start", "") if km else None
            if pm and kind == "parameter":
                param_names[name] = int(pm.group(1))
            cm = _CONST_RE.search(ln)
            if cm:
                c.max_const = max(c.max_const, int(cm.group(1)))
            if kind is None:
                continue
            args_txt = ln.split("(", 1)[1].split("), ")[0]
            opnds = _OPND_RE.findall(args_txt)
            op_rows.append((name, kind, opnds, _nbytes(shapes_of[name]), ln))

        # ---- param consumer analysis (slice-transitive through fusions) ----
        slice_reads = {n: 0.0 for n in param_names}
        full_read = {n: False for n in param_names}
        for name, kind, opnds, out_b, ln in op_rows:
            for pos, o in enumerate(opnds):
                if o not in param_names:
                    continue
                if kind in _SLICE_OPS:
                    slice_reads[o] += out_b
                elif kind == "fusion":
                    cal = _CALL_RE.search(ln)
                    callee = out.get(cal.group(1)) if cal else None
                    real_pos = len([x for x in opnds[:pos] if x in shapes_of])
                    if callee is not None and real_pos in callee.param_charge:
                        slice_reads[o] += callee.param_charge[real_pos]
                    else:
                        full_read[o] = True
                elif kind in ("get-tuple-element", "tuple", "bitcast", "parameter"):
                    continue
                else:
                    full_read[o] = True
        for n, idx in param_names.items():
            full = _nbytes(shapes_of.get(n, []))
            c.param_charge[idx] = full if full_read[n] else min(slice_reads[n], full)
        # execution charge for reading this computation's inputs once
        c.bytes_floor += sum(c.param_charge.values())

        # ---- per-op charges -------------------------------------------------
        for name, kind, opnds, out_b, ln in op_rows:
            known = [o for o in opnds if o in shapes_of]
            opnd_b = sum(_nbytes(shapes_of[o]) for o in known)

            if kind == "dot":
                mm = re.search(r"lhs_contracting_dims=\{([0-9,]*)\}", ln)
                lhs_dims = _dims_of(lines, known[0]) if known else None
                if mm and lhs_dims is not None:
                    csize = 1
                    for ci in (int(x) for x in mm.group(1).split(",") if x.strip()):
                        if ci < len(lhs_dims):
                            csize *= lhs_dims[ci]
                    nout = sum(n for _, n in shapes_of.get(name, []))
                    c.flops += 2.0 * nout * csize
            if kind in _COLLS:
                c.coll[kind] += opnd_b

            # call edges
            if kind == "while":
                b = _CALL_RE.search(ln)
                tm = _TRIP_RE.search(ln)
                cd = _COND_RE.search(ln)
                trip = int(tm.group(1)) if tm else (cd.group(1) if cd else None)
                if b:
                    c.children.append((b.group(1), "while", trip))
            elif kind == "fusion":
                b = _CALL_RE.search(ln)
                if b:
                    c.children.append((b.group(1), "fusion", None))
            elif kind in ("call", "custom-call", "async-start"):
                b = _CALL_RE.search(ln)
                if b:
                    c.children.append((b.group(1), "call", None))
            elif kind == "conditional":
                bm = _BRANCH_RE.search(ln)
                if bm:
                    for br in bm.group(1).split(","):
                        c.children.append((br.strip().lstrip("%"), "call", None))

            # byte charges
            if kind in _FREE_OPS or kind == "while":
                continue
            if kind in _SLICE_OPS:
                c.bytes += 2.0 * out_b
            elif kind in ("dynamic-update-slice", "scatter"):
                upd = _nbytes(shapes_of[known[-1]]) if known else out_b
                c.bytes += 3.0 * upd
                c.bytes_floor += 3.0 * upd
            else:
                c.bytes += opnd_b + out_b
            if kind in _MATERIALIZE or kind == "fusion":
                c.bytes_floor += out_b
        out[cname] = c
    return out


def _dims_of(lines, name):
    pat = re.compile(r"%" + re.escape(name) + r"\s*=\s*[a-z0-9]+\[([0-9,]*)\]")
    for ln in lines:
        m = pat.search(ln)
        if m:
            return [int(d) for d in m.group(1).split(",") if d.strip()]
    return None


@dataclasses.dataclass
class Totals:
    flops: float
    bytes: float
    coll: dict
    bytes_floor: float = 0.0


def totals(hlo_text: str) -> Totals:
    comps = parse(hlo_text)
    alias = {n.split("::")[-1]: n for n in comps}
    entry = next((n for n in comps if n.startswith("ENTRY::")), None) or next(iter(comps))
    memo: dict[str, tuple] = {}

    def trip(t) -> int:
        if t is None:
            return 1
        if isinstance(t, int):
            return max(t, 1)
        c = comps.get(alias.get(t, t))
        return max(c.max_const, 1) if c else 1

    def rec(name: str, depth=0):
        full = alias.get(name, name)
        if full in memo:
            return memo[full]
        if full not in comps or depth > 128:
            return (0.0, 0.0, 0.0, {})
        memo[full] = (0.0, 0.0, 0.0, {})  # cycle guard
        t = comps[full]
        f, b, bf = t.flops, t.bytes, t.bytes_floor
        coll = dict(t.coll)
        for child, kind, cond in t.children:
            cf, cb, cbf, cc = rec(child, depth + 1)
            mult = trip(cond) if kind == "while" else 1
            f += cf * mult
            if kind != "fusion":  # fusion internals: interface-only
                b += cb * mult
                bf += cbf * mult
            for k, v in cc.items():
                coll[k] = coll.get(k, 0.0) + v * mult
        memo[full] = (f, b, bf, coll)
        return memo[full]

    f, b, bf, coll = rec(entry)
    coll["total"] = sum(v for k, v in coll.items() if k != "total")
    return Totals(flops=f, bytes=b, coll=coll, bytes_floor=bf)
