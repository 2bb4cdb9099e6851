"""Every collective of a compiled HLO text, in program order: its kind,
result shape, replica groups (or source-target pairs) and the JAX op it
came from (``metadata op_name``), one line each; then the count and
result bytes by kind (no jax).

    python scripts/hlo_collectives.py FILE.hlo[.gz] [--grep PATTERN]

The reference's compiled steps are kept under ``$REPRO_HLO_DIR`` (e.g.
``REPRO_HLO_DIR=D python tests/_mesh_reference.py OUT families_tp``);
``--grep`` keeps the lines whose op name matches ``PATTERN``.
"""
import gzip
import re
import sys
from collections import defaultdict

KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
         "collective-permute")
_LINE = re.compile(r"^\s*(?:ROOT\s+)?%\S+\s*=\s*(\S+)\s+(" + "|".join(KINDS)
                   + r")(?:-start)?\(")
_BYTES = {"f32": 4, "bf16": 2, "s32": 4, "u32": 4, "f16": 2, "s8": 1,
          "u8": 1, "pred": 1, "s64": 8, "f64": 8}


def shape_bytes(shape: str) -> int:
    """Bytes of an HLO result shape (a tuple's elements summed)."""
    total = 0
    for dt, dims in re.findall(r"(\w+)\[([\d,]*)\]", shape):
        n = 1
        for d in filter(None, dims.split(",")):
            n *= int(d)
        total += n * _BYTES.get(dt, 4)
    return total


def collectives(text: str) -> list:
    """[(kind, result shape, groups, op_name)] in program order."""
    out = []
    for line in text.splitlines():
        m = _LINE.match(line)
        if not m:
            continue
        groups = re.search(r"(replica_groups=\S+|source_target_pairs=\S+)",
                           line)
        op = re.search(r'op_name="([^"]*)"', line)
        out.append((m.group(2), m.group(1), groups.group(1) if groups else "",
                    op.group(1) if op else ""))
    return out


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    path = argv[0]
    pat = argv[argv.index("--grep") + 1] if "--grep" in argv else None
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        ops = collectives(f.read())
    by_kind: dict = defaultdict(lambda: [0, 0])
    for kind, shape, groups, op in ops:
        if pat and not re.search(pat, op):
            continue
        print(f"{kind:20s} {shape:28s} {groups:40s} {op}")
        by_kind[kind][0] += 1
        by_kind[kind][1] += shape_bytes(shape)
    for kind, (n, b) in sorted(by_kind.items()):
        print(f"total {kind}: {n} ops, {b} result bytes")


if __name__ == "__main__":
    main()
