"""Every dot of a compiled HLO text, grouped by its JAX op name, output
shape and contracted size, with its FLOPs times the trip counts of the
loops around it (``repro_torch.core.hlo_counter``'s rules; no jax).

    python scripts/hlo_dots.py FILE.hlo[.gz]

The reference's dry run keeps a cell's HLO under ``$REPRO_HLO_DIR``
(e.g. ``REPRO_HLO_DIR=D python tests/_mesh_reference.py OUT
dryrun_smoke``).  Prints one line a group, largest first, then the total
(``hlo_counter.totals``' ``flops``).
"""
import gzip
import re
import sys
from collections import defaultdict

sys.path.insert(0, "src")
from repro_torch.core import hlo_counter as H  # noqa: E402


def multiplicities(comps) -> dict:
    """How many times each computation runs: the product of the trip
    counts of the loops on its path from the entry."""
    alias = {n.split("::")[-1]: n for n in comps}
    entry = next(n for n in comps if n.startswith("ENTRY::"))
    mult: dict = defaultdict(float)

    def walk(name, m):
        full = alias.get(name, name)
        if full not in comps:
            return
        mult[full] += m
        for child, kind, cond in comps[full].children:
            trip = 1
            if kind == "while":
                trip = cond if isinstance(cond, int) else max(
                    comps.get(alias.get(cond, cond), H.Comp()).max_const, 1)
            walk(child, m * trip)
    walk(entry, 1)
    return mult


def dots(text: str) -> dict:
    comps = H.parse(text)
    mult = multiplicities(comps)
    out: dict = defaultdict(float)
    for name, lines in H._split_computations(text).items():
        for ln in lines:
            if not re.search(r"\bdot\(", ln):
                continue
            shape = re.search(r"=\s*[a-z0-9]+\[([0-9,]*)\]", ln).group(1)
            dims = tuple(int(x) for x in shape.split(",") if x)
            lhs = re.findall(r"%([\w.\-]+)", ln.split("dot(", 1)[1])[0]
            ldims = H._dims_of(lines, lhs)
            cm = re.search(r"lhs_contracting_dims=\{([0-9,]*)\}", ln)
            csize = 1
            for c in cm.group(1).split(","):
                if c.strip():
                    csize *= ldims[int(c)]
            n = 1
            for d in dims:
                n *= d
            op = re.search(r'op_name="([^"]*)"', ln)
            key = "/".join(op.group(1).split("/")[-2:]) if op else "?"
            out[(key, dims, csize)] += 2.0 * n * csize * mult[name]
    return out


def main():
    path = sys.argv[1]
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        text = f.read()
    for (op, dims, csize), flops in sorted(dots(text).items(),
                                           key=lambda kv: -kv[1]):
        print(f"{flops:14.0f}  {op}  out {list(dims)}  contracted {csize}")
    print(f"{H.totals(text).flops:14.0f}  total")


if __name__ == "__main__":
    main()
