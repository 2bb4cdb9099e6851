#!/usr/bin/env python3
"""Time the segment kernels (``segment_reduce``, ``segment_reduce_pfc``)
of one or more versions of ``engine_step.cu`` on the reduction plans of
``chip_smoke.py``'s scenarios, in one process on one card.

    python3 scripts/time_segment.py [--source FILE.cu[:gather] ...]
                                    [--only clos128_1d ...] [--reps N]

Each ``--source`` is built as its own library (default: the repository's
source).  ``:gather`` marks a source whose entry points take only
"gather" plans, without strides or split rows (an engine_step.cu from
before the split-row kernels): it skips the split-row plans.  For every
plan of the 128-GPU step (the 1D all-reduce, one lane), of the 32-GPU step and
of Fig 12's nine lanes (``fig12``, B=9), each version is first held bit
for bit against the plain version, then timed in turns (the versions in
order, then in reverse): CUDA events around 20 back-to-back launches per
launch (``event_us``; the host's enqueue where it is slower), the same
launches queued behind a sleep kernel so that the events see the device
alone (``device_us``), and in the first turn the union of the device
intervals of 50 launches in a ``torch.profiler`` trace (``profiler_us``,
None where the profiler drops events), beside ``index_add_`` of the same
values into their segments (one call for all lanes) and the plan's byte
bound (member indices, block offsets, each member's value read once, the
sums written once, at 3.35 TB/s).  One JSON line per plan, then a table.
``--patch NAME=VALUE`` rewrites ``constexpr int NAME = ...;`` in a copy of
the first source (e.g. ``SEG_BATCH=16``) and times that copy as one more
version, with split-row CTA tables packed by its own chunk.
Needs one CUDA card and ``nvcc``.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "src"))
sys.path.insert(0, str(REPO))
import chip_smoke  # noqa: E402  (numpy only at import)
from time_flash_decode import device_ms  # noqa: E402

SCENARIOS = ("clos128_1d", "clos32_2d", "fig12")
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
# the gather-only entry points: (vals, idx, B, n_in, n_out, C, out[, xoff,
# xon, can, prev, q, paused], stream)
GATHER_ONLY_SIGNATURES = {"segment_reduce": [_P, _P, _I, _I, _I, _I, _P, _P],
                   "segment_reduce_pfc": [_P, _P, _I, _I, _I, _I]
                   + [_P] * 7}


class Version:
    """One built ``engine_step.cu``: its segment entry points."""

    def __init__(self, spec: str):
        from repro_torch.kernels import build
        from repro_torch.kernels.engine_step import ops
        path, _, abi = spec.partition(":")
        self.label, self.gather_only = spec, abi == "gather"
        lib = ctypes.CDLL(str(build.build("engine_step", Path(path))))
        self.fns = {}
        for name in ("segment_reduce", "segment_reduce_pfc"):
            fn = getattr(lib, name)
            fn.argtypes = (GATHER_ONLY_SIGNATURES if self.gather_only
                           else ops._SIGNATURES)[name]
            fn.restype = ctypes.c_int
            self.fns[name] = fn

        # a version's split-row CTA table packs by its own chunk
        self.chunk = None
        if not self.gather_only:
            self.chunk = lib.segment_split_chunk
            self.chunk.argtypes, self.chunk.restype = [_I], ctypes.c_int

    def takes(self, boff) -> bool:
        return boff is None or not self.gather_only

    def args(self, name, vals, kplan, outs, per_seg) -> list:
        import torch
        from repro_torch.kernels.engine_step import ops
        idx, n_out, C, boff, C2, ctas = kplan
        if boff is not None:
            ctas = torch.as_tensor(ops.split_ctas(
                boff.cpu().numpy(), C2, self.chunk(C2)), device=boff.device)
        self.held = ctas          # the launch passes its pointer
        B, n_in = vals.shape
        head = ([vals.data_ptr(), idx.data_ptr(), B, n_in, n_out, C]
                if self.gather_only
                else ops.segment_args(vals, idx, boff, n_out, C, C2, ctas))
        if name == "segment_reduce":
            return head + [outs[0].data_ptr()]
        return head + [x.data_ptr() for x in per_seg + outs]


def profiler_us(fn):
    """``chip_smoke.device_us``, or None where the profiler drops the
    device events (it does after many traces in one process)."""
    try:
        return chip_smoke.device_us(fn)
    except RuntimeError:
        return None


def patched(src: str, patch: str) -> str:
    """A copy of ``src`` (with the shared headers beside it, as the build
    expects) whose ``constexpr int NAME = ...;`` lines take the values of
    ``patch`` (``NAME=VALUE,...``), under ``build/time_segment/``."""
    import re
    import shutil
    from repro_torch.kernels import build
    text = Path(src).read_text()
    for item in patch.split(","):
        name, value = item.split("=")
        text, n = re.subn(rf"constexpr int {name} = [^;]+;",
                          f"constexpr int {name} = {value};", text)
        if n != 1:
            raise ValueError(f"--patch {item}: {n} definitions of {name}")
    root = REPO / "build" / "time_segment" / re.sub(r"\W", "_", patch)
    (root / "engine_step" / "csrc").mkdir(parents=True, exist_ok=True)
    (root / "csrc").mkdir(exist_ok=True)
    for hdr in build.headers(Path(src)):
        shutil.copy(hdr, root / "csrc" / hdr.name)
    out = root / "engine_step" / "csrc" / "engine_step.cu"
    out.write_text(text)
    return str(out)


def plans(only) -> list:
    """``(scenario, what, strategy, kernel plan, n_in, lanes)`` of every
    non-empty reduction plan of the chosen scenarios."""
    from repro_torch.core import (CollectiveSpec, EngineConfig, FabricSpec,
                                  ScenarioSpec, SweepRunner, engine)
    runner = SweepRunner(EngineConfig(dt=chip_smoke.DT), device="cuda")
    clos = dict(nodes_per_rack=2, gpus_per_node=8, oversubscription=2.0)
    built = {
        "clos128_1d": lambda: ScenarioSpec(
            FabricSpec("clos", n_racks=8, **clos),
            CollectiveSpec("1d", 128e6), "dcqcn").build(),
        "clos32_2d": lambda: ScenarioSpec(
            FabricSpec("clos", n_racks=2, **clos),
            CollectiveSpec("2d", 128e6), "dcqcn").build(),
        "fig12": chip_smoke.fig12_scenario,
    }
    out = []
    for label in only:
        sim = runner.simulator(*built[label]())
        for what, strat, arrs, n_in in chip_smoke.plan_inputs(sim):
            if strat[0] != "empty":
                out.append((label, what, strat,
                            engine._kernel_plan(strat, arrs), n_in,
                            9 if label == "fig12" else 1))
    return out


def plan_bytes(kplan, n_in: int, B: int) -> tuple:
    """Bytes one launch must move, the bytes of the 32-byte sectors its
    value loads touch (each 32 consecutive members of the plan are one
    warp's load, as the kernels issue them; per lane), and each input's
    segment (``n_out`` for an input in none) for ``index_add_``."""
    import numpy as np
    idx, n_out, C, boff, _, ctas = kplan
    members = idx.cpu().numpy().astype(np.int64)
    blk_seg = (np.arange(n_out) if boff is None else np.repeat(
        np.arange(n_out), np.diff(boff.cpu().numpy())))
    live = members < n_in
    seg_of = np.full(n_in, n_out, np.int64)
    seg_of[members[live]] = np.repeat(blk_seg, C)[live]
    n_bytes = (4 * idx.numel() + B * 4 * (int(live.sum()) + n_out)
               + sum(4 * x.numel() for x in (boff, ctas) if x is not None))
    warps = np.where(live, members // 8, -1)
    warps = np.pad(warps, (0, -len(warps) % 32), constant_values=-1)
    warps = np.sort(warps.reshape(-1, 32), axis=1)
    fresh = (warps[:, 1:] != warps[:, :-1]) & (warps[:, 1:] >= 0)
    sectors = int(fresh.sum() + (warps[:, 0] >= 0).sum())
    return n_bytes, 32 * B * sectors, seg_of


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--source", action="append",
                    help="an engine_step.cu to time, FILE or FILE:gather "
                         "(repeatable; default: the repository's)")
    ap.add_argument("--only", nargs="+", choices=SCENARIOS,
                    default=list(SCENARIOS))
    ap.add_argument("--patch", action="append", default=[],
                    help="NAME=VALUE[,NAME=VALUE]: a copy of the first "
                         "source with these constants (repeatable)")
    ap.add_argument("--reps", type=int, default=25)
    args = ap.parse_args(argv)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("time_segment: CUDA is not available", file=sys.stderr)
        return 2
    from repro_torch.kernels import build
    from repro_torch.kernels.engine_step import ref
    dev = torch.device("cuda")
    gpu = chip_smoke.gpu_line()
    sources = args.source or [str(build.SOURCES["engine_step"])]
    versions = [Version(s) for s in sources]
    versions += [Version(patched(sources[0].partition(":")[0], p))
                 for p in args.patch]
    stream = torch.cuda.current_stream().cuda_stream
    rows = []
    for label, what, strat, kplan, n_in, B in plans(args.only):
        idx, n_out, C, boff, C2, ctas = kplan
        rng = np.random.default_rng(3)
        vals = torch.as_tensor(rng.uniform(0, 2e6, (B, n_in))
                               * (rng.random((B, n_in)) < 0.7),
                               dtype=torch.float32, device=dev)
        per_seg = [torch.full((B, n_out), 1e6, device=dev),
                   torch.full((B, n_out), 0.8e6, device=dev),
                   torch.ones((B, n_out), dtype=torch.bool, device=dev),
                   torch.zeros((B, n_out), dtype=torch.bool, device=dev)]
        n_bytes, sector_bytes, seg_of = plan_bytes(kplan, n_in, B)
        names = ["segment_reduce"] + (["segment_reduce_pfc"]
                                      if what == "qport" else [])
        for name in names:
            pfc = name == "segment_reduce_pfc"
            want = (ref.segment_reduce_pfc_ref(vals, idx, n_out, C,
                                               *per_seg, boff, C2)
                    if pfc else (ref.segment_reduce_ref(vals, *kplan),))
            row = {"scenario": label, "plan": what, "kernel": name,
                   "strategy": list(strat), "lanes": B, "gpu": gpu,
                   "bytes": n_bytes + (11 * B * n_out if pfc else 0),
                   "value_sector_bytes": sector_bytes}
            row["bound_us"] = row["bytes"] / chip_smoke.HBM_BYTES_PER_S * 1e6
            launches = {}
            for ver in versions:
                if not ver.takes(boff):
                    continue
                outs = [torch.empty((B, n_out), device=dev)] + (
                    [torch.empty((B, n_out), dtype=torch.bool, device=dev)]
                    if pfc else [])
                a = ver.args(name, vals, kplan, outs, per_seg)
                fn = ver.fns[name]

                def launch(fn=fn, a=a):
                    if fn(*a, stream) != 0:
                        raise RuntimeError(f"{name} launch failed")
                launch()
                torch.cuda.synchronize()
                if not all(torch.equal(o, w) for o, w in zip(outs, want)):
                    raise AssertionError(f"{ver.label} {label}/{what} "
                                         f"{name}: differs from the plain "
                                         "version")
                launches[ver.label] = (launch, outs, ver.held)
            order = list(launches) + list(reversed(launches))
            times = {v: {"event_us": [], "device_us": [], "profiler_us": []}
                     for v in launches}
            for turn, v in enumerate(order):
                fn = launches[v][0]
                times[v]["event_us"].append(
                    chip_smoke.cuda_ms(fn, reps=args.reps) * 1e3)
                times[v]["device_us"].append(device_ms(fn) * 1e3)
                if turn < len(launches):
                    times[v]["profiler_us"].append(profiler_us(fn))
            row["versions"] = times
            # every lane's inputs into its own n_out + 1 rows, one call
            seg_t = torch.as_tensor(
                (seg_of[None] + (n_out + 1) * np.arange(B)[:, None])
                .reshape(-1), device=dev)
            acc = torch.zeros(B * (n_out + 1), device=dev)
            flat = vals.reshape(-1)

            def index_add():
                acc.index_add_(0, seg_t, flat)
            row["index_add_event_us"] = chip_smoke.cuda_ms(index_add) * 1e3
            row["index_add_device_us"] = device_ms(index_add) * 1e3
            row["index_add_profiler_us"] = profiler_us(index_add)
            print(json.dumps(row), flush=True)
            rows.append(row)
    print(gpu)
    tags = {v.label: f"v{i}" for i, v in enumerate(versions)}
    print("  ".join(f"{t} = {v}" for v, t in tags.items()))
    for row in rows:
        cells = "  ".join(
            f"{tags[v]} " + "/".join(f"{x:.2f}" for x in t["device_us"])
            for v, t in row["versions"].items())
        print(f"{row['scenario']:10s} {row['plan']:6s} {row['kernel']:18s} "
              f"{str(tuple(row['strategy'])):28s} B={row['lanes']} "
              f"bound {row['bound_us']:.2f}  index_add "
              f"{row['index_add_device_us']:.2f}  device us {cells}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
