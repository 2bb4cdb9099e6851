#!/usr/bin/env python3
"""Times the fused engine-step kernel (``fused_signals_policy``) under DCQCN
and ``mlp`` at the simulator's shapes, for each given kernel source: the
repository's ``engine_step.cu`` by default, or others with the same C entry
point (an earlier commit's, from ``git archive``; a source whose library
has no ``fused_signals_policy_resident`` takes the earlier
one-thread-per-flow entry point, without the launch plan) to compare
versions in one run.

    python3 scripts/time_fused.py [--source FILE.cu ...] [--stage1-only]
        [--patch TILE=256,STAGES=3 ...] [--cp-async] [--sass DIR]
        [--shapes 1x131072,9x131072,9x65024] [--exhaustive]
        [--out time_fused.json]

Inputs are ``chip_smoke.fused_case``'s (``mlp`` with a live loss input),
made from a seed.  Per source, policy and shape (B lanes x F flows), cold
(each call on the next of enough input sets to exceed the 50 MB L2) and
hot (one set, L2-resident):

- ``event_us``: CUDA events around 20 back-to-back calls, per call
  (``chip_smoke.cuda_ms``); host-bound when the host's enqueue is slower;
- ``device_us``: the same calls enqueued behind a sleep kernel, so the
  events see device time only;
- ``profiler_us``: the device-busy µs per call of a ``torch.profiler``
  trace (``chip_smoke.device_us``), cold;
- ``host_us``: the host's µs per call, unsynchronised.

Each source's outputs are held against the plain version first
(``bit_equal``).  ``--stage1-only`` also times, per source, a variant whose policy
update is replaced by ``rate = rtt + util + line + loss``, ``win = ecn +
t + dt`` (every input still read, the state copied through): the loads
and stage 1 without the policy's arithmetic.  ``--patch`` also times each
source with some of its ``constexpr int`` launch constants changed (the
plan follows its ``TILE``); ``--cp-async`` times the planned sources once
more with the rows copied 4 bytes at a time in place of 16.  ``--exhaustive`` runs
``chip_smoke.scalar_exhaustive`` on each source's ``scalar_fn`` (the
indices ``ops.SCALAR_FNS`` names that the source's entry point takes).
Needs one CUDA card.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke as cs  # noqa: E402  (numpy only at import)
from time_flash_decode import device_ms  # noqa: E402

POLICIES = ("dcqcn", "mlp")
COLD_BYTES = 100e6
T, TBU = 3.3e-4, 1e-5


def variant(src: Path, out_dir: Path, name: str, subs) -> Path:
    """A copy of ``src`` (and the header it includes) under
    ``out_dir/name`` with each ``(pattern, replacement)`` of ``subs``
    applied once."""
    text = src.read_text()
    for pat, rep in subs:
        text, n = re.subn(pat, rep, text)
        if n != 1:
            raise ValueError(f"{src}: {pat!r} matched {n} times")
    dst = out_dir / name / src.relative_to(src.parents[3])
    dst.parent.mkdir(parents=True, exist_ok=True)
    dst.write_text(text)
    hdr = src.parents[2] / "csrc" / "cc_policy.cuh"
    (dst.parents[2] / "csrc").mkdir(parents=True, exist_ok=True)
    (dst.parents[2] / "csrc" / "cc_policy.cuh").write_text(hdr.read_text())
    return dst


# the stage-1-only variant: the policy update replaced by sums of the
# signals, so every input is still read
STAGE1 = [(r"policy_update<POL>\([^;]*\);",
           "rate = sig.rtt + sig.util + sig.line + sig.loss; "
           "win = sig.ecn + sig.t + sig.dt;")]


def constant_patch(spec: str):
    """``NAME=VALUE`` -> the substitution of ``constexpr int NAME = ...;``"""
    name, value = spec.split("=")
    return (rf"constexpr int {name} = \d+;", f"constexpr int {name} = {value};")


def time_source(path: Path, shapes, check: bool, gpu: str, dev,
                cp_async: bool = False, sass_dir=None) -> list:
    import torch
    from repro_torch.core import cc
    from repro_torch.kernels import build
    from repro_torch.kernels.engine_step import ops, ref
    build.BUILD_INFO.pop("engine_step", None)
    lib_path = build.build("engine_step", path)
    tile = re.search(r"constexpr int TILE = (\d+);", path.read_text())
    tile = int(tile.group(1)) if tile else None     # no plan: unused
    if sass_dir:
        import shutil
        import subprocess
        tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
        Path(sass_dir).mkdir(parents=True, exist_ok=True)
        out = Path(sass_dir) / (path.parents[3].name + ".sass")
        out.write_text(subprocess.run([tool, "-sass", str(lib_path)],
                                      capture_output=True, text=True).stdout)
    print(json.dumps({"source": str(path), "gpu": gpu, "ptxas": {
        k: v for k, v in cs.ptxas_summary(build.BUILD_INFO.get(
            "engine_step", {}).get("ptxas", "")).items() if "fused" in k},
        "sass": {k: v for k, v in cs.sass_counts(lib_path).items()
                 if "fused" in k}}), flush=True)
    lib = ctypes.CDLL(str(lib_path))
    fn = lib.fused_signals_policy
    planned = hasattr(lib, "fused_signals_policy_resident")
    if cp_async and not planned:
        return []
    sig = list(ops._SIGNATURES["fused_signals_policy"])
    fn.argtypes = sig if planned else sig[:24] + sig[-1:]
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream().cuda_stream
    lines = []
    for name in POLICIES:
        policy = cc.get_policy(name)
        for B, F in shapes:
            sets, n_sets = [], 2
            while len(sets) < n_sets:
                case, state, params = cs.fused_case(
                    policy, F, B, name == "mlp", 7 + len(sets), dev)
                K, P = state.shape[1], params.shape[1]
                n_sets = max(2, -(-int(COLD_BYTES)
                                  // (B * cs.fused_bytes(F, K, P))))
                outs = (torch.empty_like(state),
                        torch.empty_like(case["line"]),
                        torch.empty_like(case["line"]))
                ins = [*case.values(), state, params]
                args = [policy.kernel_id, *(x.data_ptr() for x in ins),
                        T, TBU, cs.DT, B, F, K, P,
                        *(o.data_ptr() for o in outs)]
                if planned:
                    n = ctypes.c_int()
                    if lib.fused_signals_policy_resident(
                            policy.kernel_id, K, ctypes.byref(n)) != 0:
                        raise RuntimeError("occupancy query failed")
                    args += [*ops.fused_plan(B, F, n.value, tile), int(
                        not cp_async and ops.vector_copies(
                            F, [x.data_ptr() for x in ins[:12]]))]
                sets.append((args, ins, outs))
            turn = [0]

            def cold(sets=sets, turn=turn):
                a = sets[turn[0] % len(sets)][0]
                turn[0] += 1
                if fn(*a, stream) != 0:
                    raise RuntimeError(f"{path}: launch failed")

            def hot(sets=sets):
                if fn(*sets[0][0], stream) != 0:
                    raise RuntimeError(f"{path}: launch failed")
            hot()
            torch.cuda.synchronize()
            equal = None
            if check:
                want = ref.fused_signals_policy_ref(policy, *sets[0][1], T,
                                                    TBU, cs.DT)
                equal = all(torch.equal(g, w.expand_as(g))
                            for g, w in zip(sets[0][2], want))
            line = {"source": str(path), "policy": name, "B": B, "F": F,
                    "route": "cp.async" if cp_async else "default",
                    "gpu": gpu, "bit_equal": equal, "cold_sets": len(sets),
                    "bytes": B * cs.fused_bytes(F, K, P),
                    "bound_us": B * cs.fused_bytes(F, K, P)
                    / cs.HBM_BYTES_PER_S * 1e6,
                    "event_us": cs.cuda_ms(cold) * 1e3,
                    "event_us_hot": cs.cuda_ms(hot) * 1e3,
                    "device_us": device_ms(cold) * 1e3,
                    "device_us_hot": device_ms(hot) * 1e3,
                    "profiler_us": cs.device_us(cold),
                    "host_us": cs.host_us(cold)}
            lines.append(line)
            print(json.dumps(line), flush=True)
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--source", action="append", default=[],
                    help="an engine_step.cu (default: the repository's)")
    ap.add_argument("--shapes", default="1x131072,9x131072,9x65024",
                    help="comma-separated BxF lane and flow counts")
    ap.add_argument("--stage1-only", action="store_true",
                    help="also time each source without the policy update")
    ap.add_argument("--patch", action="append", default=[],
                    help="NAME=V[,NAME=V]: also time each source with these "
                         "constexpr ints changed (repeatable)")
    ap.add_argument("--cp-async", action="store_true",
                    help="also time each planned source on the 4-byte "
                         "cp.async route")
    ap.add_argument("--sass", help="write each library's SASS here")
    ap.add_argument("--exhaustive", action="store_true",
                    help="run every float32 input through scalar_fn")
    ap.add_argument("--out", help="also write the lines to this JSON file")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("time_fused: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build
    shapes = [tuple(int(v) for v in s.split("x"))
              for s in args.shapes.split(",")]
    sources = [Path(s) for s in args.source] or [build.SOURCES["engine_step"]]
    gpu = cs.gpu_line()
    dev = torch.device("cuda")
    scratch = ROOT / "build" / "time_fused"
    lines = []
    for si, src in enumerate(sources):
        lines += time_source(src, shapes, True, gpu, dev,
                             sass_dir=args.sass)
        if args.cp_async:
            lines += time_source(src, shapes, True, gpu, dev, cp_async=True)
        if args.stage1_only:
            lines += time_source(variant(src.resolve(), scratch,
                                         f"stage1_{si}", STAGE1),
                                 shapes, False, gpu, dev)
        # launch constants exist in the planned sources only
        patches = args.patch if "constexpr int TILE" in src.read_text() \
            else []
        for pi, spec in enumerate(patches):
            lines += time_source(variant(
                src.resolve(), scratch, f"patch{pi}_{si}",
                [constant_patch(p) for p in spec.split(",")]), shapes, True,
                gpu, dev, sass_dir=args.sass)
        if args.exhaustive:
            # the indices this source's scalar_fn takes ("which > N")
            n_fns = int(re.search(r"which > (\d+)", src.read_text()
                                  ).group(1)) + 1
            from repro_torch.kernels.engine_step import ops
            lib = ctypes.CDLL(str(build.build("engine_step", src)))
            fn = lib.scalar_fn
            fn.argtypes = ops._SIGNATURES["scalar_fn"]
            fn.restype = ctypes.c_int
            which = [(n, i) for n, i in ops.SCALAR_FNS.items() if i < n_fns]
            line = {"source": str(src), "gpu": gpu,
                    "scalar_fn": [i for _, i in which],
                    **cs.scalar_exhaustive(fn, which)}
            lines.append(line)
            print(json.dumps(line), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(lines, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
