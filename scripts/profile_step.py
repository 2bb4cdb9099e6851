#!/usr/bin/env python3
"""Where one engine step's time goes on the card, for the scenarios that
``chip_smoke.py`` drives (128-GPU 1D all-reduce and 32-GPU 2D all-reduce,
DCQCN), on both step paths.

    python3 scripts/profile_step.py [--out profile.json]

Each (scenario, step_impl) starts a fresh run and steps it ``--warm``
steps.  Then every run is timed for ``--steps`` steps on the host clock,
driven as ``engine._run_loop`` drives them (one host read of the halt
flag per step), and only after all of them is each traced for
``--trace-steps`` more under ``torch.profiler``: once the profiler has
traced, later launches in the process are slower, so no untraced time is
taken after a trace.  One JSON line per run: host ms per step, device
kernels launched per step, device-busy µs per step (union of kernel and
copy intervals), the device's idle share (1 - busy / untraced host time
per step), and the kernels that take most device time.  Needs one CUDA
card.
"""
from __future__ import annotations

import argparse
import collections
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

SRC = Path(__file__).resolve().parents[1] / "src"


def busy_us(intervals) -> float:
    """Length of the union of ``(start, end)`` intervals."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if a >= end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


class Run:
    """One fresh run of a scenario on one step path, stepped on demand."""

    def __init__(self, runner, spec, impl: str):
        from repro_torch.core import engine
        cfg = dataclasses.replace(runner.cfg, step_impl=impl)
        topo, sched, self.policy = spec.build()
        self.sim = runner.simulator(topo, sched, self.policy, cfg)
        self.step = engine._make_step(self.policy, cfg, self.sim.plan,
                                      self.sim.pp, None, self.sim.fabric,
                                      self.sim.step_impl == "cuda")
        self.carry = engine._init_carry(self.sim.pp, self.sim.plan,
                                        self.policy, cfg)
        self.it = 0

    def advance(self, n: int) -> None:
        import torch
        from repro_torch.core import engine
        for _ in range(n):
            if engine._halted(self.carry):
                raise RuntimeError(f"run halted at step {self.it}: lower "
                                   "--warm or --steps")
            self.carry = self.step(self.carry, self.it)
            self.it += 1
        torch.cuda.synchronize()

    def host_ms(self, n: int) -> float:
        t0 = time.perf_counter()
        self.advance(n)
        return (time.perf_counter() - t0) / n * 1e3

    def trace(self, n: int, top: int) -> dict:
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            self.advance(n)
        dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        if not dev:
            raise RuntimeError("the profiler recorded no device activity")
        by_name = collections.defaultdict(lambda: [0, 0.0])
        for e in dev:
            rec = by_name[e.name[:90]]
            rec[0] += 1
            rec[1] += e.time_range.end - e.time_range.start
        copies = sum(k for name, (k, _) in by_name.items()
                     if name.startswith(("Memcpy", "Memset")))
        busy = busy_us((e.time_range.start, e.time_range.end) for e in dev)
        ranked = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:top]
        return {"kernels_per_step": (len(dev) - copies) / n,
                "copies_per_step": copies / n,
                "device_busy_us_per_step": busy / n,
                "top_kernels": [{"name": name, "per_step": k / n,
                                 "us_per_step": us / n}
                                for name, (k, us) in ranked]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--warm", type=int, default=400)
    ap.add_argument("--steps", type=int, default=256)
    ap.add_argument("--trace-steps", type=int, default=64)
    ap.add_argument("--top", type=int, default=12)
    ap.add_argument("--out", help="also write all lines to this JSON file")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("profile_step: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.core import (CollectiveSpec, EngineConfig, FabricSpec,
                                  ScenarioSpec, SweepRunner)

    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    cfg = EngineConfig(dt=4e-6, max_steps=6000, max_extends=6, queue_stride=0)
    runner = SweepRunner(cfg, device="cuda")
    scen = {
        "clos128_1d": ScenarioSpec(
            FabricSpec("clos", n_racks=8, nodes_per_rack=2, gpus_per_node=8,
                       oversubscription=2.0), CollectiveSpec("1d", 128e6),
            "dcqcn"),
        "clos32_2d": ScenarioSpec(
            FabricSpec("clos", n_racks=2, nodes_per_rack=2, gpus_per_node=8,
                       oversubscription=2.0), CollectiveSpec("2d", 128e6),
            "dcqcn"),
    }
    runs, lines = {}, {}
    for label, spec in scen.items():
        # the 32-GPU run finishes in ~740 steps: keep its windows inside it
        warm = min(args.warm, 300) if label == "clos32_2d" else args.warm
        for impl in ("cuda", "torch"):
            run = runs[label, impl] = Run(runner, spec, impl)
            run.advance(warm)
            ms = run.host_ms(args.steps)
            lines[label, impl] = {
                "scenario": label, "gpu": gpu,
                "n_flows": run.sim.plan.n_flows, "policy": run.policy.name,
                "step_impl": run.sim.step_impl,
                "first_timed_step": run.it - args.steps,
                "host_ms_per_step": ms, "steps_per_s": 1e3 / ms}
    for key, run in runs.items():
        line = lines[key]
        line["first_traced_step"] = run.it
        line.update(run.trace(args.trace_steps, args.top))
        line["device_idle_share"] = 1.0 - (line["device_busy_us_per_step"]
                                           / (line["host_ms_per_step"] * 1e3))
        print(json.dumps(line), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(list(lines.values()), indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
