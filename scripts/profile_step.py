#!/usr/bin/env python3
"""Where one engine step's time goes on the card, for the scenarios that
``chip_smoke.py`` drives (128-GPU 1D all-reduce, lossless and lossy,
32-GPU 2D all-reduce and the 128-GPU DLRM training iteration with the 2D
all-reduce, DCQCN), on both step paths; for Fig 12's fabric sweep (``batch_fig12``) on the
kernel path at B=9 lanes, at B=1 (lane 0 alone) and at B=256 (a full
chunk, the 9 points repeated); where one forward of the Table II DLRM (batch 256)
goes; and where one decode step of TinyLlama-1.1B goes on
``chip_smoke.py``'s long serving run (8 slots, 2,048-token prompts, a
32,768-token cache), on both decode paths (``decode_impl`` cuda and
torch); and where one step of the differentiable simulator goes, its
forward under autograd and its backward, at 128 GPUs (DCQCN, w.r.t.
``rai_frac`` and ``g``) and on the ``mlp`` trainer's ring all-reduce
task (its three fabric corners as lanes, w.r.t. the 40 weights):
``clos128_grad``, ``ring16_grad``.

    python3 scripts/profile_step.py [--out profile.json] [--only name ...]

Each (scenario, step_impl) starts a fresh run and steps it ``--warm``
steps.  Then every run is timed for ``--steps`` steps on the host clock,
driven as ``engine._run_loop`` drives them (one host read of the halt
flag per step), and only after all of them is each traced for
``--trace-steps`` more under ``torch.profiler``: once the profiler has
traced, later launches in the process are slower, so no untraced time is
taken after a trace.  One JSON line per run: host ms per step, device
kernels launched per step, device-busy µs per step (union of kernel and
copy intervals), the device's idle share (1 - busy / untraced host time
per step), and the kernels that take most device time.  The DLRM forward
gets the same line per forward (``FORWARDS`` timed, then
``TRACE_FORWARDS`` traced), a decode step the same line per step
(``DECODE_STEPS`` timed, then ``TRACE_DECODE`` traced, after
``WARM_DECODE``).  Needs one CUDA card.
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
sys.path.insert(0, str(SRC.parent))
from chip_smoke import busy_us  # noqa: E402  (numpy only at import)
# DLRM forwards timed, then traced, after five warm-up forwards
FORWARDS, TRACE_FORWARDS = 100, 20
# TinyLlama decode steps: warm-up, timed, traced (each path has its cache)
WARM_DECODE, DECODE_STEPS, TRACE_DECODE = 4, 24, 8
SCENARIOS = ("clos128_1d", "clos128_1d_lossy", "dlrm128_2d", "clos32_2d",
             "batch_fig12", "dlrm_forward", "serve_decode", "clos128_grad",
             "ring16_grad")
# the differentiable step: steps recorded under autograd per window (its
# activations stay on the card until the backward)
GRAD_STEPS, GRAD_TRACE_STEPS = 64, 16


class Run:
    """One fresh run of a scenario on one step path, stepped on demand;
    ``stacked_fabric`` (FabricParams field -> length-B array) makes it a
    batch of B lanes, as ``SweepRunner.run_batch`` steps them; the spec's
    ``fault_spec`` runs the faulty step."""

    def __init__(self, runner, spec, impl: str, stacked_fabric=None):
        from repro_torch.core import engine, faults, sweep
        cfg = dataclasses.replace(runner.cfg, step_impl=impl)
        topo, sched, self.policy = spec.build()
        self.sim = runner.simulator(topo, sched, self.policy, cfg)
        lanes, fab = 1, self.sim.fabric
        if stacked_fabric is not None:
            lanes = len(next(iter(stacked_fabric.values())))
            fab = sweep._stack_fabric(fab, stacked_fabric, lanes)
        self.lanes = lanes
        fault = faults._as_fault(spec.fault_spec)
        self.step = engine._make_step(self.policy, cfg, self.sim.plan,
                                      self.sim.pp, None, fab,
                                      self.sim.step_impl == "cuda", lanes,
                                      fault)
        self.carry = engine._init_carry(self.sim.pp, self.sim.plan,
                                        self.policy, cfg, None, lanes,
                                        faults.is_faulty(fault))
        self.it = 0

    def advance(self, n: int) -> None:
        import torch
        from repro_torch.core import engine
        for _ in range(n):
            stop, live, _ = engine._gate(self.carry)
            if stop:
                raise RuntimeError(f"run halted at step {self.it}: lower "
                                   "--warm or --steps")
            self.carry = self.step(self.carry, self.it, live)
            self.it += 1
        torch.cuda.synchronize()

    def host_ms(self, n: int) -> float:
        t0 = time.perf_counter()
        self.advance(n)
        return (time.perf_counter() - t0) / n * 1e3

    def trace(self, n: int, top: int) -> dict:
        return trace(lambda: self.advance(n), n, top)


def trace(work, n: int, top: int) -> dict:
    """Device kernels, copies and busy time per step of ``work()``, which
    runs ``n`` steps and synchronises, under ``torch.profiler``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        work()
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


class GradRun:
    """The differentiable step of a scenario (``Simulator.soft_cost_fn``'s
    step: the op path under autograd) w.r.t. the CC params ``keys``, as
    ``lanes`` lanes (fabric leaves stacked by ``stacked_fabric``).  It is
    warmed without autograd; a window of steps is then recorded under
    autograd from the current carry and differentiated (the soft cost's
    sum w.r.t. the keys): the forward and the backward of that window."""

    def __init__(self, runner, spec, keys, stacked_fabric=None):
        import numpy as np
        import torch
        from repro_torch.core import engine, faults, sweep
        cfg = dataclasses.replace(runner.cfg, step_impl="torch")
        topo, sched, self.policy = spec.build()
        self.sim = runner.simulator(topo, sched, self.policy, cfg)
        lanes, fab = 1, self.sim.fabric
        if stacked_fabric is not None:
            lanes = len(next(iter(stacked_fabric.values())))
            fab = sweep._stack_fabric(fab, stacked_fabric, lanes)
        self.lanes, self.select = lanes, stacked_fabric is not None
        self.leaves = {k: torch.tensor(np.float32(self.policy.params[k]),
                                       device="cuda", requires_grad=True)
                       for k in keys}
        fault = faults._as_fault(spec.fault_spec)
        self.step = engine._make_step(self.policy, cfg, self.sim.plan,
                                      self.sim.pp, self.leaves, fab, False,
                                      lanes, fault, grad=True)
        self.carry = engine._init_carry(self.sim.pp, self.sim.plan,
                                        self.policy, cfg, self.leaves, lanes,
                                        faults.is_faulty(fault))
        self.it = 0

    def advance(self, n: int) -> None:
        import torch
        from repro_torch.core import engine
        for _ in range(n):
            stop, live, _ = engine._gate(self.carry, self.select)
            if stop:
                raise RuntimeError(
                    f"run halted at step {self.it} (diverged "
                    f"{self.carry['diverged'].tolist()}, flows done "
                    f"{self.carry['done'].sum(-1).tolist()}): lower --warm "
                    "or --steps")
            self.carry = self.step(self.carry, self.it, live)
            self.it += 1
        torch.cuda.synchronize()

    def warm(self, n: int) -> None:
        import torch
        with torch.no_grad():
            self.advance(n)

    def window(self, n: int, trace_top: int | None = None) -> dict:
        """Forward and backward host ms per step over ``n`` steps (the
        peak bytes their activations hold, per step), or with
        ``trace_top`` their device kernels and busy time per step."""
        import torch
        from repro_torch.core import engine
        self.carry = engine._tree_map(lambda t: t.detach(), self.carry)
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = {}
        if trace_top is None:
            t0 = time.perf_counter()
            self.advance(n)
            t1 = time.perf_counter()
            torch.autograd.grad(self.carry["soft"].sum(),
                                list(self.leaves.values()),
                                allow_unused=True)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            return {"fwd_host_ms_per_step": (t1 - t0) / n * 1e3,
                    "bwd_host_ms_per_step": (t2 - t1) / n * 1e3,
                    "activation_bytes_per_step":
                        (torch.cuda.max_memory_allocated() - base) / n}
        out["fwd"] = trace(lambda: self.advance(n), n, trace_top)

        def backward():
            torch.autograd.grad(self.carry["soft"].sum(),
                                list(self.leaves.values()),
                                allow_unused=True)
            torch.cuda.synchronize()
        out["bwd"] = trace(backward, n, trace_top)
        return out


class Forwards:
    """The Table II DLRM (1,000,000 rows a table, seed 0) scoring one
    batch of 256 from ``dlrm_batch``, already on the card; one "step" is
    one forward."""

    def __init__(self):
        import torch
        from repro_torch.configs import get_model
        from repro_torch.data import dlrm_batch
        self.model = get_model("dlrm", device="cuda", seed=0)
        self.batch = {k: torch.as_tensor(v, device="cuda") for k, v in
                      dlrm_batch(0, 0, 256, self.model.cfg).items()}

    def advance(self, n: int) -> None:
        import torch
        for _ in range(n):
            self.model(self.batch)
        torch.cuda.synchronize()

    def host_ms(self, n: int) -> float:
        t0 = time.perf_counter()
        self.advance(n)
        return (time.perf_counter() - t0) / n * 1e3


class Decoding:
    """TinyLlama-1.1B (seed-0 weights) after the prefill of 8 prompts of
    2,048 tokens into a 32,768-token cache; one "step" is one greedy
    decode step on ``impl``'s decode attention."""

    def __init__(self, model, params, impl: str):
        import numpy as np
        import torch
        self.model, self.params, self.impl = model, params, impl
        prompts = np.random.default_rng(0).integers(
            0, model.cfg.vocab, (8, 2048), dtype=np.int32)
        logits, self.cache = model.prefill(params, {"tokens": prompts},
                                           max_len=32768)
        self.cur = torch.argmax(logits, -1)[:, None]

    def advance(self, n: int) -> None:
        import torch
        for _ in range(n):
            logits, self.cache = self.model.decode_step(
                self.params, self.cache, self.cur, self.impl)
            self.cur = torch.argmax(logits, -1)[:, None]
        torch.cuda.synchronize()

    def host_ms(self, n: int) -> float:
        t0 = time.perf_counter()
        self.advance(n)
        return (time.perf_counter() - t0) / n * 1e3


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--warm", type=int, default=400)
    ap.add_argument("--steps", type=int, default=256)
    ap.add_argument("--trace-steps", type=int, default=64)
    ap.add_argument("--top", type=int, default=12)
    ap.add_argument("--out", help="also write all lines to this JSON file")
    ap.add_argument("--only", nargs="+", choices=SCENARIOS,
                    help="profile only these scenarios (default: all)")
    args = ap.parse_args(argv)
    only = set(args.only or SCENARIOS)

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("profile_step: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.core import (CollectiveSpec, DLRMCommSpec,
                                  DLRMIterationSpec, EngineConfig,
                                  FabricSpec, FaultSpec, ScenarioSpec,
                                  SweepRunner)
    import chip_smoke

    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    cfg = EngineConfig(dt=4e-6, max_steps=6000, max_extends=6, queue_stride=0)
    runner = SweepRunner(cfg, device="cuda")
    fab128 = FabricSpec("clos", n_racks=8, nodes_per_rack=2, gpus_per_node=8,
                        oversubscription=2.0)
    scen = {
        "clos128_1d": ScenarioSpec(fab128, CollectiveSpec("1d", 128e6),
                                   "dcqcn"),
        # the same run on the lossy-RoCE operating point: the fault
        # branches of the step (loss, IRN recovery, the loss signal)
        "clos128_1d_lossy": ScenarioSpec(
            fab128, CollectiveSpec("1d", 128e6), "dcqcn",
            fault_spec=FaultSpec.lossy_roce(1e-5, "irn")),
        # the iteration's all-reduce runs from about step 625 (2.5 ms)
        "dlrm128_2d": ScenarioSpec(
            fab128, DLRMIterationSpec(comm=DLRMCommSpec(allreduce_algo="2d")),
            "dcqcn"),
        "clos32_2d": ScenarioSpec(
            FabricSpec("clos", n_racks=2, nodes_per_rack=2, gpus_per_node=8,
                       oversubscription=2.0), CollectiveSpec("2d", 128e6),
            "dcqcn"),
        # Fig 12's fabric sweep (chip_smoke.batch_fig12), kernel path
        "batch_fig12": ScenarioSpec(
            FabricSpec("clos", n_racks=chip_smoke.FIG12_RACKS,
                       nodes_per_rack=2, gpus_per_node=8,
                       oversubscription=chip_smoke.FIG12_OVERSUB),
            CollectiveSpec("a2a", chip_smoke.FIG12_BYTES),
            chip_smoke.FIG12_POLICY),
    }
    pts = chip_smoke.fig12_points()
    # batch_fig12: the 9-lane batch, lane 0 alone (B=1), and a full chunk
    # of AUTO_CHUNK_PER_DEVICE = 256 lanes (the 9 points repeated), all on
    # the kernel path
    variants = {"batch_fig12": [("cuda", 9), ("cuda", 1), ("cuda", 256)]}
    runs, lines = {}, {}
    for label, spec in scen.items():
        if label not in only:
            continue
        # the 32-GPU run finishes in ~740 steps: keep its windows inside
        # it; start the DLRM iteration's inside its all-reduce
        warm = {"clos32_2d": min(args.warm, 300),
                "dlrm128_2d": max(args.warm, 700)}.get(label, args.warm)
        for impl, B in variants.get(label, [("cuda", None), ("torch", None)]):
            stacked = (None if B is None else {
                f: np.resize(pts[:, j], B)
                for j, f in enumerate(("kmin", "kmax", "xoff"))})
            run = runs[label, impl, B] = Run(runner, spec, impl, stacked)
            run.advance(warm)
            ms = run.host_ms(args.steps)
            lines[label, impl, B] = {
                "scenario": label, "gpu": gpu,
                "n_flows": run.sim.plan.n_flows, "policy": run.policy.name,
                "step_impl": run.sim.step_impl, "lanes": run.lanes,
                "first_timed_step": run.it - args.steps,
                "host_ms_per_step": ms, "steps_per_s": 1e3 / ms,
                "lane_steps_per_s": run.lanes * 1e3 / ms}
    if "dlrm_forward" in only:
        fwd = Forwards()
        fwd.advance(5)
        ms = fwd.host_ms(FORWARDS)
        lines["dlrm_forward"] = {
            "scenario": "dlrm_forward", "gpu": gpu, "batch": 256,
            "rows_per_table": fwd.model.cfg.rows_per_table,
            "embedding_impl": fwd.model.embedding_impl,
            "host_ms_per_step": ms, "forwards_per_s": 1e3 / ms}
    decoding = {}
    if "serve_decode" in only:
        from repro_torch.configs import get_model
        model = get_model("tinyllama-1.1b", device="cuda")
        params = model.init(torch.Generator(device="cuda").manual_seed(0))
        for impl in ("cuda", "torch"):
            dec = decoding[impl] = Decoding(model, params, impl)
            dec.advance(WARM_DECODE)
            ms = dec.host_ms(DECODE_STEPS)
            lines["serve_decode", impl] = {
                "scenario": "serve_decode", "gpu": gpu, "slots": 8,
                "prompt": 2048, "max_len": 32768, "decode_impl": impl,
                "first_timed_position": dec.cache["pos"] - DECODE_STEPS,
                "host_ms_per_step": ms, "tokens_per_s": 8e3 / ms}
    grads = {}
    if "clos128_grad" in only:
        grads["clos128_grad"] = GradRun(runner, scen["clos128_1d"],
                                        ("rai_frac", "g"))
    if "ring16_grad" in only:
        # the mlp trainer's costliest curriculum task, its 3 fabric corners
        # as lanes (repro_torch.learn.train)
        import repro_torch.learn.train  # noqa: F401
        from repro_torch.learn.net import WEIGHT_KEYS, init_weights, make_mlp
        tr = sys.modules["repro_torch.learn.train"]
        spec = tr.curriculum_default()[1][0]
        corners = [dict(c or {}) for c in tr.DEFAULT_CORNERS]
        grads["ring16_grad"] = GradRun(
            SweepRunner(tr.default_engine_cfg(), device="cuda"),
            ScenarioSpec(spec.fabric, spec.workload,
                         make_mlp(weights=init_weights(0))), WEIGHT_KEYS,
            {f: [c.get(f, getattr(cfg, f)) for c in corners]
             for f in ("kmin", "kmax", "xoff")})
    for label, g in grads.items():
        g.warm(min(args.warm, 300))
        lines[label] = {"scenario": label, "gpu": gpu,
                        "n_flows": g.sim.plan.n_flows,
                        "policy": g.policy.name, "step_impl": "torch",
                        "lanes": g.lanes, "first_timed_step": g.it,
                        **g.window(GRAD_STEPS)}
    for key, run in runs.items():
        line = lines[key]
        line["first_traced_step"] = run.it
        line.update(run.trace(args.trace_steps, args.top))
    for label, g in grads.items():
        line = lines[label]
        line["first_traced_step"] = g.it
        for d, t in g.window(GRAD_TRACE_STEPS, args.top).items():
            line.update({f"{d}_{k}": v for k, v in t.items()})
            line[f"{d}_device_idle_share"] = 1.0 - (
                t["device_busy_us_per_step"]
                / (line[f"{d}_host_ms_per_step"] * 1e3))
    if "dlrm_forward" in only:
        lines["dlrm_forward"].update(trace(
            lambda: fwd.advance(TRACE_FORWARDS), TRACE_FORWARDS,
            args.top))
    for impl, dec in decoding.items():
        lines["serve_decode", impl].update(trace(
            lambda dec=dec: dec.advance(TRACE_DECODE), TRACE_DECODE,
            args.top))
    for line in lines.values():
        if "host_ms_per_step" in line:
            line["device_idle_share"] = 1.0 - (
                line["device_busy_us_per_step"]
                / (line["host_ms_per_step"] * 1e3))
        print(json.dumps(line), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(list(lines.values()), indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
