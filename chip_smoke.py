#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA
card: builds the engine-step kernels, holds each against its plain
PyTorch version, drives the simulator's main path through the kernels at
the paper's 128-GPU scale and at 32 GPUs, and checks the results against
the op path and against the JAX reference's completion times.

    python3 chip_smoke.py

Every phase prints one JSON line; a failed phase raises, so the script
exits non-zero.  The line before the last is the kernel table
(``{"kernels": [...]}``), the last line ``{"ok": true, "device": ...}``.
Without CUDA, or outside a checkout holding ``src/repro_torch``, it exits
non-zero and prints no result.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
SRC = REPO / "src"
KERNEL_SOURCE = "src/repro_torch/kernels/engine_step/csrc/engine_step.cu"
REPLACES = {
    "fused_signals_policy": "src/repro/kernels/engine_step/engine_step.py:96",
    "segment_reduce": "src/repro/kernels/engine_step/engine_step.py:171",
    "segment_reduce_pfc": "src/repro/kernels/engine_step/engine_step.py:195",
}
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory (data sheet)
F32_FLOPS = 67e12              # H100 SXM float32 outside the tensor cores

# The JAX reference (jnp step, CPU) on the same scenarios, from
#   PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/port_reference_times.py
# (jax 0.9.0, numpy 2.0.2).  Completion times must agree within two steps.
REFERENCE = {
    ("clos128_1d", "pfc"): 0.020479999482631683,
    ("clos128_1d", "dcqcn"): 0.023399999365210533,
    ("clos128_1d", "hpcc"): 0.024675998836755753,
    ("clos32_2d", "dcqcn"): 0.002959999954327941,
}

DT = 4e-6


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def gpu_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 25, inner: int = 20) -> float:
    """Median over ``reps`` of the per-call device time of ``inner``
    back-to-back calls between two CUDA events (after a warm-up)."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(inner):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / inner)
    return statistics.median(times)


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def fused_case(policy, F: int, B: int, lossy: bool, seed: int, dev):
    """Random-but-plausible stage-1 inputs, state and per-lane params."""
    import torch
    from repro_torch.core import cc
    rng = np.random.default_rng(seed)
    H = 4
    hm = (rng.random((B, H, F)) < 0.7).astype(np.float32)
    hm[:, 0] = 1.0
    kmin = rng.uniform(2e5, 6e5, (B, 1, 1)) * np.ones((1, H, F))
    case = dict(
        q_d=rng.uniform(0, 3e6, (B, H, F)) * hm,
        tx_d=rng.uniform(0, 50e9, (B, H, F)) * hm,
        caps=rng.uniform(10e9, 50e9, (B, H, F)),
        ecn_mask=(rng.random((B, H, F)) < 0.8) * hm,
        hopmask=hm,
        kmin_h=kmin, kmax_h=kmin * 4.0,
        pmax_h=rng.uniform(0.1, 0.3, (B, 1, 1)) * np.ones((1, H, F)),
        base_rtt=rng.uniform(2e-6, 20e-6, (B, F)),
        line=np.full((B, F), 25e9),
        loss=(rng.uniform(0, 0.05, (B, F)) * (rng.random((B, F)) < 0.5)
              if lossy else np.zeros((B, F))),
    )
    case = {k: torch.as_tensor(np.ascontiguousarray(v, np.float32),
                               device=dev) for k, v in case.items()}
    keys = cc.kernel_state_keys(policy)
    line = torch.full((F,), 25e9, dtype=torch.float32)
    ctx = cc.FlowCtx(line=line, bdp=line * 5e-6,
                     fanin=torch.full((F,), 4.0), n_flows=F)
    states = []
    for b in range(B):
        st = policy.init(ctx)
        st = {k: v * torch.as_tensor(rng.uniform(0.5, 1.5, F),
                                     dtype=torch.float32)
              for k, v in st.items()}
        for k in ("t_cut", "t_inc", "t_alpha", "t_rtt", "t_upd"):
            if k in st:
                st[k] = torch.as_tensor(rng.uniform(0, 3e-4, F),
                                        dtype=torch.float32)
        states.append(cc.pack_state(policy, st, n_flows=F))
    state = torch.stack(states).to(dev).contiguous()
    params = torch.stack([
        cc.pack_params(policy, {k: v * (1.0 + 0.15 * b)
                                for k, v in policy.params.items()
                                if not policy.spec[k].init_baked})
        for b in range(B)]).to(dev).contiguous()
    assert state.shape[1] == max(len(keys), 1)
    return case, state, params


def check_fused(dev) -> dict:
    import torch
    from repro_torch.core import cc
    from repro_torch.kernels.engine_step import ops, ref
    worst = 0.0
    worst_rel = 0.0
    n = 0
    for pi, name in enumerate(cc.ALL_POLICIES):
        policy = cc.get_policy(name)
        for lossy in (False, True):
            for F in (1500, 7936, 131072):
                for B in (1, 3):
                    case, state, params = fused_case(
                        policy, F, B, lossy, 1000 * pi + F + B + lossy, dev)
                    args = (*case.values(), state, params)
                    got = ops.fused_signals_policy(policy, *args, 3.3e-4,
                                                   1e-5)
                    want = ref.fused_signals_policy_ref(policy, *args,
                                                        3.3e-4, 1e-5)
                    torch.cuda.synchronize()
                    for g, w in zip(got, want):
                        w = w.expand_as(g)
                        err = (g - w).abs()
                        tol = 1e-5 * w.abs()
                        if not bool((err <= tol).all()):
                            bad = int((err > tol).sum())
                            raise AssertionError(
                                f"fused_signals_policy {name} lossy={lossy}"
                                f" F={F} B={B}: {bad} values beyond rtol "
                                f"1e-5 (max abs err {float(err.max())})")
                        worst = max(worst, float(err.max()))
                        rel = err / w.abs().clamp_min(1e-30)
                        worst_rel = max(worst_rel, float(rel.max()))
                    n += 1
    return {"cases": n, "max_abs_err": worst, "max_rel_err": worst_rel,
            "tolerance": "rtol 1e-5"}


def gather_plans(sims: dict) -> list:
    """Every "gather" reduction plan of the prepared main-path scenarios,
    with its input width."""
    from repro_torch.core.topology import MAXHOP
    out = []
    for label, sim in sims.items():
        plan, pp = sim.plan, sim.pp
        Fp, Lk = plan.n_flows_pad, plan.n_links
        named = [(f"hop{h}", plan.hop[h], pp["r_hop"][h], Fp)
                 for h in range(MAXHOP)]
        named += [("qlink", plan.qlink, pp["r_qlink"], Fp * MAXHOP),
                  ("qport", plan.qport, pp["r_qport"], Fp * MAXHOP),
                  ("group", plan.group, pp["r_group"], Fp),
                  ("pause", plan.pause, pp["r_pause"], Lk),
                  ("qdev", plan.qdev, pp["r_qdev"], Lk)]
        for what, strat, arrs, n_in in named:
            if strat[0] == "gather":
                out.append((label, what, strat[1], strat[2], arrs["idx32"],
                            n_in))
    return out


def check_segments(plans, dev) -> tuple:
    import torch
    from repro_torch.kernels.engine_step import ops, ref
    rng = np.random.default_rng(7)
    worst = {"segment_reduce": 0.0, "segment_reduce_pfc": 0.0}
    rows = []
    for label, what, n_out, C, idx, n_in in plans:
        for B in (1, 3):
            vals = torch.as_tensor(rng.uniform(0, 2e6, (B, n_in)),
                                   dtype=torch.float32, device=dev)
            got = ops.segment_reduce(vals, idx, n_out, C)
            want = ref.segment_reduce_ref(vals, idx, n_out, C)
            mag = ref.segment_reduce_ref(vals.abs(), idx, n_out, C)
            err = (got - want).abs()
            if not bool((err <= 4e-6 * mag).all()):
                raise AssertionError(f"segment_reduce {label}/{what}: "
                                     f"max abs err {float(err.max())}")
            worst["segment_reduce"] = max(worst["segment_reduce"],
                                          float(err.max()))
            # PFC hysteresis around the reduced occupancy
            xoff = (want * torch.as_tensor(rng.uniform(0.5, 1.5, (B, n_out)),
                                           dtype=torch.float32, device=dev)
                    ).contiguous()
            xon = (xoff * 0.8).contiguous()
            can = torch.as_tensor(rng.random((B, n_out)) < 0.7, device=dev)
            prev = torch.as_tensor(rng.random((B, n_out)) < 0.5, device=dev)
            q, paused = ops.segment_reduce_pfc(vals, idx, n_out, C, xoff, xon,
                                               can, prev)
            q_r, paused_r = ref.segment_reduce_pfc_ref(vals, idx, n_out, C,
                                                       xoff, xon, can, prev)
            err = (q - q_r).abs()
            if not bool((err <= 4e-6 * mag).all()):
                raise AssertionError(f"segment_reduce_pfc {label}/{what}: "
                                     f"max abs err {float(err.max())}")
            # paused must agree exactly away from the thresholds
            clear = (((q_r - xoff).abs() > 4e-6 * mag)
                     & ((q_r - xon).abs() > 4e-6 * mag))
            if bool((clear & (paused != paused_r)).any()):
                raise AssertionError(f"segment_reduce_pfc {label}/{what}: "
                                     "paused differs away from thresholds")
            worst["segment_reduce_pfc"] = max(worst["segment_reduce_pfc"],
                                              float(err.max()))
        rows.append(f"{label}/{what} ({n_out}x{C}, n_in={n_in})")
    torch.cuda.synchronize()
    return worst, rows


def time_fused(sim, dev) -> dict:
    """Kernel vs plain time at the main path's shape (the 128-GPU plan's
    padded flow count, DCQCN state)."""
    import torch
    from repro_torch.core import cc
    from repro_torch.kernels.engine_step import ops, ref
    policy = cc.get_policy("dcqcn")
    F = sim.plan.n_flows_pad
    case, state, params = fused_case(policy, F, 1, False, 5, dev)
    K, P = state.shape[1], params.shape[1]
    st_out = torch.empty_like(state)
    rate = torch.empty_like(case["line"])
    win = torch.empty_like(rate)
    fn = ops.kernel_function("fused_signals_policy")
    ptrs = [x.data_ptr() for x in case.values()]
    args = [policy.kernel_id, *ptrs, state.data_ptr(), params.data_ptr(),
            3.3e-4, 1e-5, 1, F, K, P, st_out.data_ptr(), rate.data_ptr(),
            win.data_ptr()]
    stream = torch.cuda.current_stream().cuda_stream

    def launch():
        if fn(*args, stream) != 0:
            raise RuntimeError("fused_signals_policy launch failed")
    ms = cuda_ms(launch)
    plain = cuda_ms(lambda: ref.fused_signals_policy_ref(
        policy, *case.values(), state, params, 3.3e-4, 1e-5), reps=20,
        inner=2)
    n_bytes = 4 * F * (8 * 4 + 3 + K) + 4 * P + 4 * F * (K + 2)
    flops = 60 * F                     # signals + DCQCN update, per flow
    bound = max(n_bytes / HBM_BYTES_PER_S, flops / F32_FLOPS) * 1e3
    return {"ms": ms, "plain_ms": plain, "bound_ms": bound,
            "bound_by": "bytes", "library_ms": None, "shape": f"B=1 F={F} "
            f"K={K} (dcqcn)", "bytes": n_bytes}


def time_segment(sim, strat, arrs, n_in, pfc: bool, dev) -> dict:
    import torch
    from repro_torch.kernels.engine_step import ops, ref
    _, n_out, C = strat
    idx = arrs["idx32"]
    rng = np.random.default_rng(11)
    vals = torch.as_tensor(rng.uniform(0, 2e6, (1, n_in)),
                           dtype=torch.float32, device=dev)
    out = torch.empty((1, n_out), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    n_bytes = 4 * n_in + 4 * n_out * C + 4 * n_out
    if pfc:
        xoff = torch.full((1, n_out), 1e6, device=dev)
        xon = torch.full((1, n_out), 0.8e6, device=dev)
        can = torch.ones((1, n_out), dtype=torch.bool, device=dev)
        prev = torch.zeros((1, n_out), dtype=torch.bool, device=dev)
        paused = torch.empty((1, n_out), dtype=torch.bool, device=dev)
        fn = ops.kernel_function("segment_reduce_pfc")
        args = [vals.data_ptr(), idx.data_ptr(), 1, n_in, n_out, C,
                xoff.data_ptr(), xon.data_ptr(), can.data_ptr(),
                prev.data_ptr(), out.data_ptr(), paused.data_ptr()]
        n_bytes += n_out * (4 + 4 + 1 + 1 + 1)

        def plain():
            ref.segment_reduce_pfc_ref(vals, idx, n_out, C, xoff, xon, can,
                                       prev)
        library = None
    else:
        fn = ops.kernel_function("segment_reduce")
        args = [vals.data_ptr(), idx.data_ptr(), 1, n_in, n_out, C,
                out.data_ptr()]

        def plain():
            ref.segment_reduce_ref(vals, idx, n_out, C)
        # the same sums by one PyTorch call: index_add_ of every input into
        # its segment (inputs in no segment go to a spare row)
        seg_of = np.full(n_in, n_out, np.int64)
        rows = idx.view(n_out, C).cpu().numpy()
        for s in range(n_out):
            members = rows[s][rows[s] < n_in]
            seg_of[members] = s
        seg_of = torch.as_tensor(seg_of, device=dev)
        acc = torch.zeros(n_out + 1, device=dev)
        library = cuda_ms(lambda: acc.index_add_(0, seg_of, vals[0]))

    def launch():
        if fn(*args, stream) != 0:
            raise RuntimeError("segment kernel launch failed")
    return {"ms": cuda_ms(launch), "plain_ms": cuda_ms(plain, reps=20,
                                                       inner=5),
            "bound_ms": n_bytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
            "library_ms": library, "shape": f"n_out={n_out} C={C} "
            f"n_in={n_in}", "bytes": n_bytes}


# ---------------------------------------------------------------------------
# phases 3-5: the main path
# ---------------------------------------------------------------------------

def steps_apart(ta, tb, dt: float):
    """Event times are float32 stamps of (step + 1) * dt: compare them as
    step counts, so a stamp's own rounding is not read as a step."""
    ta = np.where(np.isfinite(ta), ta, 0.0)
    tb = np.where(np.isfinite(tb), tb, 0.0)
    return np.abs(np.rint(np.asarray(ta, np.float64) / dt)
                  - np.rint(np.asarray(tb, np.float64) / dt))


def compare_runs(a, b, dt: float, what: str) -> dict:
    """The port's whole-run tolerances (tests/test_torch_engine.py)."""
    out = {
        "finished_equal": a.finished == b.finished,
        "completion_diff_steps": float(steps_apart(a.completion_time,
                                                   b.completion_time, dt)),
        "t_finish_max_diff_steps": float(np.max(steps_apart(
            a.t_finish, b.t_finish, dt))),
        "t_finish_flows_differing": int(np.sum(steps_apart(
            a.t_finish, b.t_finish, dt) > 0)),
        "delivered_rel_diff": abs(float(a.delivered.sum())
                                  / float(b.delivered.sum()) - 1.0),
        "pause_max_abs_diff": float(np.max(np.abs(a.pause_count
                                                  - b.pause_count))),
    }
    ok = (out["finished_equal"]
          and out["completion_diff_steps"] <= 1
          and out["t_finish_max_diff_steps"] <= 1
          and out["delivered_rel_diff"] <= 1e-4
          and bool(np.all(np.abs(a.pause_count - b.pause_count)
                          <= 1.0 + 1e-3 * np.abs(b.pause_count))))
    if not ok:
        raise AssertionError(f"{what}: kernel and op paths disagree: {out}")
    return out


def run_main(runner, spec, label: str, impl: str) -> tuple:
    import dataclasses
    import torch
    from repro_torch.kernels.engine_step import ops
    cfg = dataclasses.replace(runner.cfg, step_impl=impl)
    before = dict(ops.LAUNCHES)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r = runner.run_spec(spec, cfg=cfg)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: ops.LAUNCHES[k] - before[k] for k in before}
    if not r.finished:
        raise AssertionError(f"{label} {spec.policy} ({impl}) did not finish")
    line = {"phase": "main_path", "scenario": label, "policy": spec.policy,
            "step_impl": impl, "n_flows": r.meta["n_flows"],
            "finished": r.finished, "completion_time": r.completion_time,
            "steps_run": r.meta["steps_run"],
            "steps_executed": r.meta["steps_executed"], "wall_s": wall,
            "steps_per_s": r.meta["steps_executed"] / wall,
            "pause_frames": float(r.pause_count.sum()),
            "launches": launches}
    emit(line)
    return r, launches


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "__init__.py").is_file():
        print(f"chip_smoke: no src/repro_torch beside {__file__}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    t_start = time.perf_counter()

    from repro_torch.core import (CollectiveSpec, EngineConfig, FabricSpec,
                                  ScenarioSpec, SweepRunner)
    from repro_torch.kernels import build
    from repro_torch.kernels.engine_step import ops

    # ---- 1. build --------------------------------------------------------
    gpu = gpu_line()
    t0 = time.perf_counter()
    build.load("engine_step")
    info = build.BUILD_INFO.get("engine_step", {})
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "nvcc": info.get("nvcc"), "gpu": gpu,
          "ptxas": info.get("ptxas", "")[-1500:]})

    cfg = EngineConfig(dt=DT, max_steps=6000, max_extends=6, queue_stride=0)
    runner = SweepRunner(cfg, device="cuda")
    scen = {
        "clos128_1d": (FabricSpec("clos", n_racks=8, nodes_per_rack=2,
                                  gpus_per_node=8, oversubscription=2.0),
                       CollectiveSpec("1d", 128e6)),
        "clos32_2d": (FabricSpec("clos", n_racks=2, nodes_per_rack=2,
                                 gpus_per_node=8, oversubscription=2.0),
                      CollectiveSpec("2d", 128e6)),
    }
    sims = {}
    for label, (fab, wl) in scen.items():
        topo, sched, pol = ScenarioSpec(fab, wl, "dcqcn").build()
        sims[label] = runner.simulator(topo, sched, pol)

    # ---- 2. kernels against their plain versions -------------------------
    fused = check_fused(dev)
    emit({"phase": "kernel_check", "kernel": "fused_signals_policy",
          **fused})
    plans = gather_plans(sims)
    seg_err, seg_rows = check_segments(plans, dev)
    emit({"phase": "kernel_check", "kernel": "segment_reduce(+_pfc)",
          "plans": seg_rows, "max_abs_err": seg_err,
          "tolerance": "|err| <= 4e-6 * sum|members|; paused exact away "
                       "from the thresholds"})
    s128, s32 = sims["clos128_1d"], sims["clos32_2d"]
    timing = {
        "fused_signals_policy": time_fused(s128, dev),
        # the PAUSE tally, the gather plan the 128-GPU step runs every step
        "segment_reduce": time_segment(s128, s128.plan.pause,
                                       s128.pp["r_pause"],
                                       s128.plan.n_links, False, dev),
        # the per-port reduction + hysteresis of the 32-GPU step
        "segment_reduce_pfc": time_segment(s32, s32.plan.qport,
                                           s32.pp["r_qport"],
                                           4 * s32.plan.n_flows_pad, True,
                                           dev),
    }
    emit({"phase": "kernel_timing", "gpu": gpu, **timing})

    # ---- 3. main path at the paper's scale ---------------------------------
    ops.reset_launches()
    results = {}
    for pol in ("pfc", "dcqcn", "hpcc"):
        fab, wl = scen["clos128_1d"]
        r, launches = run_main(runner, ScenarioSpec(fab, wl, pol),
                               "clos128_1d", "cuda")
        # one fused launch and one PAUSE-tally reduction per executed step
        steps = r.meta["steps_executed"]
        if launches["fused_signals_policy"] != steps or \
                launches["segment_reduce"] < steps:
            raise AssertionError(f"clos128_1d {pol}: {launches} launches "
                                 f"for {steps} executed steps")
        results[("clos128_1d", pol)] = r
    fab, wl = scen["clos128_1d"]
    r_t, l_t = run_main(runner, ScenarioSpec(fab, wl, "dcqcn"),
                        "clos128_1d", "torch")
    if any(l_t.values()):
        raise AssertionError(f"op path launched kernels: {l_t}")
    emit({"phase": "kernel_vs_op_path", "scenario": "clos128_1d",
          "policy": "dcqcn", **compare_runs(results[("clos128_1d", "dcqcn")],
                                            r_t, DT, "clos128_1d dcqcn")})

    # ---- 4. main path where all three kernels run ---------------------------
    fab, wl = scen["clos32_2d"]
    r_k, l_k = run_main(runner, ScenarioSpec(fab, wl, "dcqcn"), "clos32_2d",
                        "cuda")
    if not all(v > 0 for v in l_k.values()):
        raise AssertionError(f"clos32_2d: a kernel did not run: {l_k}")
    r_t, l_t = run_main(runner, ScenarioSpec(fab, wl, "dcqcn"), "clos32_2d",
                        "torch")
    if any(l_t.values()):
        raise AssertionError(f"op path launched kernels: {l_t}")
    results[("clos32_2d", "dcqcn")] = r_k
    emit({"phase": "kernel_vs_op_path", "scenario": "clos32_2d",
          "policy": "dcqcn", **compare_runs(r_k, r_t, DT, "clos32_2d dcqcn")})
    main_launches = dict(ops.LAUNCHES)

    # ---- 5. against the JAX reference ---------------------------------------
    rows = []
    for key, want in REFERENCE.items():
        got = results[key].completion_time
        diff = float(steps_apart(got, want, DT))
        rows.append({"scenario": key[0], "policy": key[1], "port": got,
                     "reference": want, "diff_steps": diff})
        if diff > 2:
            raise AssertionError(f"{key}: completion {got} vs reference "
                                 f"{want} ({diff:.2f} steps)")
    emit({"phase": "reference", "tolerance_steps": 2, "rows": rows})

    # ---- kernel table, device line ----------------------------------------
    errs = {"fused_signals_policy": fused["max_abs_err"], **seg_err}
    kernels = []
    for name in ("fused_signals_policy", "segment_reduce",
                 "segment_reduce_pfc"):
        if main_launches[name] == 0:
            raise AssertionError(f"{name} never launched on the main path")
        tm = timing[name]
        kernels.append({"name": name, "route": "cuda",
                        "source": KERNEL_SOURCE, "replaces": REPLACES[name],
                        "launches": main_launches[name],
                        "max_abs_err": errs[name], "ms": tm["ms"],
                        "plain_ms": tm["plain_ms"],
                        "bound_ms": tm["bound_ms"],
                        "bound_by": tm["bound_by"],
                        "library_ms": tm["library_ms"]})
    emit({"phase": "done", "seconds": time.perf_counter() - t_start})
    print(gpu, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
