#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA
card: builds the engine-step and embedding-bag kernels, holds each against
its plain PyTorch version, drives the simulator's main path through the
kernels at the paper's 128-GPU scale and at 32 GPUs, scores a batch on the
paper's Table II DLRM through the embedding-bag kernel, simulates that
DLRM's training iteration on the 128-GPU platform under PFC and DCQCN, and
checks the results against the plain paths and against constants from the
JAX reference.

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
EMB_SOURCE = "src/repro_torch/kernels/embedding_bag/csrc/embedding_bag.cu"
SOURCES = {"fused_signals_policy": KERNEL_SOURCE,
           "segment_reduce": KERNEL_SOURCE,
           "segment_reduce_pfc": KERNEL_SOURCE,
           "embedding_bag_rows": EMB_SOURCE}
REPLACES = {
    "fused_signals_policy": "src/repro/kernels/engine_step/engine_step.py:96",
    "segment_reduce": "src/repro/kernels/engine_step/engine_step.py:171",
    "segment_reduce_pfc": "src/repro/kernels/engine_step/engine_step.py:195",
    "embedding_bag_rows":
        "src/repro/kernels/embedding_bag/embedding_bag.py:31",
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

# The DLRM training iteration on the 128-GPU platform, 2D all-reduce, by
# the JAX reference with the All-To-All salted by zlib.crc32 (the port's
# salt), from the same script (jax 0.9.0, numpy 2.0.2): 152,581 flows.
# Times must agree within two steps, PAUSE frames within rtol 1e-3 + 1.
DLRM_ITER_REFERENCE = {
    "pfc": {"iteration_time": 0.006173999939113856,
            "exposed_comm": 0.0025939999391138557, "pfc_pauses": 27308},
    "dcqcn": {"iteration_time": 0.0070779998376965525,
              "exposed_comm": 0.0034979998376965526, "pfc_pauses": 10600},
}
DLRM_ITER_FLOWS = 152581

DT = 4e-6

# dlrm_reference: Table II widths with small tables, weights from numpy
DLRM_REF_ROWS = 8192
DLRM_REF_SEED = 0
DLRM_REF_BATCH = 64
DLRM_REF_RTOL, DLRM_REF_ATOL = 2e-2, 2e-3
# its logits by the JAX reference (jnp embedding path, and the Pallas one
# in interpret mode: equal), from the same script (jax 0.9.0, numpy 2.0.2)
DLRM_REF_LOGITS = [
    -1.7109375, -1.6875, -1.640625, -1.796875, -1.8828125, -1.75, -1.734375,
    -1.4765625, -1.640625, -1.8515625, -1.8828125, -1.8828125, -1.796875,
    -1.6328125, -1.65625, -1.640625, -1.8515625, -1.8203125, -1.7421875,
    -1.5625, -1.9140625, -2.15625, -1.8984375, -1.71875, -2.3125, -1.6875,
    -1.9609375, -2.109375, -1.5703125, -1.4375, -1.8671875, -1.9453125,
    -1.7578125, -1.5859375, -1.9765625, -1.640625, -1.8828125, -1.8359375,
    -1.640625, -1.5625, -1.515625, -1.5390625, -1.65625, -1.34375, -2.296875,
    -1.75, -1.9609375, -1.5625, -2.109375, -1.7734375, -1.703125, -1.625,
    -1.5859375, -1.65625, -1.640625, -1.859375, -1.578125, -1.3828125,
    -2.171875, -1.8671875, -1.8125, -1.96875, -1.8125, -2.046875,
]


def bf16_bits(x: np.ndarray) -> np.ndarray:
    """float32 -> bfloat16 bit patterns (uint16), rounded to nearest even
    (finite inputs)."""
    u = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return ((u + np.uint32(0x7FFF) + ((u >> 16) & np.uint32(1))) >> 16
            ).astype(np.uint16)


def dlrm_numpy_params(shapes: dict, seed: int) -> dict:
    """DLRM weights drawn by numpy from ``seed`` for a parameter tree of
    ``shapes`` (``{"tables": (T, R, D), "bot": {name: shape}, "top":
    {...}}`` in the models' leaf order): tables 0.02 * N(0, 1) (the models'
    rule), MLP weights He-normal (std sqrt(2 / fan_in)) and biases 0.1 *
    N(0, 1), so that the activations keep their scale through the 19 ReLU
    layers and the logits are of order 1, where a tolerance on them bites.
    The tables come as bf16 bit patterns (uint16), the rest float32.  The
    JAX reference (``scripts/port_reference_times.py``) and the port are
    fed the same bits."""
    rng = np.random.default_rng(seed)
    T, R, D = shapes["tables"]
    tables = np.empty((T, R, D), np.uint16)
    for t in range(T):
        tables[t] = bf16_bits(0.02 * rng.standard_normal((R, D), np.float32))
    tree = {"tables": tables}
    for part in ("bot", "top"):
        tree[part] = {}
        for name, shape in shapes[part].items():
            std = np.sqrt(2.0 / shape[0]) if len(shape) == 2 else 0.1
            tree[part][name] = (rng.standard_normal(shape, np.float32)
                                * np.float32(std))
    return tree


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


# ---------------------------------------------------------------------------
# phases 6-9: the DLRM path
# ---------------------------------------------------------------------------

def dlrm_kernel_check(dev) -> dict:
    """The embedding-bag kernel against its plain version, both wrappers,
    bit for bit, over the widths, pooling factors, table counts and sizes
    and batches of the DLRM path (the largest stack is 16 GB)."""
    import torch
    from repro_torch.common import init as init_mod
    from repro_torch.kernels.embedding_bag import ops, ref
    rng = np.random.default_rng(12)
    n = elements = differing = 0
    worst = 0.0
    for T in (3, 64):
        for R in (1000, 1_000_000):
            for D in (8, 64, 128):
                gen = torch.Generator(device=dev).manual_seed(T + R + D)
                tab = init_mod.make((T, R, D), "normal", torch.bfloat16, gen,
                                    dev)
                offset = torch.arange(T, dtype=torch.int32, device=dev) * R
                for P in (1, 5, 60):
                    for B in (1, 7, 256):
                        idx = torch.as_tensor(rng.integers(
                            0, R, (B, T, P), dtype=np.int32), device=dev)
                        rows = (idx + offset[None, :, None]).view(B * T, P)
                        pairs = [
                            (ops.embedding_bag_stacked(tab, idx),
                             ref.embedding_bag_stacked_ref(tab, idx)),
                            (ops.embedding_bag_rows(tab.view(T * R, D), rows),
                             ref.embedding_bag_rows_ref(tab.view(T * R, D),
                                                        rows))]
                        for got, want in pairs:
                            if got.dtype == torch.bfloat16:
                                bad = got.view(torch.int16) != \
                                    want.view(torch.int16)
                            else:
                                bad = got != want
                            differing += int(bad.sum())
                            elements += got.numel()
                            worst = max(worst, float(
                                (got.float() - want.float()).abs().max()))
                        n += 1
                del tab
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    out = {"cases": n, "elements": elements, "differing": differing,
           "max_abs_err": worst, "tolerance": "bit-equal"}
    if differing:
        raise AssertionError(f"embedding_bag: {differing} elements differ "
                             f"from the plain version: {out}")
    return out


def time_embedding(model, B: int, dev) -> dict:
    """Kernel, plain version and ``F.embedding_bag`` on the model's Table
    II tables, for a batch of B samples from ``dlrm_batch``."""
    import torch
    import torch.nn.functional as F
    from repro_torch.data import dlrm_batch
    from repro_torch.kernels.embedding_bag import ops, ref
    tables = model.tables.data
    T, R, D = tables.shape
    idx = torch.as_tensor(dlrm_batch(0, 1, B, model.cfg)["sparse_idx"],
                          device=dev)
    P = idx.shape[2]
    NB = B * T
    table2d, ids = tables.view(T * R, D), idx.view(NB, P)
    out = torch.empty((NB, D), dtype=torch.bfloat16, device=dev)
    fn = ops.kernel_function()
    args = ops.kernel_args(table2d, ids, T, R, out)
    stream = torch.cuda.current_stream().cuda_stream

    def launch():
        if fn(*args, stream) != 0:
            raise RuntimeError("embedding_bag launch failed")
    rows64 = (idx.long() + torch.arange(T, device=dev)[None, :, None] * R
              ).view(NB, P)
    library = cuda_ms(lambda: F.embedding_bag(rows64, table2d, mode="sum"),
                      reps=10, inner=5)
    ms = cuda_ms(launch, reps=10, inner=5)
    plain = cuda_ms(lambda: ref.embedding_bag_stacked_ref(tables, idx),
                    reps=5, inner=2)
    # each gathered row, each id and each output element once
    n_bytes = NB * P * D * 2 + NB * P * 4 + NB * D * 2
    flops = NB * P * D                     # the float32 adds
    bound = max(n_bytes / HBM_BYTES_PER_S, flops / F32_FLOPS) * 1e3
    return {"ms": ms, "plain_ms": plain, "bound_ms": bound,
            "bound_by": "bytes", "library_ms": library,
            "shape": f"B={B} T={T} P={P} D={D} R={R}", "bytes": n_bytes}


def dlrm_forward(gpu: str, dev) -> tuple:
    """The paper's Table II DLRM (1,000,000 rows a table) built on the card
    and scoring one batch of 256 through the entry points; the kernel path
    against the plain one, and the kernel's times."""
    import dataclasses
    import torch
    from repro_torch.configs import get_model
    from repro_torch.data import dlrm_batch
    from repro_torch.kernels.embedding_bag import ops
    from repro_torch.models import DLRM
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = get_model("dlrm", device="cuda", seed=0)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    cfg = model.cfg
    batch = dlrm_batch(0, 0, 256, cfg)
    ops.reset_launches()
    logits = model(batch)
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    if launches["embedding_bag_rows"] != 1:
        raise AssertionError(f"dlrm_forward: {launches} embedding-bag "
                             "launches for one forward")
    plain = DLRM(dataclasses.replace(cfg, embedding_impl="torch"),
                 device="cuda", params={
                     "tables": model.tables.data,
                     "bot": {k: v.data for k, v in model.bot.items()},
                     "top": {k: v.data for k, v in model.top.items()}})
    want = plain(batch)
    if tuple(logits.shape) != (256,) or not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"dlrm_forward: logits of shape "
                             f"{tuple(logits.shape)}, finite "
                             f"{bool(torch.isfinite(logits).all())}")
    if not torch.equal(logits.view(torch.int16), want.view(torch.int16)):
        raise AssertionError("dlrm_forward: kernel and plain paths give "
                             "different logits")
    dev_batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
    fwd_ms = cuda_ms(lambda: model(dev_batch), reps=10, inner=5)
    plain_fwd_ms = cuda_ms(lambda: plain(dev_batch), reps=10, inner=5)
    timing = {B: time_embedding(model, B, dev) for B in (256, 2048)}
    emit({"phase": "dlrm_forward", "gpu": gpu, "batch": 256,
          "rows_per_table": cfg.rows_per_table,
          "tables_bytes": model.tables.numel() * 2,
          "logits_equal_plain_path": True,
          "logits_mean": float(logits.float().mean()),
          "launches": launches, "build_s": build_s, "cuda_ms": fwd_ms,
          "plain_path_cuda_ms": plain_fwd_ms,
          "samples_per_s": 256 / (fwd_ms * 1e-3),
          "peak_bytes": peak,
          "embedding_bag": {f"B={B}": t for B, t in timing.items()}})
    del plain, model
    torch.cuda.empty_cache()
    return launches, timing[256]


def dlrm_reference(dev) -> dict:
    """Table II widths with small tables and numpy weights, against the
    JAX reference's logits on the same inputs, under the flags that
    ``dlrm_forward`` runs with (PyTorch's default bf16 reduction flag,
    which the forward overrides itself; TF32 off)."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import dlrm_batch
    from repro_torch.models import DLRM, param_shapes
    cfg = dataclasses.replace(get_config("dlrm"),
                              rows_per_table=DLRM_REF_ROWS)
    shapes = param_shapes(cfg)
    tree = dlrm_numpy_params(
        {"tables": shapes["tables"][0],
         **{part: {k: leaf[0] for k, leaf in shapes[part].items()}
            for part in ("bot", "top")}}, DLRM_REF_SEED)
    params = {"tables": torch.from_numpy(tree["tables"].view(np.int16))
              .view(torch.bfloat16).to(dev)}
    for part in ("bot", "top"):
        params[part] = {k: torch.from_numpy(v).to(dev)
                        for k, v in tree[part].items()}
    matmul = torch.backends.cuda.matmul
    if not matmul.allow_bf16_reduced_precision_reduction:
        raise AssertionError("dlrm_reference: expected PyTorch's default "
                             "allow_bf16_reduced_precision_reduction=True")
    model = DLRM(cfg, device="cuda", params=params)
    got = model(dlrm_batch(DLRM_REF_SEED, 0, DLRM_REF_BATCH, cfg))
    got = got.float().cpu().numpy()
    want = np.asarray(DLRM_REF_LOGITS, np.float32)
    err = np.abs(got - want)
    out = {"batch": len(want), "max_abs_err": float(err.max()),
           "max_rel_err": float(np.max(err / np.abs(want))),
           "elements_equal": int(np.sum(got == want)),
           "tolerance": f"rtol {DLRM_REF_RTOL}, atol {DLRM_REF_ATOL}"}
    if got.shape != want.shape or not np.all(
            err <= DLRM_REF_ATOL + DLRM_REF_RTOL * np.abs(want)):
        raise AssertionError(f"dlrm_reference: logits off the reference: "
                             f"{out}")
    return out


def dlrm_iteration(cfg, gpu: str) -> dict:
    """The DLRM training iteration on the paper's 128-GPU platform under
    PFC and DCQCN (kernel step path), against the reference's constants.
    Returns the engine kernels' launches over the two runs."""
    import torch
    from repro_torch.core import (DLRMCommSpec, FabricSpec, SweepRunner,
                                  build_dlrm_iteration, get_policy,
                                  simulate_dlrm_policies)
    from repro_torch.kernels.engine_step import ops
    fab = FabricSpec("clos", n_racks=8, nodes_per_rack=2, gpus_per_node=8,
                     oversubscription=2.0)
    topo, gpus = fab.build(), list(range(fab.n_gpus))
    comm = DLRMCommSpec(allreduce_algo="2d")
    runner = SweepRunner(cfg, device="cuda")
    t0 = time.perf_counter()
    sched = build_dlrm_iteration(topo, gpus, comm=comm)
    for pol in DLRM_ITER_REFERENCE:      # plans on the card ahead of time
        runner.simulator(topo, sched, get_policy(pol))
    prep_s = time.perf_counter() - t0
    if sched.n_flows != DLRM_ITER_FLOWS:
        raise AssertionError(f"dlrm_iteration: {sched.n_flows} flows, the "
                             f"reference has {DLRM_ITER_FLOWS}")
    total = {k: 0 for k in ops.LAUNCHES}
    rows = []
    for pol, want in DLRM_ITER_REFERENCE.items():
        ops.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        (rep,) = simulate_dlrm_policies(topo, gpus, (pol,), comm=comm,
                                        cfg=cfg, runner=runner)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(ops.LAUNCHES)
        steps = launches["fused_signals_policy"]   # one per executed step
        if steps == 0 or launches["segment_reduce"] == 0:
            raise AssertionError(f"dlrm_iteration {pol}: a kernel of the "
                                 f"step did not run: {launches}")
        for k, v in launches.items():
            total[k] += v
        row = {"policy": pol, "finished": rep.finished,
               "iteration_time": rep.iteration_time,
               "reference": want["iteration_time"],
               "diff_steps": abs(rep.iteration_time
                                 - want["iteration_time"]) / DT,
               "exposed_comm": rep.exposed_comm,
               "exposed_diff_steps": abs(rep.exposed_comm
                                         - want["exposed_comm"]) / DT,
               "pfc_pauses": rep.pfc_pauses,
               "reference_pauses": want["pfc_pauses"],
               "steps_executed": steps, "wall_s": wall,
               "steps_per_s": steps / wall, "launches": launches}
        rows.append(row)
        if not (rep.finished and row["diff_steps"] <= 2
                and row["exposed_diff_steps"] <= 2
                and abs(rep.pfc_pauses - want["pfc_pauses"])
                <= 1 + 1e-3 * want["pfc_pauses"]):
            raise AssertionError(f"dlrm_iteration {pol}: off the reference: "
                                 f"{row}")
    emit({"phase": "dlrm_iteration", "gpu": gpu, "n_flows": sched.n_flows,
          "prep_s": prep_s, "tolerance": "2 steps on the times; PAUSE "
          "rtol 1e-3 + atol 1", "rows": rows})
    return total


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

    # ---- 1. build (one nvcc per source, all at once) ----------------------
    gpu = gpu_line()
    t0 = time.perf_counter()
    build.build_all()
    for name in build.SOURCES:
        build.load(name)
    info = build.BUILD_INFO
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "sources": {k: v.get("seconds") for k, v in info.items()},
          "nvcc": next(iter(info.values()), {}).get("nvcc"), "gpu": gpu,
          "ptxas": {k: v.get("ptxas", "")[-1500:] for k, v in info.items()}})

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

    # ---- 6. DLRM: the embedding-bag kernel against its plain version -------
    emb_check = dlrm_kernel_check(dev)
    emit({"phase": "dlrm_kernel_check", "kernel": "embedding_bag_rows",
          **emb_check})

    # ---- 7. DLRM: Table II scoring through the kernel ----------------------
    emb_launches, timing["embedding_bag_rows"] = dlrm_forward(gpu, dev)

    # ---- 8. DLRM: against the JAX reference's logits ------------------------
    emit({"phase": "dlrm_reference", **dlrm_reference(dev)})

    # ---- 9. DLRM: the training iteration under each policy ------------------
    iter_launches = dlrm_iteration(cfg, gpu)

    # ---- kernel table, device line ----------------------------------------
    # launches: the sum over the paths each kernel runs on, each path's
    # counts set to 0 just before it and read just after
    path_launches = {k: main_launches[k] + iter_launches[k]
                     for k in main_launches}
    path_launches.update(emb_launches)
    errs = {"fused_signals_policy": fused["max_abs_err"], **seg_err,
            "embedding_bag_rows": emb_check["max_abs_err"]}
    kernels = []
    for name in SOURCES:
        if path_launches[name] == 0:
            raise AssertionError(f"{name} never launched on the main path")
        tm = timing[name]
        kernels.append({"name": name, "route": "cuda",
                        "source": SOURCES[name], "replaces": REPLACES[name],
                        "launches": path_launches[name],
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
