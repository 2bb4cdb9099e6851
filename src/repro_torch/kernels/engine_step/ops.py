"""Wrappers of the engine-step CUDA kernels (``csrc/engine_step.cu``).

Each wrapper takes the kernel's layout with a leading lane axis ``B``.
For tensors on the CPU it returns the plain version from ``ref.py``; for
CUDA tensors it checks device, dtype, shape and contiguity, allocates the
outputs, launches on PyTorch's current stream, raises if the launch
returns a CUDA error, and adds one to ``LAUNCHES[name]``.  There is no
fallback: a CUDA tensor either goes through the kernel or raises.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core import cc as cc_mod
from repro_torch.core.topology import MAXHOP
from repro_torch.kernels import build
from repro_torch.kernels.checks import check as _check
from repro_torch.kernels.checks import on_cuda as _on_cuda
from repro_torch.kernels.engine_step import ref

# kernel launches since the last reset_launches(); only the CUDA branch of
# each wrapper counts, the plain versions never do
LAUNCHES = {"fused_signals_policy": 0, "segment_reduce": 0,
            "segment_reduce_pfc": 0}

# the state/param slot orders the device functions read (engine_step.cu);
# checked against the Python tables before a launch
KERNEL_ABI = {
    "pfc": ((), ()),
    "dcqcn": (("alpha", "inc_count", "jit", "rc", "rt", "t_alpha", "t_cut",
               "t_inc"),
              ("cut_gap", "ecn_thresh", "fast_rounds", "g", "hai_after",
               "mss", "rai_frac", "rhai_frac", "timer")),
    "dctcp": (("alpha", "bdp", "t_rtt", "w"),
              ("ecn_thresh", "g", "mss", "wmax_bdp")),
    "timely": (("grad", "neg_count", "rate", "rtt_prev", "t_upd"),
               ("add_frac", "beta", "ewma", "hai_thresh", "thigh", "tlow")),
    "hpcc": (("bdp", "stage", "t_rtt", "w", "wc"),
             ("eta", "max_stage", "wai_frac")),
    "hpcc_pint": (("bdp", "stage", "t_rtt", "w", "wc"),
                  ("eta", "max_stage", "wai_frac")),
    "static_window": (("w",), ("headroom", "margin", "min_w")),
    "mlp": (("bdp", "fanin", "rate", "win"),
            ("b1_0", "b1_1", "b1_2", "b1_3", "b2_0", "b2_1", "loss_cut",
             "out_gain")
            + tuple(f"w1_{j}{i}" for j in range(4) for i in range(6))
            + tuple(f"w2_{o}{j}" for o in range(2) for j in range(4))),
}

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    "fused_signals_policy": [_I] + [_P] * 13 + [_F, _F, _F] + [_I] * 4
                            + [_P] * 4,
    "segment_reduce": [_P, _P, _I, _I, _I, _I, _P, _P],
    "segment_reduce_pfc": [_P, _P, _I, _I, _I, _I] + [_P] * 7,
}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def kernel_function(name: str):
    """The C entry point ``name`` of the built library (argtypes set).
    Calling it directly bypasses the wrapper's checks and launch count;
    ``chip_smoke.py`` does so only to time back-to-back launches."""
    lib = build.load("engine_step")
    fn = getattr(lib, name)
    if fn.argtypes is None:
        fn.argtypes = _SIGNATURES[name]
        fn.restype = ctypes.c_int
    return fn


def _launch(name: str, args) -> None:
    stream = torch.cuda.current_stream().cuda_stream
    err = kernel_function(name)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError_t "
                           f"{err}")
    LAUNCHES[name] += 1


def _kernel_id(policy) -> int:
    if policy.kernel_id is None or policy.name not in KERNEL_ABI:
        raise NotImplementedError(
            f"policy {policy.name!r} has no device function in the fused "
            "CUDA step kernel; run it with step_impl='torch'")
    want = KERNEL_ABI[policy.name]
    have = (cc_mod.kernel_state_keys(policy), cc_mod.kernel_param_keys(policy))
    if have != want:
        raise ValueError(f"policy {policy.name!r}: state/param keys {have} "
                         f"differ from the kernel's slots {want}")
    return policy.kernel_id


def fused_signals_policy(policy, q_d, tx_d, caps, ecn_mask, hopmask,
                         kmin_h, kmax_h, pmax_h, base_rtt, line, loss,
                         state, params, t: float, t_base_util: float,
                         dt: float):
    """Engine stages 1+2 (delayed signals + the policy's update) for B
    lanes: hop inputs ``(B, MAXHOP, F)``, flat inputs ``(B, F)``, ``state
    (B, K, F)``, ``params (B, P)``, all float32; ``t`` the step's time
    and ``dt`` the step size (the learned policy tracks its targets at
    dt / RTT).  Returns ``(state', rate, win)`` with shapes ``(B, K,
    F)``, ``(B, F)``, ``(B, F)``."""
    hop = (q_d, tx_d, caps, ecn_mask, hopmask, kmin_h, kmax_h, pmax_h)
    flat = (base_rtt, line, loss)
    if not _on_cuda(hop + flat + (state, params)):
        return ref.fused_signals_policy_ref(policy, *hop, *flat, state,
                                            params, t, t_base_util, dt)
    pid = _kernel_id(policy)
    B, H, F = q_d.shape
    K, P = state.shape[1], params.shape[1]
    if H != MAXHOP:
        raise ValueError(f"hop axis must be MAXHOP={MAXHOP}, got {H}")
    if K != max(len(KERNEL_ABI[policy.name][0]), 1):
        raise ValueError(f"state rows {K} do not match {policy.name!r}")
    if P != max(len(KERNEL_ABI[policy.name][1]), 1):
        raise ValueError(f"param columns {P} do not match {policy.name!r}")
    names = ("q_d", "tx_d", "caps", "ecn_mask", "hopmask", "kmin_h",
             "kmax_h", "pmax_h")
    for n, x in zip(names, hop):
        _check(x, n, (B, H, F), torch.float32)
    for n, x in zip(("base_rtt", "line", "loss"), flat):
        _check(x, n, (B, F), torch.float32)
    _check(state, "state", (B, K, F), torch.float32)
    _check(params, "params", (B, P), torch.float32)
    st_out = torch.empty_like(state)
    rate = torch.empty_like(line)
    win = torch.empty_like(line)
    _launch("fused_signals_policy",
            [pid, *(x.data_ptr() for x in hop + flat), state.data_ptr(),
             params.data_ptr(), float(t), float(t_base_util), float(dt), B,
             F, K, P,
             st_out.data_ptr(), rate.data_ptr(), win.data_ptr()])
    return st_out, rate, win


def _check_seg(vals, idx, n_out: int, C: int):
    if vals.dim() != 2:
        raise ValueError(f"vals must be (B, n_in), got {tuple(vals.shape)}")
    if not 1 <= C <= 64 or C & (C - 1):
        raise ValueError(f"segment width C={C} is not a power of two in "
                         "1..64 (wider segments use the gather2 plan)")
    B, n_in = vals.shape
    _check(vals, "vals", (B, n_in), torch.float32)
    _check(idx, "idx", (n_out * C,), torch.int32)
    return B, n_in


def segment_reduce(vals, idx, n_out: int, C: int):
    """The plan's "gather" reduction for B lanes: ``vals (B, n_in)``, the
    flat ``(n_out*C,)`` int32 index matrix with ``n_in`` as the "+0"
    slot; returns ``(B, n_out)``."""
    if not _on_cuda((vals, idx)):
        return ref.segment_reduce_ref(vals, idx, n_out, C)
    B, n_in = _check_seg(vals, idx, n_out, C)
    out = torch.empty((B, n_out), dtype=torch.float32, device=vals.device)
    _launch("segment_reduce", [vals.data_ptr(), idx.data_ptr(), B, n_in,
                               n_out, C, out.data_ptr()])
    return out


def segment_reduce_pfc(vals, idx, n_out: int, C: int, xoff, xon, can_pause,
                       prev_paused):
    """Per-ingress-port occupancy + PFC hysteresis for B lanes: ``xoff``,
    ``xon`` float32 and ``can_pause``, ``prev_paused`` bool, all ``(B,
    n_out)``.  Returns ``(q (B, n_out) float32, paused (B, n_out) bool)``."""
    per_seg = (xoff, xon, can_pause, prev_paused)
    if not _on_cuda((vals, idx) + per_seg):
        return ref.segment_reduce_pfc_ref(vals, idx, n_out, C, *per_seg)
    B, n_in = _check_seg(vals, idx, n_out, C)
    _check(xoff, "xoff", (B, n_out), torch.float32)
    _check(xon, "xon", (B, n_out), torch.float32)
    _check(can_pause, "can_pause", (B, n_out), torch.bool)
    _check(prev_paused, "prev_paused", (B, n_out), torch.bool)
    q = torch.empty((B, n_out), dtype=torch.float32, device=vals.device)
    paused = torch.empty((B, n_out), dtype=torch.bool, device=vals.device)
    _launch("segment_reduce_pfc",
            [vals.data_ptr(), idx.data_ptr(), B, n_in, n_out, C,
             xoff.data_ptr(), xon.data_ptr(), can_pause.data_ptr(),
             prev_paused.data_ptr(), q.data_ptr(), paused.data_ptr()])
    return q, paused
