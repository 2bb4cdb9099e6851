"""Wrappers of the engine-step CUDA kernels (``csrc/engine_step.cu``).

Each wrapper takes the kernel's layout with a leading lane axis ``B``.
For tensors on the CPU it returns the plain version from ``ref.py``; for
CUDA tensors it checks device, dtype, shape and contiguity, allocates the
outputs, launches on PyTorch's current stream, raises if the launch
returns a CUDA error, and adds one to ``LAUNCHES[name]``.  There is no
fallback: a CUDA tensor either goes through the kernel or raises.

The fused kernel is persistent: ``fused_plan`` gives it as many blocks as
the card keeps resident (the occupancy query of the built library, per
policy and state width) and the work items, tiles of ``TILE`` flows of
one lane, that each block walks (``plan_items`` spells the walk out).  A
tile's rows reach shared memory by 16-byte ``cp.async`` where every row
is 16-byte aligned (``vector_copies``), else by 4-byte ``cp.async``.
``scalar_fn`` runs the policies' scalar device functions (exp, tanh, the
logistic, the flush of a multiply-add's result) elementwise, so that a check can hold each against its plain
version in ``core/arith.py`` over every float32 input.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core import arith
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

# flows per work item of the fused kernel, one thread each
# (engine_step.cu: TILE)
TILE = 128

# the device scalar functions scalar_fn evaluates, by index
# (engine_step.cu: scalar_fn_kernel), each named as its plain version
SCALAR_FNS = {"expf": 0, "tanhf": 1, "sigmoidf": 2, "ftz": 3}

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    "fused_signals_policy": [_I] + [_P] * 13 + [_F, _F, _F] + [_I] * 4
                            + [_P] * 3 + [_I] * 3 + [_P],
    "fused_signals_policy_resident": [_I, _I, _P],
    "fused_signals_policy_rows": [_I, _I],
    "scalar_fn": [_I, _P, _P, ctypes.c_long, _P],
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


def vector_copies(F: int, ptrs) -> bool:
    """Whether the tile rows can be copied 16 bytes at a time: each row of
    the streamed inputs starts and ends on a 16-byte boundary (``F`` a
    multiple of 4 and every base pointer 16-byte aligned)."""
    return F % 4 == 0 and all(p % 16 == 0 for p in ptrs)


def fused_plan(B: int, F: int, resident: int, tile: int = TILE) -> tuple:
    """The fused kernel's launch: ``(blocks, tiles_per_lane)``.  Each lane's
    ``F`` flows are cut into ``tiles_per_lane`` tiles of ``tile`` flows
    (the last one short where ``tile`` does not divide ``F``); block ``i`` of
    ``blocks``, at most ``resident`` (the blocks the card keeps resident)
    and at most the number of tiles, walks the work items ``i, i + blocks,
    i + 2*blocks, ...`` of the ``B * tiles_per_lane``, lane-major."""
    if B < 1 or F < 1 or resident < 1:
        raise ValueError(f"fused plan needs B, F, resident >= 1, got {B}, "
                         f"{F}, {resident}")
    tiles = -(-F // tile)
    return min(resident, B * tiles), tiles


def plan_items(B: int, F: int, blocks: int, tiles_per_lane: int,
               tile: int = TILE) -> list:
    """The kernel's walk: for each block, its ``(lane, first flow, flows)``
    work items in order (``engine_step.cu``: ``item_tile``)."""
    items = B * tiles_per_lane
    walk = []
    for blk in range(blocks):
        mine = []
        for item in range(blk, items, blocks):
            b, t = divmod(item, tiles_per_lane)
            mine.append((b, t * tile, min(tile, F - t * tile)))
        walk.append(mine)
    return walk


_RESIDENT: dict = {}


def resident_blocks(policy_id: int, K: int) -> int:
    """How many blocks of the fused kernel for this policy and state
    width the current card keeps resident (SMs x blocks per SM)."""
    key = (torch.cuda.current_device(), policy_id, K)
    if key not in _RESIDENT:
        n = ctypes.c_int()
        err = kernel_function("fused_signals_policy_resident")(
            policy_id, K, ctypes.addressof(n))
        if err != 0:
            raise RuntimeError(f"fused_signals_policy: occupancy query "
                               f"failed with cudaError_t {err}")
        _RESIDENT[key] = n.value
    return _RESIDENT[key]


def rows_read(policy_id: int, K: int) -> int:
    """The float32 rows per flow a launch for this policy reads: the
    inputs its update reads and its K state rows (the kernel loads no
    other)."""
    rows = kernel_function("fused_signals_policy_rows")(policy_id, K)
    if rows < 0:
        raise ValueError(f"no fused kernel for policy id {policy_id}, K={K}")
    return rows


def launch_args(policy_id: int, ins, outs, t: float, t_base_util: float,
                dt: float) -> list:
    """The C entry point's arguments but the stream: ``ins`` the 8 hop,
    3 flat, state and params tensors, ``outs`` (state', rate, win), the
    launch plan (blocks, tiles per lane, 16-byte copies) at the end."""
    B, _, F = ins[0].shape
    K, P = ins[11].shape[1], ins[12].shape[1]
    blocks, tiles = fused_plan(B, F, resident_blocks(policy_id, K))
    vec = vector_copies(F, [x.data_ptr() for x in ins[:12]])
    return [policy_id, *(x.data_ptr() for x in ins), float(t),
            float(t_base_util), float(dt), B, F, K, P,
            *(o.data_ptr() for o in outs), blocks, tiles, int(vec)]


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
    outs = (torch.empty_like(state), torch.empty_like(line),
            torch.empty_like(line))
    _launch("fused_signals_policy",
            launch_args(pid, hop + flat + (state, params), outs, t,
                        t_base_util, dt))
    return outs


def scalar_fn(name: str, x):
    """The device scalar function ``name`` (a key of ``SCALAR_FNS``) of
    ``kernels/csrc/cc_policy.cuh`` elementwise over a float32 tensor; for
    a CPU tensor its plain version ``arith.<name>``.  A check entry point,
    not a kernel of the simulator's path: it is not counted in
    ``LAUNCHES``."""
    if not _on_cuda((x,)):
        return getattr(arith, name)(x)
    _check(x, "x", tuple(x.shape), torch.float32)
    y = torch.empty_like(x)
    err = kernel_function("scalar_fn")(
        SCALAR_FNS[name], x.data_ptr(), y.data_ptr(), x.numel(),
        torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"scalar_fn: CUDA launch failed with "
                           f"cudaError_t {err}")
    return y


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
