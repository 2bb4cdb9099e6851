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
The segment kernels take every non-empty reduction plan of the engine
(``engine._reduce_plan``) in one launch: a "gather" plan as its padded
``(n_out, C)`` member matrix, a split-row "gather2" plan as ``perm``
(blocks of 64 members), ``boff`` (each segment's first block) and the
CTA table ``split_ctas`` (consecutive segments packed into CTAs of about
equal members), with a second level of at most ``MAX_C2`` blocks; lanes
may be strided.
``scalar_fn`` runs the policies' scalar device functions (exp, tanh, the
logistic, the flush of a multiply-add's result) elementwise, so that a
check can hold each against its plain version in ``core/arith.py`` over
every float32 input.
"""
from __future__ import annotations

import ctypes
import threading

import numpy as np
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
_COUNT_LOCK = threading.Lock()

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

# the segment kernels' widest second level, in blocks of a split-row
# segment (engine_step.cu: MAX_C2): segments of up to 262,144 members
MAX_C2 = 4096
# members a split-row block (engine._SPLIT_C; engine_step.cu: SPLIT_W)
SPLIT_W = 64

# the device scalar functions scalar_fn evaluates, by index
# (engine_step.cu: scalar_fn_kernel), each named as its plain version
SCALAR_FNS = {"expf": 0, "tanhf": 1, "sigmoidf": 2, "ftz": 3}

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_int64
_SIGNATURES = {
    "fused_signals_policy": [_I] + [_P] * 13 + [_F, _F, _F] + [_I] * 4
                            + [_P] * 3 + [_I] * 3 + [_P],
    "fused_signals_policy_resident": [_I, _I, _P],
    "fused_signals_policy_rows": [_I, _I],
    "scalar_fn": [_I, _P, _P, ctypes.c_long, _P],
    "segment_reduce": [_P, _L, _L, _P, _P, _P] + [_I] * 6 + [_P, _P],
    "segment_reduce_pfc": [_P, _L, _L, _P, _P, _P] + [_I] * 6 + [_P] * 7,
    "segment_split_chunk": [_I],
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
    with _COUNT_LOCK:           # a mesh runs distinct devices in threads
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


def split_chunk(C2: int) -> int:
    """The blocks a split-row CTA of the segment kernels gathers at once
    for second-level width ``C2``: 256 threads (32 blocks) up to C2 = 32,
    1,024 (128 blocks) above, 8 members a thread (engine_step.cu:
    split_chunk)."""
    return (256 if C2 <= 32 else 1024) * 8 // SPLIT_W


def split_ctas(boff, C2: int, chunk: int | None = None) -> np.ndarray:
    """The CTAs of a split-row plan (block offsets ``boff``, ``n_out + 1``):
    CTA ``i`` takes segments ``ctas[i]`` to ``ctas[i+1] - 1``, consecutive
    segments whose blocks together fit ``chunk`` (by default
    ``split_chunk(C2)``), or one wider segment alone, so that CTAs gather
    about as many members each."""
    boff = np.asarray(boff, np.int64)
    nblk = np.diff(boff)
    cap = split_chunk(C2) if chunk is None else chunk
    starts, held = [0], 0
    for s, n in enumerate(nblk):
        if s > starts[-1] and held + n > cap:
            starts.append(s)
            held = 0
        held += n
    return np.asarray(starts + [len(nblk)], np.int32)


def _check_seg(vals, idx, n_out: int, C: int, boff, C2: int, ctas=None):
    """The wrappers' checks of a plan; returns ``(B, n_in)``."""
    if vals.dim() != 2:
        raise ValueError(f"vals must be (B, n_in), got {tuple(vals.shape)}")
    if vals.dtype != torch.float32:
        raise TypeError(f"vals: expected torch.float32, got {vals.dtype}")
    if vals.stride(1) < 1 or vals.stride(0) < 0:
        raise ValueError(f"vals: strides {vals.stride()} are not a lane "
                         "and an element stride")
    if not 1 <= C <= 64 or C & (C - 1):
        raise ValueError(f"block width C={C} is not a power of two in "
                         "1..64")
    if not 1 <= C2 <= MAX_C2 or C2 & (C2 - 1):
        raise ValueError(f"second-level width C2={C2} is not a power of two "
                         f"in 1..{MAX_C2} (the segment kernels' limit)")
    B, n_in = vals.shape
    if B > 65535:
        raise ValueError(f"{B} lanes: the segment kernels take at most 65535")
    if boff is None:
        if C2 != 1:
            raise ValueError("a gather plan (no boff) has C2 = 1")
        _check(idx, "idx", (n_out * C,), torch.int32)
        return B, n_in
    if C != SPLIT_W:
        raise ValueError(f"a split-row plan has blocks of {SPLIT_W}, got "
                         f"C={C}")
    _check(boff, "boff", (n_out + 1,), torch.int32)
    if idx.dim() != 1 or idx.shape[0] % C:
        raise ValueError(f"perm: expected whole blocks of {C}, got shape "
                         f"{tuple(idx.shape)}")
    _check(idx, "perm", tuple(idx.shape), torch.int32)
    if ctas is None or ctas.dim() != 1 or not 2 <= ctas.shape[0] <= n_out + 1:
        raise ValueError("a split-row plan needs its CTA table "
                         "(split_ctas), 2 to n_out + 1 entries")
    _check(ctas, "ctas", tuple(ctas.shape), torch.int32)
    return B, n_in


def segment_args(vals, idx, boff, n_out: int, C: int, C2: int,
                 ctas=None) -> list:
    """The segment entry points' arguments up to the plan's widths: the
    outputs (and the PFC variant's per-segment inputs) and the stream
    follow."""
    B, n_in = vals.shape
    return [vals.data_ptr(), vals.stride(0), vals.stride(1), idx.data_ptr(),
            None if boff is None else boff.data_ptr(),
            None if ctas is None else ctas.data_ptr(),
            0 if ctas is None else ctas.shape[0] - 1, B, n_in, n_out, C, C2]


def segment_reduce(vals, idx, n_out: int, C: int, boff=None, C2: int = 1,
                   ctas=None):
    """The sums of a reduction plan (``engine._reduce_plan``) for B lanes:
    ``out[b, s]`` the sum of segment ``s``'s members of ``vals[b]``, in
    the reference's order; ``vals (B, n_in)`` float32, any lane and
    element strides.  Two layouts, each one launch:

      gather     ``idx`` the plan's flat ``(n_out*C,)`` int32 matrix,
                 ``n_in`` as the "+0" slot; ``boff``, ``ctas`` None,
                 ``C2`` 1;
      gather2    ``idx`` the int32 ``perm``, blocks of ``C`` = 64
                 members, ``boff`` the ``(n_out+1,)`` int32 first block
                 of each segment, ``C2`` the plan's second-level width
                 (at most ``MAX_C2``), ``ctas`` the int32 CTA table
                 (``split_ctas``).

    Returns ``(B, n_out)`` float32."""
    plan = [x for x in (idx, boff, ctas) if x is not None]
    if not _on_cuda([vals] + plan):
        return ref.segment_reduce_ref(vals, idx, n_out, C, boff, C2)
    B, _ = _check_seg(vals, idx, n_out, C, boff, C2, ctas)
    out = torch.empty((B, n_out), dtype=torch.float32, device=vals.device)
    _launch("segment_reduce",
            segment_args(vals, idx, boff, n_out, C, C2, ctas)
            + [out.data_ptr()])
    return out


def segment_reduce_pfc(vals, idx, n_out: int, C: int, xoff, xon, can_pause,
                       prev_paused, boff=None, C2: int = 1, ctas=None):
    """Per-ingress-port occupancy (``segment_reduce``, either layout) + PFC
    hysteresis for B lanes: ``xoff``, ``xon`` float32 and ``can_pause``,
    ``prev_paused`` bool, all ``(B, n_out)``.  Returns ``(q (B, n_out)
    float32, paused (B, n_out) bool)``."""
    per_seg = (xoff, xon, can_pause, prev_paused)
    plan = [x for x in (idx, boff, ctas) if x is not None]
    if not _on_cuda([vals] + plan + list(per_seg)):
        return ref.segment_reduce_pfc_ref(vals, idx, n_out, C, *per_seg,
                                          boff, C2)
    B, _ = _check_seg(vals, idx, n_out, C, boff, C2, ctas)
    _check(xoff, "xoff", (B, n_out), torch.float32)
    _check(xon, "xon", (B, n_out), torch.float32)
    _check(can_pause, "can_pause", (B, n_out), torch.bool)
    _check(prev_paused, "prev_paused", (B, n_out), torch.bool)
    q = torch.empty((B, n_out), dtype=torch.float32, device=vals.device)
    paused = torch.empty((B, n_out), dtype=torch.bool, device=vals.device)
    _launch("segment_reduce_pfc",
            segment_args(vals, idx, boff, n_out, C, C2, ctas)
            + [xoff.data_ptr(), xon.data_ptr(), can_pause.data_ptr(),
               prev_paused.data_ptr(), q.data_ptr(), paused.data_ptr()])
    return q, paused
