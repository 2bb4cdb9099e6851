"""Plain PyTorch versions of the engine-step kernels.

``fused_step_ref``, ``segment_reduce_ref`` and ``segment_reduce_pfc_ref``
port the reference's ``repro/kernels/engine_step/ref.py`` line for line
(flat ``(F, MAXHOP)``/``(F,)`` arrays and dict state).
``fused_signals_policy_ref`` is the plain version of the CUDA kernel in the
kernel's own layout (hop-major ``(B, H, F)``, packed ``(B, K, F)`` state,
``(B, P)`` params); the wrappers in ``ops.py`` call these for CPU tensors,
and ``chip_smoke.py`` holds each kernel against them on the card.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import cc as cc_mod
from repro_torch.core.cc import Signals
from repro_torch.core.arith import row_prod, row_sum


def fused_step_ref(policy, *, q_d, tx_d, caps, ecn_mask, hopmask,
                   kmin_h, kmax_h, pmax_h, base_rtt, line, loss,
                   state: dict, params: dict | None, t, dt: float,
                   t_base_util: float):
    """Engine stages 1-2 on flat arrays: returns ``(state', rate, win)``."""
    hopmask = hopmask.to(torch.bool)
    rtt = base_rtt + row_sum(q_d / caps * hopmask)
    mark = torch.clamp((q_d - kmin_h) / torch.clamp_min(kmax_h - kmin_h, 1.0),
                       0.0, 1.0) * pmax_h
    mark = mark * ecn_mask
    ecn = 1.0 - row_prod(1.0 - mark)
    util_l = tx_d / caps + q_d / (caps * t_base_util)
    util = torch.amax(torch.where(hopmask, util_l, 0.0), dim=1)
    sig = Signals(ecn=ecn, rtt=rtt, util=util, t=float(np.float32(t)),
                  dt=float(np.float32(dt)), line=line, base_rtt=base_rtt,
                  loss=loss)
    st2, rate, win = policy.update(dict(policy.params, **(params or {})),
                                   state, sig)
    F = line.shape[0]
    return st2, rate.expand(F), win.expand(F)


def fused_signals_policy_ref(policy, q_d, tx_d, caps, ecn_mask, hopmask,
                             kmin_h, kmax_h, pmax_h, base_rtt, line, loss,
                             state, params, t: float, t_base_util: float,
                             dt: float):
    """The fused kernel's function in its layout: hop inputs ``(B, H, F)``,
    flat inputs ``(B, F)``, ``state (B, K, F)`` in ``kernel_state_keys``
    order, ``params (B, P)`` in ``kernel_param_keys`` order.  Returns
    ``(state' (B, K, F), rate (B, F), win (B, F))``."""
    keys = cc_mod.kernel_state_keys(policy)
    pkeys = cc_mod.kernel_param_keys(policy)
    B, _, F = q_d.shape
    st_out, rates, wins = [], [], []
    for b in range(B):
        hop = [x[b].T for x in (q_d, tx_d, caps, ecn_mask, hopmask, kmin_h,
                                kmax_h, pmax_h)]
        st = {k: state[b, j] for j, k in enumerate(keys)}
        par = dict(zip(pkeys, params[b].tolist())) if pkeys else {}
        st2, rate, win = fused_step_ref(
            policy, q_d=hop[0], tx_d=hop[1], caps=hop[2], ecn_mask=hop[3],
            hopmask=hop[4], kmin_h=hop[5], kmax_h=hop[6], pmax_h=hop[7],
            base_rtt=base_rtt[b], line=line[b], loss=loss[b], state=st,
            params=par, t=t, dt=dt, t_base_util=t_base_util)
        st_out.append(cc_mod.pack_state(policy, st2, n_flows=F,
                                        device=line.device))
        rates.append(rate)
        wins.append(win)
    return torch.stack(st_out), torch.stack(rates), torch.stack(wins)


def segment_reduce_ref(vals, idx, n_out: int, C: int, boff=None,
                       C2: int = 1, ctas=None):
    """``engine._reduce``'s sums of a reduction plan, ``vals`` ``(n_in,)``
    or ``(B, n_in)``; an index ``>= n_in`` reads 0.  ``boff`` None: the
    "gather" plan, ``idx`` its flat ``(n_out*C,)`` matrix, ``out[..., s] =
    row_sum(vals[..., idx[s*C:(s+1)*C]])``.  Else the split-row
    ("gather2") plan in the kernels' layout: ``idx`` is ``perm``, blocks of
    ``C`` (64) members; segment ``s`` is blocks ``boff[s]`` to ``boff[s+1]
    - 1``, whose block sums are added as a row of ``C2`` padded with zeros
    (``row_sum(lanes=True)``), as ``_reduce`` adds them through ``bidx``.
    ``ctas``, the kernels' CTA table, does not change the sums."""
    lead = vals.shape[:-1]
    n_in = vals.shape[-1]
    rows = _zero_ext(vals)[..., torch.clamp_max(idx.long(), n_in)]
    if boff is None:
        return row_sum(rows.reshape(lead + (n_out, C)))
    n_blocks = idx.shape[0] // C
    bsum = row_sum(rows.reshape(lead + (n_blocks, C)))
    return row_sum(_zero_ext(bsum)[..., block_rows(boff, C2, n_blocks)]
                   .reshape(lead + (n_out, C2)), lanes=True)


def block_rows(boff, C2: int, n_blocks: int):
    """The split-row plan's padded second level from block offsets: the
    flat ``(n_out*C2,)`` ``bidx`` of ``engine._reduce_plan``, segment
    ``s``'s blocks ``boff[s] + k`` for ``k`` below its count, then
    ``n_blocks`` (the "+0" slot)."""
    boff = boff.long()
    k = torch.arange(C2, device=boff.device)
    start = boff[:-1, None]
    return torch.where(k < boff[1:, None] - start, start + k,
                       n_blocks).reshape(-1)


def _zero_ext(vals):
    return torch.cat([vals, vals.new_zeros(vals.shape[:-1] + (1,))], dim=-1)


def segment_reduce_pfc_ref(vals, idx, n_out: int, C: int, xoff, xon,
                           can_pause, prev_paused, boff=None, C2: int = 1,
                           ctas=None):
    """A plan's reduction (``segment_reduce_ref``) + the engine's PFC
    hysteresis (stages 6-7)."""
    q = segment_reduce_ref(vals, idx, n_out, C, boff, C2)
    over = (q > xoff) & can_pause.to(torch.bool)
    under = q < xon
    paused = torch.where(over, True,
                         torch.where(under, False, prev_paused.to(torch.bool)))
    return q, paused
