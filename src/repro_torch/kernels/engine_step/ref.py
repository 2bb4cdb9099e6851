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


def segment_reduce_ref(vals, idx, n_out: int, C: int):
    """``engine._reduce``'s "gather" strategy: ``out[..., s] =
    sum(vals[..., idx[s*C:(s+1)*C]])`` where an index ``>= n_in`` reads 0.
    ``vals`` is ``(n_in,)`` or ``(B, n_in)``; ``idx`` the plan's flat
    ``(n_out*C,)`` matrix."""
    n_in = vals.shape[-1]
    ext = torch.cat([vals, vals.new_zeros(vals.shape[:-1] + (1,))], dim=-1)
    rows = ext[..., torch.clamp_max(idx.long(), n_in)]
    return row_sum(rows.reshape(vals.shape[:-1] + (n_out, C)))


def segment_reduce_pfc_ref(vals, idx, n_out: int, C: int, xoff, xon,
                           can_pause, prev_paused):
    """Gather reduction + the engine's PFC hysteresis (stages 6-7)."""
    q = segment_reduce_ref(vals, idx, n_out, C)
    over = (q > xoff) & can_pause.to(torch.bool)
    under = q < xon
    paused = torch.where(over, True,
                         torch.where(under, False, prev_paused.to(torch.bool)))
    return q, paused
