"""Plain PyTorch version of the DCQCN update kernel: the port's
``make_dcqcn`` policy update on flat per-flow state, with no loss signal.

The reference's Pallas body (``repro/kernels/cc_update/cc_update.py``)
writes the multiply-adds unfused and agrees with the policy only to rtol
1e-5; the port's kernel computes the policy's update, so this is its
plain version and the two agree bit for bit.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.cc import Signals, make_dcqcn

ORDER = ("rc", "rt", "alpha", "t_cut", "t_inc", "t_alpha", "inc_count",
         "jit")


def dcqcn_params(params: dict | None) -> dict:
    """The nine DCQCN parameters (defaults overridden by ``params``) as
    float32 values; unknown names raise."""
    pol = make_dcqcn()
    params = dict(params or {})
    pol.check_tunable(params)
    return {k: float(np.float32(v)) for k, v in
            dict(pol.params, **params).items()}


def dcqcn_update_ref(state: dict, ecn: torch.Tensor, line: torch.Tensor, t,
                     params: dict | None) -> dict:
    """``state``: dict of (F,) float32 in the ``make_dcqcn`` layout; returns
    the updated dict (``jit`` passes through)."""
    zeros = torch.zeros_like(ecn)
    sig = Signals(ecn=ecn, rtt=zeros, util=zeros, t=float(np.float32(t)),
                  dt=float(np.float32(1e-6)), line=line, base_rtt=zeros)
    st2, _, _ = make_dcqcn().update(dcqcn_params(params),
                                    {k: state[k] for k in ORDER}, sig)
    new = {k: st2[k] for k in ORDER[:7]}
    new["jit"] = state["jit"]
    return new
