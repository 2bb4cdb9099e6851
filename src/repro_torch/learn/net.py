"""The learned CC policy ``mlp``: a tiny per-flow MLP in PyTorch (port of
``repro.learn.net``, operation for operation).

One hidden layer of ``HIDDEN`` tanh units over ``N_FEATURES`` normalized
feedback/context features, two heads computing bounded rate and window
*targets* that the per-flow state tracks at RTT timescale.  The weights
are flat scalar ``ParamSpec`` entries (``w1_{j}{i}``, ``b1_{j}``,
``w2_{o}{j}``, ``b2_{o}``), so they ride the engine's per-lane params
like any policy's; the state is a dict of four (F,) float32 tensors
(``bdp``, ``fanin``, ``rate``, ``win``), so the policy runs in the fused
CUDA step kernel (``policy_update<MLP>`` in
``kernels/csrc/cc_policy.cuh``, ``cc.KERNEL_POLICY_ID["mlp"]``).  Its
loss reaction is a structural multiplicative cut outside the net
(``loss_cut``), skipped on a lossless fabric.

Features: ECN mark fraction, squashed queueing-delay ratio, squashed INT
utilisation, rate / line, squashed window / BDP, 1 / fan-in.  The window
target is parametrized around the static-window prior and the rate
target around the line rate, so zero weights recover the static window.

``default_weights()`` reads the trained weights from this package's
``mlp_weights.json`` (a copy of the reference's file); a seeded init is
used only when the file is absent.  ``repro_torch.learn.train`` trains
the weights through the simulator's op path.

Arithmetic follows the reference's compiled step: ``tanh`` and the
logistic are ``arith.tanhf``/``arith.sigmoidf``, and the multiply-adds
its CPU backend contracts inside the engine step are explicit ``fma``
calls (the dot products fuse each product into the running sum, the
first into the second product; the tracking updates fuse ``a * d``).
"""
from __future__ import annotations

import json
import os

import numpy as np
import torch

from repro_torch.core.arith import expf, fma, rdiv, sigmoidf, tanhf
from repro_torch.core.cc import (KERNEL_POLICY_ID, FlowCtx, ParamSpec,
                                 Policy, Signals, _clip, _f32, _lossy, _max,
                                 _min)

N_FEATURES = 6
HIDDEN = 4

_RATE_BIAS = 4.0     # sigmoid(bias) = 0.982: zero weights -> rate ~ line
_WIN_SPAN = 2.5      # win target within e^+-2.5 of the static-window prior

_WEIGHT_BOUND = 8.0


def _weight_names() -> tuple:
    names = []
    for j in range(HIDDEN):
        names += [f"w1_{j}{i}" for i in range(N_FEATURES)] + [f"b1_{j}"]
    for o in range(2):
        names += [f"w2_{o}{j}" for j in range(HIDDEN)] + [f"b2_{o}"]
    return tuple(names)


WEIGHT_KEYS = _weight_names()

_WEIGHTS_PATH = os.path.join(os.path.dirname(__file__), "mlp_weights.json")
_DEFAULT_CACHE: dict = {}


def init_weights(seed: int = 0) -> dict:
    """Seeded small-Gaussian training init, biased so both heads bind
    (rate target ~ 0.08 line, window target ~ 0.15x the prior)."""
    rng = np.random.default_rng(seed)
    out = {}
    for k in WEIGHT_KEYS:
        out[k] = 0.0 if k.startswith("b") else float(rng.normal(0.0, 0.2))
    out["b2_0"] = -(_RATE_BIAS + 2.5)
    out["b2_1"] = -1.0
    return out


def default_weights() -> dict:
    """The committed trained weights (fallback: seeded init)."""
    if "w" not in _DEFAULT_CACHE:
        if os.path.exists(_WEIGHTS_PATH):
            with open(_WEIGHTS_PATH) as f:
                w = {k: float(v) for k, v in json.load(f)["weights"].items()}
            missing = set(WEIGHT_KEYS) - set(w)
            if missing:
                raise ValueError(f"mlp_weights.json is missing "
                                 f"{sorted(missing)}")
        else:
            w = init_weights(0)
        _DEFAULT_CACHE["w"] = w
    return dict(_DEFAULT_CACHE["w"])


def _dot(p: dict, keys, xs):
    """``sum(p[k] * x)`` as the reference's compiled step adds it: the
    first product fused into the second, every later one into the
    running sum."""
    w = [_f32(p[k]) for k in keys]
    acc = fma(w[0], xs[0], w[1] * xs[1])
    for wk, x in zip(w[2:], xs[2:]):
        acc = fma(wk, x, acc)
    return acc


def make_mlp(weights: dict | None = None, out_gain: float = 1.0,
             loss_cut: float = 1.0) -> Policy:
    """The learned policy.  ``weights=None`` loads the committed trained
    weights; a dict bakes others in as the spec defaults.  ``out_gain``
    scales the target-tracking speed (0 freezes the state at its init);
    ``loss_cut`` scales the structural lossy-RoCE cut."""
    w = default_weights() if weights is None else dict(weights)
    unknown = set(w) - set(WEIGHT_KEYS)
    if unknown or set(WEIGHT_KEYS) - set(w):
        raise ValueError(f"weights must cover exactly {len(WEIGHT_KEYS)} keys"
                         f" (unknown: {sorted(unknown)})")
    spec = {"out_gain": ParamSpec(float(out_gain), lo=0.0, hi=4.0,
                                  scale="linear"),
            "loss_cut": ParamSpec(float(loss_cut), lo=0.0, hi=4.0,
                                  scale="linear")}
    for k in WEIGHT_KEYS:
        spec[k] = ParamSpec(float(np.clip(w[k], -_WEIGHT_BOUND,
                                          _WEIGHT_BOUND)),
                            lo=-_WEIGHT_BOUND, hi=_WEIGHT_BOUND,
                            scale="linear")

    def init(ctx: FlowCtx):
        f = _max(ctx.fanin, 1.0)
        win0 = _max(2.0 * ctx.bdp / f + rdiv(0.5e6, f), 4000.0)
        return {"rate": ctx.line * 1.0, "win": win0,
                "bdp": ctx.bdp * 1.0, "fanin": f}

    def update(p, st, sig: Signals):
        line = _max(sig.line, 1.0)
        base = _max(sig.base_rtt, 1e-7)
        bdp = _max(st["bdp"], 1.0)
        qdel = _max(sig.rtt - sig.base_rtt, 0.0)
        qd = qdel / base
        u = _max(sig.util, 0.0)
        fan = _max(st["fanin"], 1.0)
        # the reference's compiler rewrites (q / b) / (1 + qd) as
        # q / (b * (1 + qd))
        x = (sig.ecn,
             qdel / (base * (1.0 + qd)),
             u / (1.0 + u),
             st["rate"] / line,
             st["win"] / fma(4.0, bdp, st["win"]),
             rdiv(1.0, fan))
        h = [tanhf(_dot(p, [f"w1_{j}{i}" for i in range(N_FEATURES)], x)
                   + _f32(p[f"b1_{j}"]))
             for j in range(HIDDEN)]
        sr = _dot(p, [f"w2_0{j}" for j in range(HIDDEN)], h) \
            + _f32(p["b2_0"])
        sw = _dot(p, [f"w2_1{j}" for j in range(HIDDEN)], h) \
            + _f32(p["b2_1"])
        win_prior = _max(2.0 * bdp / fan + rdiv(0.5e6, fan), 4000.0)
        gain_dt = _f32(_f32(p["out_gain"]) * sig.dt)
        a = _clip(rdiv(gain_dt, _max(base, sig.dt)), 0.0, 1.0)
        # exponential tracking of the bounded targets; the target's own
        # product fuses into the difference (line * sig - rate, one FMA)
        rate = fma(a, fma(line, sigmoidf(sr + _RATE_BIAS), -st["rate"]),
                   st["rate"])
        rate = torch.minimum(torch.maximum(rate, 1e-3 * line), line)
        win = fma(a, fma(win_prior, expf(_WIN_SPAN * tanhf(sw)),
                         -st["win"]), st["win"])
        win = _min(_max(win, 1000.0), 32.0 * bdp)
        if _lossy(sig):
            # structural cut, monotone in loss for any weights; loss == 0
            # flows keep their values bit for bit
            cut = fma(-0.5, _min(_f32(2.0 * p["loss_cut"]) * sig.loss, 1.0),
                      1.0)
            rate = torch.where(sig.loss > 0,
                               torch.maximum(rate * cut, 1e-3 * line), rate)
            win = torch.where(sig.loss > 0,
                              _max(win * cut, 1000.0), win)
        st2 = {"rate": rate, "win": win, "bdp": st["bdp"],
               "fanin": st["fanin"]}
        return st2, rate, win

    return Policy("mlp", spec, init, update, kind="mixed", loss_aware=True,
                  kernel_id=KERNEL_POLICY_ID["mlp"])
