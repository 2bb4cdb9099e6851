"""Float32 arithmetic in the reference's order of operations.

The fluid simulator amplifies an ulp of difference into a different
pause, cut or completion step, so the port follows the reference's
rounding where its CPU backend (XLA through LLVM) departs from PyTorch's:
multiply-adds contracted into one FMA, and row sums in a fixed
association order.  The CUDA kernels do the same (``fmaf``, the same sum
order), so the kernel path, the op path and the reference agree to the
bit wherever the elementary functions agree.

Gradients: ``expf``, ``tanhf``, ``sigmoidf`` and ``ftz`` emulate the
reference's compiled values, but the reference differentiates the
functions themselves (``jnp.exp``, ``jnp.tanh``, ``jax.nn.sigmoid``), not
their expansions, and its subnormal flush is a property of the hardware,
not an operation it differentiates.  So on a tensor that requires grad
each of the four is an ``autograd.Function``: the forward is the
emulation, bit for bit, and the backward is JAX's rule (``g*out``,
``(g + g*out)*(1 - out)``, ``g*(out*(1 - out))``) or, for the flush,
``g`` itself.  ``fma`` keeps the gradient of ``a*b + c``.
"""
from __future__ import annotations

import torch

_FLT_MIN = float.fromhex("0x1p-126")     # smallest normal float32


def _with_grad(fn, grad):
    """``fn`` whose backward is ``grad(g, out)`` where its input requires
    grad; elsewhere ``fn`` itself, so the forward-only path runs the same
    operations as before."""
    class Fn(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x):
            out = fn(x)
            ctx.save_for_backward(out)
            return out

        @staticmethod
        def backward(ctx, g):
            out, = ctx.saved_tensors
            return grad(g, out)

    def call(x: torch.Tensor) -> torch.Tensor:
        if x.requires_grad and torch.is_grad_enabled():
            return Fn.apply(x)
        return fn(x)

    Fn.__name__ = Fn.__qualname__ = fn.__name__.strip("_") + "_backward"
    call.__name__, call.__doc__ = fn.__name__.strip("_"), fn.__doc__
    return call


def _grad_wanted(*xs) -> bool:
    return torch.is_grad_enabled() and any(
        isinstance(x, torch.Tensor) and x.requires_grad for x in xs)


def _to_size(g: torch.Tensor, x) -> torch.Tensor:
    """A broadcast gradient summed back to ``x``'s shape."""
    return g.sum_to_size(x.shape) if g.shape != x.shape else g


class _FmaBackward(torch.autograd.Function):
    """``fma`` as one autograd node: the emulation forward, the gradient
    of ``a*b + c`` backward (one node instead of the emulation's five)."""

    @staticmethod
    def forward(ctx, a, b, c):
        ctx.save_for_backward(*(x if isinstance(x, torch.Tensor) else None
                                for x in (a, b, c)))
        ctx.scalars = tuple(None if isinstance(x, torch.Tensor) else x
                            for x in (a, b))
        return _fma(a, b, c)

    @staticmethod
    def backward(ctx, g):
        a, b, c = ctx.saved_tensors
        sa, sb = ctx.scalars
        need = ctx.needs_input_grad
        ga = _to_size(g * (b if b is not None else sb), a) if need[0] \
            else None
        gb = _to_size(g * (a if a is not None else sa), b) if need[1] \
            else None
        gc = _to_size(g, c) if need[2] else None
        return ga, gb, gc


def fma(a, b, c):
    """``a * b + c`` rounded once, like a fused multiply-add.

    The reference's CPU backend (XLA through LLVM) contracts a multiply
    that feeds an add or subtract into one FMA; where two products meet
    (``x*y + u*v``) it fuses the first.  The port's op path does the same
    at the same places, so its float32 results follow the reference's
    rather than drifting by an ulp per step; the CUDA kernel calls
    ``fmaf`` there.  Emulated in float64: the product of two float32
    values is exact in float64, and the sum is rounded twice (to float64,
    then float32), which differs from one rounding only in rare
    half-way cases.  Scalars must already be float32 values."""
    if _grad_wanted(a, b, c):
        return _FmaBackward.apply(a, b, c)
    return _fma(a, b, c)


def _fma(a, b, c):
    # one operand in float64 promotes the others within the operation
    if isinstance(a, torch.Tensor):
        prod = a.double() * b
    else:
        prod = a * b.double()
    return _ftz((prod + c).float())


def _ftz(x: torch.Tensor) -> torch.Tensor:
    """Flush float32 subnormals to (signed) zero, as the reference's CPU
    backend does: the residue ``b - b*frac`` of a drained backlog decays
    through the subnormal range there as exact zeros.  Straight-through
    under autograd."""
    return x * (x.abs() >= _FLT_MIN)


ftz = _with_grad(_ftz, lambda g, out: g)


def rdiv(s, x: torch.Tensor) -> torch.Tensor:
    """``s / x`` for a scalar ``s`` (or a per-lane column), rounded once:
    PyTorch evaluates a scalar numerator as ``x.reciprocal() * s``, which
    rounds twice."""
    if isinstance(s, torch.Tensor):
        return s / x
    return torch.full_like(x, s) / x


def sdiv(x: torch.Tensor, s) -> torch.Tensor:
    """``x / s`` for a scalar ``s`` (or a per-lane column), rounded once:
    on CUDA, PyTorch evaluates a Python-scalar divisor as ``x * (1/s)``,
    which rounds twice (on the CPU it divides), so the divisor goes to
    the device as a 0-dim tensor there."""
    if isinstance(s, torch.Tensor) or x.device.type == "cpu":
        return x / s
    return x / torch.full((), s, dtype=x.dtype, device=x.device)


def _seq(cols):
    out = cols[0]
    for c in cols[1:]:
        out = out + c
    return out


class _RowSumBackward(torch.autograd.Function):
    """``row_sum`` as one autograd node (its gradient is ``g`` broadcast
    over the row, however the forward associates the additions)."""

    @staticmethod
    def forward(ctx, rows, lanes):
        ctx.shape = rows.shape
        return _row_sum(rows, lanes)

    @staticmethod
    def backward(ctx, g):
        return g.unsqueeze(-1).expand(ctx.shape), None


def row_sum(rows: torch.Tensor, lanes: bool = False) -> torch.Tensor:
    """Sum over the last axis (a power-of-two width C) in the order the
    reference's compiled gather-and-sum reductions use on the CPU:

      C <= 16   left to right (``lanes=False``: a gather plan's rows and
                the hop slots), or as below (``lanes=True``: the second
                level of a split-row ``gather2`` plan);
      C <= 32   min(C, 8) strided partial sums (column k adds k, k+8, ...
                left to right), then a halving tree over them;
      C >= 64   each block of 32 left to right, then the block totals
                left to right.

    (Measured from the reference's compiled code, bit for bit.)  The port
    adds in the same order, and so do the segment kernels, so a segment
    sum is the reference's to the bit; PyTorch's own ``sum`` reorders, and
    the simulator amplifies an ulp of difference into a different pause
    or cut step."""
    if _grad_wanted(rows):
        return _RowSumBackward.apply(rows, lanes)
    return _row_sum(rows, lanes)


def _row_sum(rows: torch.Tensor, lanes: bool) -> torch.Tensor:
    C = rows.shape[-1]
    if C <= 16 and not lanes:
        return _seq([rows[..., k] for k in range(C)])
    if C <= 32:
        V = min(C, 8)
        acc = _seq([rows[..., V * j:V * j + V] for j in range(C // V)])
        while acc.shape[-1] > 1:
            h = acc.shape[-1] // 2
            acc = acc[..., :h] + acc[..., h:]
        return acc[..., 0]
    blocks = rows.reshape(rows.shape[:-1] + (C // 32, 32))
    totals = _seq([blocks[..., k] for k in range(32)])
    return _seq([totals[..., b] for b in range(C // 32)])


def row_prod(x: torch.Tensor) -> torch.Tensor:
    """Product over a short last axis (the hop slots), left to right."""
    out = x[..., 0]
    for k in range(1, x.shape[-1]):
        out = out * x[..., k]
    return out


# Cephes single-precision expf, the polynomial the reference's CPU backend
# evaluates for exp (with its multiply-adds contracted and results below
# the smallest normal float flushed to zero).  Written out so that DCQCN's
# p_cnp = 1 - exp(-pkts * ecn) is the reference's to the bit, on the CPU
# and in the CUDA kernels (kernels/csrc/cc_policy.cuh: cephes_expf) alike.
_EXP_LO = float.fromhex("-0x1.5f33340000000p+6")     # -87.8
_EXP_HI = float.fromhex("0x1.6333340000000p+6")      # 88.8
_LOG2E = float.fromhex("0x1.7154760000000p+0")
_LN2_HI = float.fromhex("0x1.6300000000000p-1")      # 0.693359375
_LN2_LO = float.fromhex("-0x1.bd01060000000p-13")
_EXP_P = tuple(float.fromhex(h) for h in (
    "0x1.a0d2ce0000000p-13", "0x1.6e879c0000000p-10", "0x1.1112100000000p-7",
    "0x1.5553820000000p-5", "0x1.5555540000000p-3"))


def _expf(x: torch.Tensor) -> torch.Tensor:
    """``exp`` of a float32 tensor, Cephes' range reduction and degree-7
    polynomial (NaN propagates); gradient ``g*out``."""
    x = torch.where(x < _EXP_LO, _EXP_LO, x)
    x = torch.where(x > _EXP_HI, _EXP_HI, x)
    n = torch.floor(fma(x, _LOG2E, 0.5))
    n = torch.where(n < -127.0, -127.0, n)
    n = torch.where(n > 127.0, 127.0, n)
    r = fma(-_LN2_HI, n, x)
    r = fma(-_LN2_LO, n, r)
    p = fma(r, _EXP_P[0], _EXP_P[1])
    for c in _EXP_P[2:] + (0.5,):
        p = fma(p, r, c)
    y = 1.0 + fma(p, r * r, r)
    scale = ((torch.nan_to_num(n).to(torch.int32) + 127) << 23).view(
        torch.float32)
    out = y * scale
    return torch.where(out < _FLT_MIN, 0.0, out)


expf = _with_grad(_expf, lambda g, out: g * out)


# tanh as the reference's CPU backend expands it (XLA's elemental tanh): a
# rational approximation x * P(x^2) / Q(x^2) on x clamped to +-_TANH_MAX,
# every Horner step one multiply-add, and x itself where |x| < 0.0004.
# The learned policy's hidden layer and window head go through it;
# kernels/csrc/cc_policy.cuh (xla_tanhf) computes the same bits.
_TANH_MAX = 7.99881172180175781
_TANH_SMALL = 0.0004
_TANH_P = tuple(float(v) for v in __import__("numpy").float32([
    -2.76076847742355e-16, 2.00018790482477e-13, -8.60467152213735e-11,
    5.12229709037114e-08, 1.48572235717979e-05, 6.37261928875436e-04,
    4.89352455891786e-03]))
_TANH_Q = tuple(float(v) for v in __import__("numpy").float32([
    1.19825839466702e-06, 1.18534705686654e-04, 2.26843463243900e-03,
    4.89352518554385e-03]))


def _tanhf(x: torch.Tensor) -> torch.Tensor:
    """``tanh`` of a float32 tensor, bit for bit the reference's (NaN
    propagates); gradient ``(g + g*out)*(1 - out)``."""
    y = torch.clamp(x, -_TANH_MAX, _TANH_MAX)
    y2 = y * y
    p = fma(y2, _TANH_P[0], _TANH_P[1])
    for c in _TANH_P[2:]:
        p = fma(y2, p, c)
    q = fma(y2, _TANH_Q[0], _TANH_Q[1])
    for c in _TANH_Q[2:]:
        q = fma(y2, q, c)
    return torch.where(x.abs() < _TANH_SMALL, x, y * p / q)


tanhf = _with_grad(_tanhf, lambda g, out: (g + g * out) * (1.0 - out))


def _sigmoidf(x: torch.Tensor) -> torch.Tensor:
    """The logistic function as the reference evaluates it:
    ``1 / (1 + exp(-x))`` with ``expf`` above, subnormal results flushed
    to zero; gradient ``g*(out*(1 - out))``."""
    return ftz(1.0 / (1.0 + expf(-x)))


sigmoidf = _with_grad(_sigmoidf, lambda g, out: g * (out * (1.0 - out)))
