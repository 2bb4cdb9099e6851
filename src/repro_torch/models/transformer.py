"""Model assembly for GQA transformers with global and sliding-window
layers (port of the attention-family subset of
``repro/models/transformer.py``).

A model = embedding + a list of *groups*.  Each group is a stack of
identical *periods* (weights stacked on a leading ``layers`` dim), where a
period is a short tuple of (mixer, ffn) sub-layers.  The port runs the
stacked dim as a Python loop (the reference scans it with ``lax.scan``)
and keeps the stacked tree layout, so that weights cross key for key.

Ported kinds: ``("gqa_g", "mlp")``, global causal GQA, and
``("gqa_l", "mlp")``, sliding-window GQA over ``cfg.window`` positions
with a ring KV cache of ``min(window, max_len)`` slots (slot = position %
slots), each with an MLP (all three ``mlp_kind``s), the attention-logit
softcap, post-norms, qk-norm and a local rope theta.  Every other kind,
and the options that only they or training use (the int8 KV cache,
MLA/MoE/SSM/RWKV, encoder-decoder and VLM extras, flash attention for
training), raise ``NotImplementedError``: they come with ROADMAP.md queue
item 9.

Decode attention runs through ``decode_impl``: ``"torch"`` is the port of
``layers.decode_attention`` and ``_ring_decode`` (the reference's serving
math), ``"cuda"`` the hand-written ``flash_decode`` kernel
(``repro_torch.kernels.flash_decode``), softcap included.  A ring's valid
slots are exactly ``[0, min(pos + 1, slots))``, and the softmax does not
depend on the keys' order, so a ring decode is the kernel over the ring
at that length.  The KV caches are updated in place (the reference
returns new caches).
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from repro_torch.common.pytree import ParamDef, tree_map
from repro_torch.kernels.flash_decode import ops as fd_ops
from repro_torch.models import layers as L

SUPPORTED_KINDS = (("gqa_g", "mlp"), ("gqa_l", "mlp"))
_LATER = "comes with ROADMAP.md queue item 9"


# ---------------------------------------------------------------------------
# group construction
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Group:
    kinds: tuple[tuple[str, str | None], ...]   # one (mixer, ffn) per sub-layer
    n: int                                      # number of stacked periods


def build_groups(cfg) -> list[Group]:
    Lyr = cfg.n_layers
    if cfg.block_kind == "rwkv6":
        return [Group((("rwkv6", "rwkv_ffn"),), Lyr)]
    if cfg.block_kind == "mamba2":
        per = cfg.shared_attn_period or Lyr
        kinds = tuple((("mamba", None),) * per) + ((("shared_gqa", "mlp"),) if cfg.shared_attn_period else ())
        n_full, rem = divmod(Lyr, per)
        groups = [Group(kinds, n_full)]
        if rem:
            groups.append(Group((("mamba", None),) * rem, 1))
        return groups
    # attention families
    ffn = "moe" if cfg.moe else "mlp"
    mixer = "mla" if cfg.attn_kind == "mla" else None
    groups: list[Group] = []
    if cfg.moe and cfg.first_dense_layers:
        mk = mixer or "gqa_g"
        groups.append(Group(((mk, "mlp"),), cfg.first_dense_layers))
        Lyr -= cfg.first_dense_layers
    if mixer == "mla":
        groups.append(Group((("mla", ffn),), Lyr))
        return groups
    period = tuple((("gqa_l" if c == "l" else "gqa_g"), "mlp") for c in cfg.attn_pattern)
    n_full, rem = divmod(Lyr, len(period))
    if n_full:
        groups.append(Group(period, n_full))
    if rem:
        groups.append(Group(period[:rem], 1))
    return groups


def check_supported(cfg) -> None:
    """Raise ``NotImplementedError`` for a config that needs anything the
    port does not have yet."""
    kinds = {k for g in build_groups(cfg) for k in g.kinds}
    bad = sorted(str(k) for k in kinds if k not in SUPPORTED_KINDS)
    options = {"kv_quant_int8": cfg.kv_quant_int8, "enc_dec": cfg.enc_dec,
               "vlm_prefix_len": bool(cfg.vlm_prefix_len),
               "flash_attention": cfg.flash_attention}
    bad += [name for name, on in options.items() if on]
    if bad:
        raise NotImplementedError(f"{cfg.name}: {', '.join(bad)} not ported "
                                  f"(ported: {SUPPORTED_KINDS}); {_LATER}")


# ---------------------------------------------------------------------------
# per-layer defs
# ---------------------------------------------------------------------------

def _norm_defs(cfg):
    return L.rmsnorm_defs(cfg.d_model) if cfg.norm_kind == "rms" else L.layernorm_defs(cfg.d_model)


def _norm_apply(cfg, p, x):
    return L.rmsnorm_apply(p, x) if cfg.norm_kind == "rms" else L.layernorm_apply(p, x)


def mlp_defs(cfg) -> dict:
    D, Fd = cfg.d_model, cfg.d_ff
    d = {
        "w1": ParamDef((D, Fd), ("embed", "mlp"), init="scaled"),
        "w2": ParamDef((Fd, D), ("mlp", "embed"), init="scaled"),
    }
    if cfg.mlp_kind in ("swiglu", "geglu"):
        d["w3"] = ParamDef((D, Fd), ("embed", "mlp"), init="scaled")
    return d


def mlp_apply(cfg, p, x):
    h = x @ p["w1"].to(x.dtype)
    if cfg.mlp_kind == "swiglu":
        h = F.silu(h) * (x @ p["w3"].to(x.dtype))
    elif cfg.mlp_kind == "geglu":
        h = F.gelu(h, approximate="tanh") * (x @ p["w3"].to(x.dtype))
    else:
        h = F.gelu(h, approximate="tanh")
    return h @ p["w2"].to(x.dtype)


def layer_defs(cfg, kind) -> dict:
    if kind not in SUPPORTED_KINDS:
        raise NotImplementedError(f"layer kind {kind}: {_LATER}")
    d: dict = {"ln1": _norm_defs(cfg), "attn": L.gqa_defs(cfg),
               "ln2": _norm_defs(cfg), "mlp": mlp_defs(cfg)}
    if cfg.post_norm:
        d["ln1_post"] = _norm_defs(cfg)
        d["ln2_post"] = _norm_defs(cfg)
    return d


def _stack_defs(defs, n: int):
    """Prepend a stacked 'layers' dim of size n to every ParamDef."""
    return tree_map(lambda d: ParamDef((n, *d.shape), ("layers", *d.axes),
                                       init=d.init, dtype=d.dtype), defs)


# ---------------------------------------------------------------------------
# cache defs
# ---------------------------------------------------------------------------

def _cache_defs_for(cfg, kind, batch: int, max_len: int) -> dict:
    """The K/V cache of one layer: ``max_len`` positions for a global
    layer, a ring of ``min(window, max_len)`` for a local one."""
    mixer, _ = kind
    Hkv, dh = cfg.n_kv_heads, cfg.head_dim
    if mixer == "gqa_l":
        W = min(cfg.window or max_len, max_len)
        return {
            "k": ParamDef((batch, W, Hkv, dh), ("batch", None, "kv_heads", None),
                          init="zeros", dtype=torch.bfloat16),
            "v": ParamDef((batch, W, Hkv, dh), ("batch", None, "kv_heads", None),
                          init="zeros", dtype=torch.bfloat16),
        }
    return {
        "k": ParamDef((batch, max_len, Hkv, dh), ("batch", "seq", "kv_heads", None),
                      init="zeros", dtype=torch.bfloat16),
        "v": ParamDef((batch, max_len, Hkv, dh), ("batch", "seq", "kv_heads", None),
                      init="zeros", dtype=torch.bfloat16),
    }


# ---------------------------------------------------------------------------
# layer application
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class DecodeStep:
    """One decode step: the position it writes (every row of ``batch``),
    the decode attention to run (``"torch"`` or ``"cuda"``) and, for
    ``"cuda"``, the device the per-row valid lengths live on."""
    pos: int
    impl: str
    batch: int
    device: torch.device | None
    _lengths: dict = dataclasses.field(default_factory=dict, repr=False)

    def length(self, n: int) -> torch.Tensor:
        """(batch,) int32 on ``device``, every row ``n``: made once a step
        for each length (``pos + 1``; ``min(pos + 1, slots)`` of a ring)."""
        if n not in self._lengths:
            self._lengths[n] = torch.full((self.batch,), n, dtype=torch.int32,
                                          device=self.device)
        return self._lengths[n]


def _ring_fill(cache, k, v, S: int, Wr: int) -> None:
    """Store the last ``Wr`` positions of (k, v) in ring order (slot =
    position % Wr), in place."""
    take = min(S, Wr)
    pos = torch.arange(S - take, S, device=k.device) % Wr
    cache["k"][:, pos] = k[:, S - take:].to(cache["k"].dtype)
    cache["v"][:, pos] = v[:, S - take:].to(cache["v"].dtype)


def _ring_decode(q, kc, vc, pos: int, Wr: int, softcap):
    """Decode attention over a ring cache: slot j holds position
    p = pos - ((pos - j) mod Wr), valid iff p >= 0, i.e. j < pos + 1; the
    softmax does not depend on the order, so the valid slots are the first
    ``min(pos + 1, Wr)``.  The reference's masked softmax over all ``Wr``
    slots adds exact zeros past them; the port reads only those."""
    n = min(pos + 1, Wr)
    B, _, Hq, Dh = q.shape
    Hkv = kc.shape[2]
    qr = q.reshape(B, Hkv, Hq // Hkv, Dh)
    s = L._scores(qr, kc[:, :n], "bhgd,bkhd->bhgk") / math.sqrt(Dh)
    s = L._softcap(s, softcap)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgk,bkhd->bhgd", p.to(vc.dtype), vc[:, :n])
    return o.reshape(B, 1, Hq, Dh)


def _gqa_attend(cfg, p, x, *, local: bool, positions, mode, cache, softcap,
                theta, decode: DecodeStep | None = None):
    """Causal GQA, global or over ``cfg.window`` (``local``, ring cache).
    Returns (out, cache); the cache is written in place."""
    S = x.shape[1]
    q, k, v = L.gqa_project(p, x, cfg, positions, theta)
    W = cfg.window
    if mode == "decode":
        pos0 = decode.pos
        kc, vc = cache["k"], cache["v"]
        if local:
            Wr = kc.shape[1]
            slot = pos0 % Wr
            kc[:, slot] = k[:, 0].to(kc.dtype)
            vc[:, slot] = v[:, 0].to(vc.dtype)
            n = min(pos0 + 1, Wr)
            if decode.impl == "cuda":
                o = fd_ops.gqa_decode_attention(q, kc, vc, decode.length(n),
                                                max_length=n, softcap=softcap)
            else:
                o = _ring_decode(q, kc, vc, pos0, Wr, softcap)
            return L.gqa_out(p, o, x.dtype), cache
        if not 0 <= pos0 < kc.shape[1]:
            raise ValueError(f"decode position {pos0} outside the cache of "
                             f"{kc.shape[1]}")
        kc[:, pos0] = k[:, 0].to(kc.dtype)
        vc[:, pos0] = v[:, 0].to(vc.dtype)
        if decode.impl == "cuda":
            o = fd_ops.gqa_decode_attention(q, kc, vc,
                                            decode.length(pos0 + 1),
                                            max_length=pos0 + 1,
                                            softcap=softcap)
        else:
            o = L.decode_attention(q, kc, vc, length=pos0 + 1,
                                   softcap=softcap)
        return L.gqa_out(p, o, x.dtype), cache

    # prefill
    if local and W is not None and S > W:
        o = L.local_attention(q, k, v, window=W, softcap=softcap)
    elif S <= 1024:
        o = L.dense_attention(q, k, v, causal=True,
                              window=W if local else None, softcap=softcap)
    else:
        o = L.blockwise_attention(q, k, v, causal=True, softcap=softcap,
                                  block_q=cfg.block_q, block_k=cfg.block_k)
    if cache is not None:
        if local:
            _ring_fill(cache, k, v, S, cache["k"].shape[1])
        else:
            if S > cache["k"].shape[1]:
                raise ValueError(f"a prompt of {S} tokens does not fit a "
                                 f"cache of {cache['k'].shape[1]}")
            cache["k"][:, :S] = k.to(cache["k"].dtype)
            cache["v"][:, :S] = v.to(cache["v"].dtype)
    return L.gqa_out(p, o, x.dtype), cache


def _apply_layer(cfg, kind, p, x, *, positions, mode, cache,
                 decode: DecodeStep | None = None):
    """One ("gqa_g" | "gqa_l", "mlp") sub-layer (``check_supported`` has
    vetted the config); a local layer takes ``rope_theta_local`` where the
    config sets one.  Returns (x, cache)."""
    local = kind[0] == "gqa_l"
    theta = cfg.rope_theta
    if local and cfg.rope_theta_local is not None:
        theta = cfg.rope_theta_local
    h = _norm_apply(cfg, p["ln1"], x)
    o, cache = _gqa_attend(cfg, p["attn"], h, local=local,
                           positions=positions, mode=mode, cache=cache,
                           softcap=cfg.logit_softcap, theta=theta,
                           decode=decode)
    if cfg.post_norm:
        o = _norm_apply(cfg, p["ln1_post"], o)
    x = x + o
    h = _norm_apply(cfg, p["ln2"], x)
    o = mlp_apply(cfg, p["mlp"], h)
    if cfg.post_norm:
        o = _norm_apply(cfg, p["ln2_post"], o)
    return x + o, cache
