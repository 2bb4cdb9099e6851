"""Model assembly for the serving zoo (port of
``repro/models/transformer.py`` without the encoder-decoder layers).

A model = embedding + a list of *groups*.  Each group is a stack of
identical *periods* (weights stacked on a leading ``layers`` dim), where a
period is a short tuple of (mixer, ffn) sub-layers.  The port runs the
stacked dim as a Python loop (the reference scans it with ``lax.scan``)
and keeps the stacked tree layout, so that weights cross key for key.

Ported kinds (mixer, ffn):
  ("gqa_g", "mlp")      global causal GQA, optionally over an int8 KV
                        cache (``kv_quant_int8``: int8 K/V with float32
                        scales per (position, kv head), ``quantize_kv``)
  ("gqa_l", "mlp")      sliding-window GQA over ``cfg.window`` positions,
                        a ring KV cache of ``min(window, max_len)`` slots
                        (slot = position % slots; bf16 even with the int8
                        option, as in the reference)
  ("mla", "mlp"|"moe")  DeepSeek latent attention (``models/mla.py``), a
                        dense MLP or the MoE FFN (``models/moe.py``, the
                        dense path on one device)
  ("mamba", None)       Mamba-2 (``models/ssm.py``)
  ("shared_gqa", "mlp") Zamba2's shared block: a global GQA layer whose
                        weights live once at model level
                        (``shared_block``), applied after every period of
                        Mamba-2 layers, each application with its own
                        KV cache
  ("rwkv6", "rwkv_ffn") RWKV-6 time and channel mixing (``models/rwkv.py``)
with the MLP's three ``mlp_kind``s, the attention-logit softcap,
post-norms, qk-norm and a local rope theta.  The encoder-decoder and VLM
extras raise ``NotImplementedError``: they come with ROADMAP.md queue
item 9.5.

Every kind trains (``mode="train"``: the prefill's math without a cache,
under autograd); with ``cfg.flash_attention``, causal global attention
past 1,024 positions without a softcap runs ``models/flash.py``, whose
backward recomputes the probabilities, as in the reference.  The cache
and state writes below happen only with a cache, never on the train
path.

Decode attention of the GQA layers runs through ``decode_impl``:
``"torch"`` is the port of ``layers.decode_attention``,
``decode_attention_quant`` and ``_ring_decode`` (the reference's serving
math), ``"cuda"`` the hand-written ``flash_decode`` kernel
(``repro_torch.kernels.flash_decode``), softcap and int8 cache included.
A ring's valid slots are exactly ``[0, min(pos + 1, slots))``, and the
softmax does not depend on the keys' order, so a ring decode is the
kernel over the ring at that length.  MLA, Mamba-2 and RWKV-6 decode have
no kernel in the reference: they run the same torch code under either
``decode_impl``.  The KV caches and the recurrent states are updated in
place (the reference returns new ones).
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from repro_torch.common.pytree import ParamDef, tree_map
from repro_torch.kernels.flash_decode import ops as fd_ops
from repro_torch.models import layers as L
from repro_torch.models import mla as MLA
from repro_torch.models import moe as MOE
from repro_torch.models import rwkv as RWKV
from repro_torch.models import ssm as SSM
from repro_torch.models.flash import flash_attention

SUPPORTED_KINDS = (("gqa_g", "mlp"), ("gqa_l", "mlp"), ("mla", "mlp"),
                   ("mla", "moe"), ("mamba", None), ("shared_gqa", "mlp"),
                   ("rwkv6", "rwkv_ffn"))
_LATER = "comes with ROADMAP.md queue item 9.5"


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
    options = {"enc_dec": cfg.enc_dec,
               "vlm_prefix_len": bool(cfg.vlm_prefix_len)}
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
    mixer, ffn = kind
    if mixer == "shared_gqa":
        return {}  # all params live at model level (single shared copy)
    d: dict = {"ln1": _norm_defs(cfg)}
    if mixer in ("gqa_g", "gqa_l"):
        d["attn"] = L.gqa_defs(cfg)
    elif mixer == "mla":
        d["attn"] = MLA.mla_defs(cfg)
    elif mixer == "mamba":
        d["mixer"] = SSM.mamba2_defs(cfg)
    elif mixer == "rwkv6":
        d["mixer"] = RWKV.rwkv6_defs(cfg)["time"]
    if ffn == "mlp":
        d["ln2"] = _norm_defs(cfg)
        d["mlp"] = mlp_defs(cfg)
    elif ffn == "moe":
        d["ln2"] = _norm_defs(cfg)
        d["moe"] = MOE.moe_defs(cfg)
    elif ffn == "rwkv_ffn":
        d["ln2"] = _norm_defs(cfg)
        d["ffn"] = RWKV.rwkv6_defs(cfg)["channel"]
    if cfg.post_norm:
        d["ln1_post"] = _norm_defs(cfg)
        if ffn in ("mlp", "moe"):
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
    """The decode cache of one layer: ``max_len`` positions of K/V for a
    global layer (int8 with float32 scales ``k_s``/``v_s`` under
    ``kv_quant_int8``), a ring of ``min(window, max_len)`` for a local one,
    the latent ``c`` and rope key ``pe`` for MLA, the recurrent states
    (float32) for Mamba-2 and RWKV-6."""
    mixer, _ = kind
    Hkv, dh = cfg.n_kv_heads, cfg.head_dim
    if mixer in ("gqa_g", "shared_gqa"):
        kv_dt = torch.int8 if cfg.kv_quant_int8 else torch.bfloat16
        d = {
            "k": ParamDef((batch, max_len, Hkv, dh), ("batch", "seq", "kv_heads", None),
                          init="zeros", dtype=kv_dt),
            "v": ParamDef((batch, max_len, Hkv, dh), ("batch", "seq", "kv_heads", None),
                          init="zeros", dtype=kv_dt),
        }
        if cfg.kv_quant_int8:
            d["k_s"] = ParamDef((batch, max_len, Hkv), ("batch", "seq", "kv_heads"),
                                init="zeros", dtype=torch.float32)
            d["v_s"] = ParamDef((batch, max_len, Hkv), ("batch", "seq", "kv_heads"),
                                init="zeros", dtype=torch.float32)
        return d
    if mixer == "gqa_l":
        W = min(cfg.window or max_len, max_len)
        return {
            "k": ParamDef((batch, W, Hkv, dh), ("batch", None, "kv_heads", None),
                          init="zeros", dtype=torch.bfloat16),
            "v": ParamDef((batch, W, Hkv, dh), ("batch", None, "kv_heads", None),
                          init="zeros", dtype=torch.bfloat16),
        }
    if mixer == "mla":
        return {
            "c": ParamDef((batch, max_len, cfg.kv_lora_rank), ("batch", "seq", "mla_latent"),
                          init="zeros", dtype=torch.bfloat16),
            "pe": ParamDef((batch, max_len, cfg.qk_rope_head_dim), ("batch", "seq", None),
                           init="zeros", dtype=torch.bfloat16),
        }
    if mixer == "mamba":
        return SSM.mamba2_state_defs(cfg, batch)
    if mixer == "rwkv6":
        return RWKV.rwkv6_state_defs(cfg, batch)
    raise ValueError(mixer)


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
        if cfg.kv_quant_int8:
            ksc, vsc = cache["k_s"], cache["v_s"]
            kc[:, pos0], ksc[:, pos0] = (t[:, 0] for t in L.quantize_kv(k))
            vc[:, pos0], vsc[:, pos0] = (t[:, 0] for t in L.quantize_kv(v))
            if decode.impl == "cuda":
                o = fd_ops.gqa_decode_attention(
                    q, kc, vc, decode.length(pos0 + 1), max_length=pos0 + 1,
                    softcap=softcap, k_scale=ksc, v_scale=vsc)
            else:
                o = L.decode_attention_quant(q, kc, vc, ksc, vsc,
                                             length=pos0 + 1, softcap=softcap)
            return L.gqa_out(p, o, x.dtype), cache
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

    # train / prefill
    if local and W is not None and S > W:
        o = L.local_attention(q, k, v, window=W, softcap=softcap)
    elif S <= 1024:
        o = L.dense_attention(q, k, v, causal=True,
                              window=W if local else None, softcap=softcap)
    elif cfg.flash_attention and softcap is None:
        o = flash_attention(q, k, v, True, cfg.block_q, cfg.block_k)
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
            if cfg.kv_quant_int8:
                cache["k"][:, :S], cache["k_s"][:, :S] = L.quantize_kv(k)
                cache["v"][:, :S], cache["v_s"][:, :S] = L.quantize_kv(v)
            else:
                cache["k"][:, :S] = k.to(cache["k"].dtype)
                cache["v"][:, :S] = v.to(cache["v"].dtype)
    return L.gqa_out(p, o, x.dtype), cache


def _write_state(cache, new) -> None:
    """Copy a recurrent state's new leaves into the cache tree in place."""
    for key, val in new.items():
        if isinstance(val, dict):
            _write_state(cache[key], val)
        else:
            cache[key].copy_(val)


def _apply_layer(cfg, kind, p, x, *, positions, mode, cache,
                 decode: DecodeStep | None = None, shared_params=None,
                 mesh=None):
    """One sub-layer of a kind of ``SUPPORTED_KINDS`` (``check_supported``
    has vetted the config); a local layer takes ``rope_theta_local``
    where the config sets one, a shared block ``shared_params``, a MoE
    FFN ``mesh`` (the reference's ``models/transformer.py:419``).  The
    cache (KV, latent or recurrent state) is written in place.  Returns
    (x, cache)."""
    mixer, ffn = kind
    if mixer == "shared_gqa":
        p = shared_params  # single copy, reused every period
    if mixer in ("gqa_g", "gqa_l", "shared_gqa"):
        local = mixer == "gqa_l"
        theta = cfg.rope_theta
        if local and cfg.rope_theta_local is not None:
            theta = cfg.rope_theta_local
        h = _norm_apply(cfg, p["ln1"], x)
        o, cache = _gqa_attend(cfg, p["attn"], h, local=local,
                               positions=positions, mode=mode, cache=cache,
                               softcap=cfg.logit_softcap, theta=theta,
                               decode=decode)
        if cfg.post_norm and mixer != "shared_gqa":
            o = _norm_apply(cfg, p["ln1_post"], o)
        x = x + o
    elif mixer == "mla":
        h = _norm_apply(cfg, p["ln1"], x)
        if mode == "decode":
            pos0 = decode.pos
            c_new, pe_new = MLA.mla_prefill_cache(p["attn"], h, cfg, positions)
            cache["c"][:, pos0] = c_new[:, 0].to(cache["c"].dtype)
            cache["pe"][:, pos0] = pe_new[:, 0].to(cache["pe"].dtype)
            o = MLA.mla_decode(p["attn"], h, cfg, cache["c"], cache["pe"],
                               length=pos0)
        else:
            o = MLA.mla_train(p["attn"], h, cfg, positions)
            if cache is not None:
                S = h.shape[1]
                if S > cache["c"].shape[1]:
                    raise ValueError(f"a prompt of {S} tokens does not fit "
                                     f"a cache of {cache['c'].shape[1]}")
                c_new, pe_new = MLA.mla_prefill_cache(p["attn"], h, cfg,
                                                      positions)
                cache["c"][:, :S] = c_new.to(cache["c"].dtype)
                cache["pe"][:, :S] = pe_new.to(cache["pe"].dtype)
        x = x + o
    elif mixer == "mamba":
        h = _norm_apply(cfg, p["ln1"], x)
        o, st = SSM.mamba2_apply(p["mixer"], h, cfg, cache)
        if cache is not None:
            _write_state(cache, st)
        return x + o, cache
    elif mixer == "rwkv6":
        h = _norm_apply(cfg, p["ln1"], x)
        o, st = RWKV.rwkv6_time_mix(p["mixer"], h, cfg,
                                    None if cache is None else cache["time"])
        x = x + o
        h = _norm_apply(cfg, p["ln2"], x)
        o2, st2 = RWKV.rwkv6_channel_mix(
            p["ffn"], h, cfg, None if cache is None else cache["channel"])
        if cache is not None:
            _write_state(cache, {"time": st, "channel": st2})
        return x + o2, cache
    else:
        raise ValueError(mixer)

    # ffn half (as in the reference, a post-norm follows the MLP only)
    h = _norm_apply(cfg, p["ln2"], x)
    if ffn == "moe":
        B, S, D = h.shape
        return x + MOE.moe_apply(p["moe"], h.reshape(B * S, D), cfg,
                                 mesh).reshape(B, S, D), cache
    o = mlp_apply(cfg, p["mlp"], h)
    if cfg.post_norm and mixer != "shared_gqa":
        o = _norm_apply(cfg, p["ln2_post"], o)
    return x + o, cache
