"""Model assembly for the whole zoo (port of
``repro/models/transformer.py``).

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
  ("enc_attn", "mlp")   Whisper's encoder: bidirectional attention
                        without positions in the projections (dense up
                        to 1,024 positions, blockwise above); no cache
  ("dec_attn", "mlp")   a causal self-attention (``_gqa_attend``, its
                        KV cache) then cross-attention over the encoder's
                        output (or over the cache's ``xk``/``xv``, which
                        the prefill fills from it)
with the MLP's three ``mlp_kind``s, the attention-logit softcap,
post-norms, qk-norm, a local rope theta and the VLM's prefix-LM mask
(``prefix_len``: every query also sees the image prefix).  As in the
reference, ``Model`` builds Whisper's decoder from ``build_groups`` (causal
GQA layers that never read the encoder): ``dec_groups`` and the
``dec_attn`` mixer are here for the layer API, as they are there.

Every kind trains (``mode="train"``: the prefill's math without a cache,
under autograd); with ``cfg.flash_attention``, causal global attention
past 1,024 positions without a softcap runs ``models/flash.py``, whose
backward recomputes the probabilities, as in the reference.  The cache
and state writes below happen only with a cache, never on the train
path.

**Tensor parallelism** (``TP``, on a live mesh with a ``model`` axis, as
the reference's GSPMD lays these layers out): a GQA mixer (the encoder's
too) and an MLP take their weights as this rank's blocks over ``model``
(``heads``, ``kv_heads``, ``mlp``), Megatron-style.  Attention runs this
rank's q heads against the kv heads they read (where ``kv_heads`` stays
replicated, every rank projects every kv head and selects ``h // G`` for
its q heads), ``wo`` gives a partial sum; the MLP's ``w1``/``w3`` are
column-parallel and ``w2`` row-parallel.  MLA (``mla.py``), Mamba-2
(``ssm.py``), RWKV-6 (``rwkv.py``) and the MoE FFN with its shared
experts (``moe.moe_block_tp``) have their own tensor-parallel forms
(``tp_leaves`` names the leaves each kind reads as blocks).  A block is
entered through ``comm.tp_enter`` (its gradient summed over ``model``)
and left through a ``psum``; a replicated weight that the block reads
on a part of the work (q/k-norm, replicated ``wk``/``wv``, MLA's norms,
Mamba-2's ``A_log``/``dt_bias``/``D_skip``, RWKV-6's mixes, decay and
group norm, and every norm under sequence parallelism) is read through
``TP.rep``, so its gradient is whole on every rank.  With ``TP.seq``
(``cfg.seq_parallel`` in training) the residual between blocks of every
kind is this rank's ``S / model`` slice of the sequence: a block enters
by an all-gather along the sequence and leaves by a reduce-scatter (the
recurrent kinds scan whole sequences).  A weight whose dim does not
divide over ``model`` stays whole (``MeshRules``), and its block runs
replicated.

Decode attention of the GQA layers runs through ``decode_impl``:
``"torch"`` is the port of ``layers.decode_attention``,
``decode_attention_quant`` and ``_ring_decode`` (the reference's serving
math), ``"cuda"`` the hand-written ``flash_decode`` kernel
(``repro_torch.kernels.flash_decode``), softcap and int8 cache included.
A global layer whose cache splits along the sequence across ranks runs
``_split_decode``: the log-sum-exp pair over each rank's block (the
kernel's log-sum-exp instantiation under ``"cuda"``, its plain version
``ref.gqa_decode_lse_ref`` under ``"torch"``), merged exactly
(``layers.merge_split``).
A ring's valid slots are exactly ``[0, min(pos + 1, slots))``, and the
softmax does not depend on the keys' order, so a ring decode is the
kernel over the ring at that length.  MLA, Mamba-2 and RWKV-6 decode have
no kernel in the reference: they run the same torch code under either
``decode_impl``; MLA over a latent cache split along the sequence runs
``mla.mla_decode_split`` (the same merge).  A prefill into such a cache
(``SeqSplit``) computes what the unsplit prefill computes and keeps this
rank's block of positions (``_fill_split``: over ``model`` one
all-to-all a layer from this rank's kv heads to its block's positions;
a ring's kv heads all-gathered where it holds every one).  The KV caches and the recurrent states are updated in
place (the reference returns new ones).
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from repro_torch.common import comm
from repro_torch.common.pytree import ParamDef, tree_map
from repro_torch.kernels.flash_decode import ops as fd_ops
from repro_torch.kernels.flash_decode import ref as fd_ref
from repro_torch.models import layers as L
from repro_torch.models import mla as MLA
from repro_torch.models import moe as MOE
from repro_torch.models import rwkv as RWKV
from repro_torch.models import ssm as SSM
from repro_torch.models.flash import flash_attention

SUPPORTED_KINDS = (("gqa_g", "mlp"), ("gqa_l", "mlp"), ("mla", "mlp"),
                   ("mla", "moe"), ("mamba", None), ("shared_gqa", "mlp"),
                   ("rwkv6", "rwkv_ffn"), ("enc_attn", "mlp"),
                   ("dec_attn", "mlp"))


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


def enc_groups(cfg) -> list[Group]:
    return [Group((("enc_attn", "mlp"),), cfg.n_enc_layers)]


def dec_groups(cfg) -> list[Group]:
    return [Group((("dec_attn", "mlp"),), cfg.n_layers)]


def check_supported(cfg) -> None:
    """Raise ``ValueError`` for a config whose layers (decoder, and the
    encoder of an encoder-decoder) include a kind outside
    ``SUPPORTED_KINDS``."""
    groups = build_groups(cfg) + (enc_groups(cfg) if cfg.enc_dec else [])
    kinds = {k for g in groups for k in g.kinds}
    bad = sorted(str(k) for k in kinds if k not in SUPPORTED_KINDS)
    if bad:
        raise ValueError(f"{cfg.name}: {', '.join(bad)} unknown (known: "
                         f"{SUPPORTED_KINDS})")


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


@dataclasses.dataclass(frozen=True)
class TP:
    """The ``model`` axis of a live mesh that the dense layers are split
    over (``n`` ranks, this one ``i``); ``seq``: sequence parallelism."""
    mesh: object
    n: int
    i: int
    seq: bool = False

    def rep(self, w: torch.Tensor) -> torch.Tensor:
        """A replicated weight read on a part of the work: its gradient
        is summed over ``model``."""
        return comm.tp_enter(w, self.mesh, "model")

    def enter(self, h: torch.Tensor, split: bool) -> torch.Tensor:
        """A block's input: all-gathered along the sequence under
        ``seq``; into a split block through ``tp_enter``."""
        if self.seq:
            return comm.tp_enter(h, self.mesh, "model", dim=1)
        return comm.tp_enter(h, self.mesh, "model") if split else h

    def leave(self, o: torch.Tensor, split: bool) -> torch.Tensor:
        """A block's output: the partial sums of a split block reduced
        (scattered along the sequence under ``seq``), a replicated
        block's output cut to this rank's slice under ``seq``."""
        if split:
            return (comm.psum_scatter(o, self.mesh, "model", dim=1)
                    if self.seq else comm.psum(o, self.mesh, "model"))
        if self.seq:
            k = o.shape[1] // self.n
            return o.narrow(1, self.i * k, k)
        return o

    def leave_whole(self, o: torch.Tensor) -> torch.Tensor:
        """The output of a split block that is whole on every rank (its
        partial sums reduced inside): as it is, or this rank's slice of
        the sequence under ``seq``, whose backward all-gathers the
        gradient (every rank's partial work needs every position's)."""
        return comm.tp_split(o, self.mesh, "model", dim=1) if self.seq else o

    def norm(self, cfg, p, x):
        """A norm of the residual: its scale read on this rank's slice
        under ``seq``."""
        if self.seq:
            p = tree_map(self.rep, p)
        return _norm_apply(cfg, p, x)

    def gather(self, t: torch.Tensor) -> torch.Tensor:
        """The last dim of a column-parallel product's output all-gathered
        (its gradient, partial on each rank, reduce-scattered)."""
        return comm.tp_enter(t, self.mesh, "model", dim=t.dim() - 1)

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        """The sum over ``model`` of a partial result that each rank then
        reads on its part of the work (its gradient summed too)."""
        return comm.psum(self.rep(t), self.mesh, "model")

    def cols(self, t: torch.Tensor, n: int | None = None) -> torch.Tensor:
        """This rank's block of the last dim of a whole tensor."""
        k = (t.shape[-1] if n is None else n) // self.n
        return t[..., self.i * k:(self.i + 1) * k]


TP_MIXERS = ("gqa_g", "gqa_l", "shared_gqa", "enc_attn")
_W3 = ("w1", "w3", "w2")
# the leaves each mixer and FFN kind runs on as this rank's blocks over
# ``model`` (paths below the sub-layer's parameters)
_TP_LEAVES = {
    "gqa": tuple(("attn", n) for n in ("wq", "wk", "wv", "wo")),
    "mlp": tuple(("mlp", n) for n in _W3),
    "moe": tuple(("moe", "shared", n) for n in _W3),
    "mla": tuple(("attn", n) for n in ("wq", "wq_b", "wkv_a", "wkv_b", "wo")),
    "mamba": tuple(("mixer", n) for n in ("w_in", "conv_w", "conv_b", "w_out"))
    + (("mixer", "out_norm", "scale"),),
    "rwkv6": tuple(("mixer", n) for n in ("wr", "wk", "wv", "wg", "wo", "u")),
    "rwkv_ffn": tuple(("ffn", n) for n in ("wk", "wv", "wr")),
}


def tp_leaves(kind, cfg, n: int) -> tuple:
    """The leaf paths of a sub-layer of ``kind`` that run tensor-parallel
    over ``n`` ranks of ``model`` (``Model.tp_leaf``): a kind whose
    tensor-parallel form does not divide (MLA's heads, Mamba-2's heads or
    conv channels) has none, and runs on gathered weights."""
    mixer, ffn = kind
    out = _TP_LEAVES["gqa"] if mixer in TP_MIXERS else ()
    if mixer == "mla" and cfg.n_heads % n == 0:
        out = out + _TP_LEAVES["mla"]
    elif mixer == "mamba" and SSM.tp_divides(cfg, n):
        out = out + _TP_LEAVES["mamba"]
    elif mixer == "rwkv6":
        out = out + _TP_LEAVES["rwkv6"]
    return out + _TP_LEAVES.get(ffn, ())


def _tp_block(tp: TP | None, p: dict, split: bool) -> dict:
    """A block's weights; under ``seq`` a replicated block keeps only its
    slice's outputs, so its weights are read through ``tp.rep``."""
    if tp is not None and tp.seq and not split:
        return tree_map(tp.rep, p)
    return p


def tp_of(mesh, seq: bool = False) -> TP | None:
    """The ``TP`` of a live mesh whose ``model`` axis is larger than 1;
    None otherwise."""
    if mesh is None or not mesh.is_live or mesh.shape.get("model", 1) == 1:
        return None
    return TP(mesh, mesh.shape["model"], mesh.axis_index("model"), seq)


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
        raise ValueError(f"layer kind {kind} unknown")
    mixer, ffn = kind
    if mixer == "shared_gqa":
        return {}  # all params live at model level (single shared copy)
    d: dict = {"ln1": _norm_defs(cfg)}
    if mixer in ("gqa_g", "gqa_l", "enc_attn", "dec_attn"):
        d["attn"] = L.gqa_defs(cfg)
    elif mixer == "mla":
        d["attn"] = MLA.mla_defs(cfg)
    elif mixer == "mamba":
        d["mixer"] = SSM.mamba2_defs(cfg)
    elif mixer == "rwkv6":
        d["mixer"] = RWKV.rwkv6_defs(cfg)["time"]
    if mixer == "dec_attn":
        d["lnx"] = _norm_defs(cfg)
        d["cross"] = L.gqa_defs(cfg)
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

def _cache_defs_for(cfg, kind, batch: int, max_len: int) -> dict | None:
    """The decode cache of one layer: ``max_len`` positions of K/V for a
    global layer (int8 with float32 scales ``k_s``/``v_s`` under
    ``kv_quant_int8``; a decoder layer adds the cross-attention's
    ``xk``/``xv`` over ``cfg.enc_len`` encoder positions, bf16), a ring of
    ``min(window, max_len)`` for a local one, the latent ``c`` and rope key
    ``pe`` for MLA, the recurrent states (float32) for Mamba-2 and RWKV-6;
    None for an encoder layer."""
    mixer, _ = kind
    Hkv, dh = cfg.n_kv_heads, cfg.head_dim
    if mixer in ("gqa_g", "dec_attn", "shared_gqa"):
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
        if mixer == "dec_attn":
            el = cfg.enc_len
            d["xk"] = ParamDef((batch, el, Hkv, dh), ("batch", None, "kv_heads", None),
                               init="zeros", dtype=torch.bfloat16)
            d["xv"] = ParamDef((batch, el, Hkv, dh), ("batch", None, "kv_heads", None),
                               init="zeros", dtype=torch.bfloat16)
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
    if mixer == "enc_attn":
        return None
    raise ValueError(mixer)


# ---------------------------------------------------------------------------
# layer application
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class DecodeStep:
    """One decode step: the position it writes (every row of ``batch``),
    the decode attention to run (``"torch"`` or ``"cuda"``) and, for
    ``"cuda"``, the device the per-row valid lengths live on.  A global
    layer's cache split along the sequence over the mesh axes
    ``seq_axes`` (``Model.cache_seq_axes``) holds this rank's block
    ``seq_index`` of it (``_split_decode``)."""
    pos: int
    impl: str
    batch: int
    device: torch.device | None
    mesh: object = None
    seq_axes: tuple = ()
    seq_index: int = 0
    _lengths: dict = dataclasses.field(default_factory=dict, repr=False)

    def length(self, n: int) -> torch.Tensor:
        """(batch,) int32 on ``device``, every row ``n``: made once a step
        for each length (``pos + 1``; ``min(pos + 1, slots)`` of a ring)."""
        if n not in self._lengths:
            self._lengths[n] = torch.full((self.batch,), n, dtype=torch.int32,
                                          device=self.device)
        return self._lengths[n]


@dataclasses.dataclass(frozen=True)
class SeqSplit:
    """A prefill's decode cache whose global layers split their sequence
    over the mesh axes ``axes`` (``Model.cache_seq_axes``): this rank
    holds block ``index``."""
    mesh: object
    axes: tuple
    index: int

    def block(self, S_r: int, S: int) -> tuple:
        """(first position, count) of a prompt of ``S`` positions in
        this rank's block of ``S_r``: a block that starts at or past the
        prompt holds none of it."""
        lo = self.index * S_r
        return lo, min(max(S - lo, 0), S_r)


def _heads_to_block(t, split: SeqSplit, S_r: int):
    """(..., S, h, D) of this rank's ``h`` kv heads at every prompt
    position (dim -3) -> (..., c, n h, D): every kv head at the first
    ``c = min(S, S_r)`` positions of this rank's block (zero past the
    prompt), by one tiled all-to-all over ``model`` (heads to sequence),
    counted in the ``"handoff"`` section."""
    if split.axes != ("model",):
        raise ValueError(f"kv heads split over model hand off to sequence "
                         f"blocks over model, not {split.axes}")
    S, d = t.shape[-3], t.dim() - 3
    c, n = min(S, S_r), split.mesh.axis_size("model")
    chunks = []
    for j in range(n):
        blk = t.narrow(d, min(j * S_r, S), max(min(c, S - j * S_r), 0))
        if blk.shape[d] < c:
            pad = list(blk.shape)
            pad[d] = c - blk.shape[d]
            blk = torch.cat([blk, blk.new_zeros(pad)], dim=d)
        chunks.append(blk)
    with comm.section("handoff"):
        got = comm.all_to_all(torch.stack(chunks), split.mesh, "model")
    # block i came from model rank i: its kv heads
    return torch.cat(got.unbind(0), dim=-2)


def _fill_split(cfg, cache, k, v, S: int, split: SeqSplit) -> None:
    """A global layer's prompt K/V (B, S, h, D) into this rank's block of
    a cache split along the sequence (``split``), in place: the prompt's
    positions inside the block (none where it starts past the prompt;
    the rest stays zero), every kv head the cache holds (``_heads_to_
    block`` where this rank projected a block of them), int8 codes and
    scales under ``kv_quant_int8`` (per position and head, as the unsplit
    fill quantizes them)."""
    S_r = cache["k"].shape[1]
    if S > S_r * split.mesh.axis_size(split.axes):
        raise ValueError(f"a prompt of {S} tokens does not fit the blocks "
                         f"of {S_r} over {split.axes}")
    lo, n = split.block(S_r, S)
    if k.shape[2] < cache["k"].shape[2]:
        k, v = _heads_to_block(torch.stack([k, v]), split, S_r)[:, :, :n]
    else:
        k, v = k[:, lo:lo + n], v[:, lo:lo + n]
    if cfg.kv_quant_int8:
        cache["k"][:, :n], cache["k_s"][:, :n] = L.quantize_kv(k)
        cache["v"][:, :n], cache["v_s"][:, :n] = L.quantize_kv(v)
    else:
        cache["k"][:, :n] = k.to(cache["k"].dtype)
        cache["v"][:, :n] = v.to(cache["v"].dtype)


def _ring_fill(cache, k, v, S: int, Wr: int, tp: TP | None = None) -> None:
    """Store the last ``Wr`` positions of (k, v) in ring order (slot =
    position % Wr), in place; where the ring holds every kv head and
    this rank projected a block of them, the block all-gathered over
    ``tp``'s ``model`` (in the ``"handoff"`` section)."""
    take = min(S, Wr)
    pos = torch.arange(S - take, S, device=k.device) % Wr
    k, v = k[:, S - take:], v[:, S - take:]
    if k.shape[2] < cache["k"].shape[2]:
        # the ring holds every kv head (``decode_seq_shard``), this rank
        # projected its block of them
        with comm.section("handoff"):
            k, v = comm.all_gather(torch.stack([k, v]), tp.mesh, "model",
                                   dim=3).unbind(0)
    cache["k"][:, pos] = k.to(cache["k"].dtype)
    cache["v"][:, pos] = v.to(cache["v"].dtype)


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


def _kv_select(cfg, hq: int, hkv_cache: int, tp: TP | None):
    """The cache's kv heads that this rank's ``hq`` q heads read, where
    the cache holds every kv head and the q heads split over ``model``;
    None where they are the cache's in order."""
    if tp is None or hq == cfg.n_heads or hkv_cache < cfg.n_kv_heads:
        return None
    G = cfg.n_heads // cfg.n_kv_heads
    return torch.arange(tp.i * hq, (tp.i + 1) * hq) // G


def _split_decode(cfg, q, k, v, cache, decode: DecodeStep, softcap,
                  tp: TP | None, sel):
    """Decode attention of a global layer whose cache is this rank's
    block of the sequence (``decode.seq_axes``; block ``seq_index`` of
    ``S_r`` positions): the rank whose block holds ``pos`` writes the new
    K/V there (the others leave theirs), every rank attends over its
    ``clamp(pos + 1 - index * S_r, 0, S_r)`` positions (the
    ``flash_decode`` log-sum-exp instantiation under ``"cuda"``, its
    plain version ``ref.gqa_decode_lse_ref`` under ``"torch"``), and the
    ranks' pairs merge exactly (``layers.merge_split``).  Where the sequence
    splits over ``model`` (``decode_seq_shard``) every rank attends every
    q head over its block (the q heads all-gathered over ``model``) and
    keeps its own after the merge.  The result is cast as the unsplit
    layer's (the cache's dtype, q's over an int8 cache)."""
    pos0 = decode.pos
    kc, vc = cache["k"], cache["v"]
    quant = cfg.kv_quant_int8
    S_r = kc.shape[1]
    lo = decode.seq_index * S_r
    if lo <= pos0 < lo + S_r:
        i = pos0 - lo
        if quant:
            kc[:, i], cache["k_s"][:, i] = (t[:, 0] for t in L.quantize_kv(k))
            vc[:, i], cache["v_s"][:, i] = (t[:, 0] for t in L.quantize_kv(v))
        else:
            kc[:, i] = k[:, 0].to(kc.dtype)
            vc[:, i] = v[:, 0].to(vc.dtype)
    n = min(max(pos0 + 1 - lo, 0), S_r)
    hq = q.shape[2]
    gather = (tp is not None and "model" in decode.seq_axes
              and hq < cfg.n_heads)
    if gather:
        # the kernel reads q contiguous; the gather's result is a view
        q = comm.all_gather(q, tp.mesh, "model", dim=2).contiguous()
        sel = (lambda t: t)
    scales = ({"k_scale": sel(cache["k_s"]), "v_scale": sel(cache["v_s"])}
              if quant else {})
    if decode.impl == "cuda":
        o, lse = fd_ops.gqa_decode_attention_lse(
            q, sel(kc), sel(vc), decode.length(n), max_length=n,
            softcap=softcap, **scales)
    else:
        o, lse = fd_ref.gqa_decode_lse_ref(q, sel(kc), sel(vc), n, softcap,
                                           **scales)
    o = L.merge_split(o, lse, decode.mesh, decode.seq_axes).to(
        q.dtype if quant else vc.dtype)
    return o.narrow(2, tp.i * hq, hq) if gather else o


def _tp_heads(cfg, p, tp: TP | None):
    """(``p`` with the replicated weights a split attention reads on a
    part of its heads through ``tp.rep``, the kv heads' selector): the
    selector maps the kv heads a rank holds (every one, where
    ``kv_heads`` stays replicated) to the ones its q heads read."""
    hq = p["wq"].shape[-2]
    if tp is None or hq == cfg.n_heads:
        return p, None
    p = dict(p)
    for name in ("q_norm", "k_norm"):
        if name in p:
            p[name] = tree_map(tp.rep, p[name])
    if p["wk"].shape[-2] < cfg.n_kv_heads:
        return p, None
    p["wk"], p["wv"] = tp.rep(p["wk"]), tp.rep(p["wv"])
    G = cfg.n_heads // cfg.n_kv_heads
    idx = torch.arange(tp.i * hq, (tp.i + 1) * hq,
                       device=p["wq"].device) // G
    return p, idx


def _gqa_attend(cfg, p, x, *, local: bool, positions, mode, cache, softcap,
                theta, prefix_len: int = 0, decode: DecodeStep | None = None,
                tp: TP | None = None, split: SeqSplit | None = None):
    """Causal GQA, global or over ``cfg.window`` (``local``, ring cache);
    in train and prefill every query also sees the first ``prefix_len``
    positions (the VLM's prefix-LM).  Under ``tp`` with the heads split,
    this rank's heads (``_tp_heads``), the output a partial sum.  A
    prefill into a cache whose global layers split the sequence
    (``split``) fills this rank's block (``_fill_split``).  Returns (out,
    cache); the cache is written in place."""
    S = x.shape[1]
    p, idx = _tp_heads(cfg, p, tp)

    def sel(t):          # the kv heads this rank's q heads read (dim 2)
        return t if idx is None else t.index_select(2, idx.to(t.device))
    q, k, v = L.gqa_project(p, x, cfg, positions, theta)
    W = cfg.window
    if mode == "decode":
        pos0 = decode.pos
        kc, vc = cache["k"], cache["v"]
        if kc.shape[2] > k.shape[2]:
            # the cache holds every kv head (``decode_seq_shard``), this
            # rank projects its block of them
            k = comm.all_gather(k, tp.mesh, "model", dim=2)
            v = comm.all_gather(v, tp.mesh, "model", dim=2)
        idx = _kv_select(cfg, q.shape[2], kc.shape[2], tp)
        if local:
            Wr = kc.shape[1]
            slot = pos0 % Wr
            kc[:, slot] = k[:, 0].to(kc.dtype)
            vc[:, slot] = v[:, 0].to(vc.dtype)
            n = min(pos0 + 1, Wr)
            if decode.impl == "cuda":
                o = fd_ops.gqa_decode_attention(q, sel(kc), sel(vc),
                                                decode.length(n),
                                                max_length=n, softcap=softcap)
            else:
                o = _ring_decode(q, sel(kc), sel(vc), pos0, Wr, softcap)
            return L.gqa_out(p, o, x.dtype), cache
        if decode.seq_axes:
            o = _split_decode(cfg, q, k, v, cache, decode, softcap, tp, sel)
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
                    q, sel(kc), sel(vc), decode.length(pos0 + 1),
                    max_length=pos0 + 1, softcap=softcap, k_scale=sel(ksc),
                    v_scale=sel(vsc))
            else:
                o = L.decode_attention_quant(q, sel(kc), sel(vc), sel(ksc),
                                             sel(vsc), length=pos0 + 1,
                                             softcap=softcap)
            return L.gqa_out(p, o, x.dtype), cache
        kc[:, pos0] = k[:, 0].to(kc.dtype)
        vc[:, pos0] = v[:, 0].to(vc.dtype)
        if decode.impl == "cuda":
            o = fd_ops.gqa_decode_attention(q, sel(kc), sel(vc),
                                            decode.length(pos0 + 1),
                                            max_length=pos0 + 1,
                                            softcap=softcap)
        else:
            o = L.decode_attention(q, sel(kc), sel(vc), length=pos0 + 1,
                                   softcap=softcap)
        return L.gqa_out(p, o, x.dtype), cache

    # train / prefill
    ka, va = sel(k), sel(v)
    if local and W is not None and S > W:
        o = L.local_attention(q, ka, va, window=W, softcap=softcap)
    elif S <= 1024:
        o = L.dense_attention(q, ka, va, causal=True,
                              window=W if local else None, softcap=softcap,
                              prefix_len=prefix_len)
    elif cfg.flash_attention and softcap is None and prefix_len == 0:
        o = flash_attention(q, ka, va, True, cfg.block_q, cfg.block_k)
    else:
        o = L.blockwise_attention(q, ka, va, causal=True, softcap=softcap,
                                  prefix_len=prefix_len, block_q=cfg.block_q,
                                  block_k=cfg.block_k)
    if cache is not None:
        if local:
            _ring_fill(cache, k, v, S, cache["k"].shape[1], tp)
        elif split is not None:
            _fill_split(cfg, cache, k, v, S, split)
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


def _enter(cfg, tp: TP | None, norm_p, x, split: bool):
    """A sub-layer's normed input: plain without ``tp``, else through
    ``tp.enter`` (the block split over ``model`` or not)."""
    if tp is None:
        return _norm_apply(cfg, norm_p, x)
    return tp.enter(tp.norm(cfg, norm_p, x), split)


def _leave(tp: TP | None, o, split: bool):
    return o if tp is None else tp.leave(o, split)


def _latent_cols(c, cache_c, tp: TP | None):
    """This rank's columns of a whole latent ``c`` where the cache holds
    its block of ``mla_latent``."""
    if tp is None or c.shape[-1] == cache_c.shape[-1]:
        return c
    return tp.cols(c)


def _write_state(cache, new) -> None:
    """Copy a recurrent state's new leaves into the cache tree in place."""
    for key, val in new.items():
        if isinstance(val, dict):
            _write_state(cache[key], val)
        else:
            cache[key].copy_(val)


def _proj_nopos(p, x):
    """q, k, v projections without positions (the encoder's and the
    cross-attention's)."""
    return L._project(x, p["wq"]), L._project(x, p["wk"]), L._project(x, p["wv"])


def _cross_attend(p, h, *, mode, cache, enc_out):
    """The decoder's cross-attention of ``h`` over the encoder's output:
    its keys and values from ``enc_out`` in train, and in a prefill that
    has it (then written into the cache's ``xk``/``xv``, which hold
    ``cfg.enc_len`` positions: an output of another length raises); from
    the cache otherwise.  Returns the attention's output (B, S, Hq, D)."""
    q = L._project(h, p["wq"])
    if mode == "train" or (mode == "prefill" and enc_out is not None):
        xk, xv = L._project(enc_out, p["wk"]), L._project(enc_out, p["wv"])
        if cache is not None:
            if xk.shape[1] != cache["xk"].shape[1]:
                raise ValueError(f"an encoder output of {xk.shape[1]} "
                                 f"positions for a cross cache of "
                                 f"{cache['xk'].shape[1]} (cfg.enc_len)")
            cache["xk"].copy_(xk)
            cache["xv"].copy_(xv)
    else:
        xk, xv = cache["xk"].to(h.dtype), cache["xv"].to(h.dtype)
    return L.dense_attention(q, xk, xv, causal=False)


def _apply_layer(cfg, kind, p, x, *, positions, mode, cache,
                 decode: DecodeStep | None = None, shared_params=None,
                 mesh=None, prefix_len: int = 0, enc_out=None,
                 tp: TP | None = None, seq: SeqSplit | None = None):
    """One sub-layer of a kind of ``SUPPORTED_KINDS`` (``check_supported``
    has vetted the config); a local layer takes ``rope_theta_local``
    where the config sets one, a shared block ``shared_params``, a MoE
    FFN ``mesh`` (the reference's ``models/transformer.py:419``), a
    global or shared GQA layer ``prefix_len`` (the VLM's prefix-LM) and a
    decoder layer ``enc_out`` (the encoder's output); under ``tp`` the
    GQA mixers and the MLP run tensor-parallel on their weights' blocks
    (the module docstring).  The cache (KV, latent or recurrent state) is
    written in place; a prefill fills this rank's block of a cache split
    along the sequence (``seq``).  Returns (x, cache)."""
    mixer, ffn = kind
    if mixer == "shared_gqa":
        p = shared_params  # single copy, reused every period
    if mixer in ("gqa_g", "gqa_l", "shared_gqa"):
        local = mixer == "gqa_l"
        theta = cfg.rope_theta
        if local and cfg.rope_theta_local is not None:
            theta = cfg.rope_theta_local
        post = cfg.post_norm and mixer != "shared_gqa"
        split = p["attn"]["wq"].shape[-2] < cfg.n_heads
        if tp is None:
            h = _norm_apply(cfg, p["ln1"], x)
        else:
            h = tp.enter(tp.norm(cfg, p["ln1"], x), split)
        o, cache = _gqa_attend(cfg, _tp_block(tp, p["attn"], split), h,
                               local=local,
                               positions=positions, mode=mode, cache=cache,
                               softcap=cfg.logit_softcap, theta=theta,
                               prefix_len=prefix_len, decode=decode, tp=tp,
                               split=seq)
        if tp is not None:
            o = tp.leave(o, split)
            if post:
                o = tp.norm(cfg, p["ln1_post"], o)
        elif post:
            o = _norm_apply(cfg, p["ln1_post"], o)
        x = x + o
    elif mixer == "enc_attn":
        pa = p["attn"]
        split = pa["wq"].shape[-2] < cfg.n_heads
        if tp is None:
            h, idx = _norm_apply(cfg, p["ln1"], x), None
        else:
            h = tp.enter(tp.norm(cfg, p["ln1"], x), split)
            pa, idx = _tp_heads(cfg, _tp_block(tp, pa, split), tp)
        q, k, v = _proj_nopos(pa, h)
        if idx is not None:
            k, v = (t.index_select(2, idx.to(t.device)) for t in (k, v))
        o = (L.dense_attention(q, k, v, causal=False) if h.shape[1] <= 1024
             else L.blockwise_attention(q, k, v, causal=False,
                                        block_q=cfg.block_q,
                                        block_k=cfg.block_k))
        o = L.gqa_out(pa, o, x.dtype)
        x = x + (o if tp is None else tp.leave(o, split))
        cache = None
    elif mixer == "dec_attn":
        h = _norm_apply(cfg, p["ln1"], x)
        o, _ = _gqa_attend(cfg, p["attn"], h, local=False, positions=positions,
                           mode=mode, cache=None if cache is None else
                           {"k": cache["k"], "v": cache["v"]},
                           softcap=None, theta=cfg.rope_theta, decode=decode)
        x = x + o
        h = _norm_apply(cfg, p["lnx"], x)
        o = _cross_attend(p["cross"], h, mode=mode, cache=cache,
                          enc_out=enc_out)
        x = x + L.gqa_out(p["cross"], o, x.dtype)
    elif mixer == "mla":
        split = tp is not None and p["attn"]["wkv_b"].shape[-2] < cfg.n_heads
        h = _enter(cfg, tp, p["ln1"], x, split)
        pa = MLA.tp_params(_tp_block(tp, p["attn"], split),
                           tp if split else None)
        if mode == "decode":
            pos0 = decode.pos
            c_new, pe_new = MLA.mla_prefill_cache(pa, h, cfg, positions, tp)
            c_new = _latent_cols(c_new[:, 0], cache["c"], tp)
            if decode.seq_axes:
                o = MLA.mla_decode_split(pa, h, cfg, cache["c"], cache["pe"],
                                         c_new, pe_new[:, 0], decode, tp=tp)
            else:
                cache["c"][:, pos0] = c_new.to(cache["c"].dtype)
                cache["pe"][:, pos0] = pe_new[:, 0].to(cache["pe"].dtype)
                o = MLA.mla_decode(pa, h, cfg, cache["c"], cache["pe"],
                                   length=pos0, tp=tp)
        else:
            o = MLA.mla_train(pa, h, cfg, positions, tp)
            if cache is not None:
                S, S_r = h.shape[1], cache["c"].shape[1]
                lo, n = (0, S) if seq is None else seq.block(S_r, S)
                if S > (S_r if seq is None else
                        S_r * seq.mesh.axis_size(seq.axes)):
                    raise ValueError(f"a prompt of {S} tokens does not fit "
                                     f"a cache of {S_r} a block")
                c_new, pe_new = MLA.mla_prefill_cache(pa, h, cfg, positions,
                                                      tp)
                # this rank's positions (its block where the sequence
                # splits: every latent column of them there)
                cache["c"][:, :n] = _latent_cols(
                    c_new[:, lo:lo + n], cache["c"], tp).to(cache["c"].dtype)
                cache["pe"][:, :n] = pe_new[:, lo:lo + n].to(
                    cache["pe"].dtype)
        x = x + _leave(tp, o, split)
    elif mixer == "mamba":
        split = tp is not None and p["mixer"]["w_in"].shape[-1] < (
            2 * cfg.d_inner + 2 * cfg.ssm_state + cfg.ssm_nheads)
        h = _enter(cfg, tp, p["ln1"], x, split)
        o, st = SSM.mamba2_apply(_tp_block(tp, p["mixer"], split), h, cfg,
                                 cache, tp if split else None)
        if cache is not None:
            _write_state(cache, st)
        return x + _leave(tp, o, split), cache
    elif mixer == "rwkv6":
        split = tp is not None and p["mixer"]["wr"].shape[-1] < cfg.d_model
        h = _enter(cfg, tp, p["ln1"], x, split)
        o, st = RWKV.rwkv6_time_mix(_tp_block(tp, p["mixer"], split), h, cfg,
                                    None if cache is None else cache["time"],
                                    tp if split else None)
        x = x + _leave(tp, o, split)
        split = tp is not None and p["ffn"]["wk"].shape[-1] < cfg.d_ff
        h = _enter(cfg, tp, p["ln2"], x, split)
        o2, st2 = RWKV.rwkv6_channel_mix(
            _tp_block(tp, p["ffn"], split), h, cfg,
            None if cache is None else cache["channel"],
            tp if split else None)
        if cache is not None:
            _write_state(cache, {"time": st, "channel": st2})
        if tp is not None and split:
            return x + tp.leave_whole(o2), cache
        return x + _leave(tp, o2, False), cache
    else:
        raise ValueError(mixer)

    # ffn half (as in the reference, a post-norm follows the MLP only)
    post = cfg.post_norm and mixer != "shared_gqa"
    if ffn == "mlp" and tp is not None:
        split = p["mlp"]["w1"].shape[-1] < cfg.d_ff
        h = tp.enter(tp.norm(cfg, p["ln2"], x), split)
        o = tp.leave(mlp_apply(cfg, _tp_block(tp, p["mlp"], split), h),
                     split)
        if post:
            o = tp.norm(cfg, p["ln2_post"], o)
        return x + o, cache
    if ffn == "moe" and tp is not None:
        h = tp.norm(cfg, p["ln2"], x)
        return x + MOE.moe_block_tp(p["moe"], h, cfg, tp.mesh, tp.seq), cache
    h = _norm_apply(cfg, p["ln2"], x)
    if ffn == "moe":
        B, S, D = h.shape
        return x + MOE.moe_apply(p["moe"], h.reshape(B * S, D), cfg,
                                 mesh).reshape(B, S, D), cache
    o = mlp_apply(cfg, p["mlp"], h)
    if post:
        o = _norm_apply(cfg, p["ln2_post"], o)
    return x + o, cache
