"""The port's side of the mesh parity tests: functions each rank of a
``repro_torch.launch.mesh.launch`` runs (spawned processes import this
module by name; it imports no jax).  Each reads the reference's ``.npz``
(``tests/_mesh_reference.py``) and returns numpy arrays to the test."""
import dataclasses

import numpy as np
import torch

from repro_torch.common import comm
from repro_torch.common.pytree import flatten_with_paths, unflatten_like
from repro_torch.common.sharding import (MeshRules, P, flatten_specs,
                                         gather_full, local_shard)
from repro_torch.configs import smoke_config
from repro_torch.configs.base import TrainConfig
from repro_torch.launch.mesh import make_mesh

TCFG = dict(learning_rate=1e-2, warmup_steps=2, total_steps=10)
DLRM_CASES = {"data4": ((4,), ("data",), {"expert": ("data",)}),
              "data2_model2": ((2, 2), ("data", "model"), None)}
DLRM_BATCH = 16
LM_BATCH, LM_SEQ = 4, 32
STEPS = 3
# the dry run's smoke cells: small shapes on (data=4, model=2); the
# first train cell accumulates 2 microbatches (the reference's rule:
# 16 rows a microbatch on this mesh), the second takes its 16 rows whole
DRYRUN_MESH = (4, 2)
DRYRUN_SHAPES = {
    "smoke_train": dict(seq_len=128, global_batch=32, kind="train"),
    "smoke_train1": dict(seq_len=128, global_batch=16, kind="train"),
    "smoke_prefill": dict(seq_len=256, global_batch=8, kind="prefill"),
    "smoke_decode": dict(seq_len=256, global_batch=16, kind="decode",
                         cache_shard="batch")}
DRYRUN_CELLS = tuple((a, s) for a in ("tinyllama-1.1b", "gemma2-9b")
                     for s in DRYRUN_SHAPES
                     if (a, s) != ("gemma2-9b", "smoke_decode"))
# a decode cache split along the sequence: 256 positions on (data=4,
# model=2), 8 steps from 124: the blocks of 64 (over data) and of 128 (over
# model) both cross a boundary at 128, and the last blocks hold no
# position yet (local length 0)
SEQ_CACHE = {"S": 256, "pos0": 124, "steps": 8, "mesh": (4, 2)}
SEQ_CACHE_ARCHS = ("gemma2-9b", "zamba2-1.2b")
# layout -> (batch, cache_shard, decode_seq_shard)
SEQ_LAYOUTS = {"seq": (1, "seq", False), "seqshard": (4, "batch", True)}
# a prefill into a cache split along the sequence on SEQ_CACHE's mesh,
# then decode: prompts of 60 tokens (past Gemma-2's smoke window of 32:
# its rings wrap) end inside the first block of 64 (max_len 256 over
# data under "seq", 128 over model under "seqshard"), 8 steps cross into
# the second; the blocks past it stay empty
SEQ_PREFILL = {"P": 60, "steps": 8, "max_len": {"seq": 256, "seqshard": 128}}
SEQ_PREFILL_ARCHS = ("gemma2-9b", "zamba2-1.2b", "deepseek-v2-236b")
# the model axis of the other families: (name, arch, config overrides),
# each a ZeRO-1 step on (data=2, model=2) with and without seq_parallel
FAMILY_CASES = {
    "zamba2": ("zamba2-1.2b", {}),
    "rwkv6": ("rwkv6-3b", {}),
    # one head of 64 on model = 2: each rank's 32 columns cut through it
    # (RWKV-6-3B's 40 heads on 16 ranks are 2.5 heads a rank)
    "rwkv6_h1": ("rwkv6-3b", {"n_heads": 1}),
    "deepseek_ep": ("deepseek-v2-236b", {"moe_impl": "ep_a2a"}),
    "deepseek_tp": ("deepseek-v2-236b", {"moe_impl": "tp"}),
    "whisper": ("whisper-base", {}),
}


# DeepSeek-V2's decode with the latent cache split over model: prefill of
# S tokens a row, then the steps
MLA_DECODE = {"B": 4, "S": 24, "steps": 8}


def mla_decode_tokens(vocab: int) -> np.ndarray:
    return np.random.default_rng(19).integers(
        0, vocab, (MLA_DECODE["B"], MLA_DECODE["S"] + MLA_DECODE["steps"]),
        dtype=np.int32)


def family_batch(cfg, step: int) -> dict:
    """A family step's global batch: ``lm_batch``'s tokens, and for an
    encoder-decoder seeded frames (B, S, d_model)."""
    from repro_torch.data import lm_batch
    b = dict(lm_batch(0, step, LM_BATCH, LM_SEQ, cfg.vocab))
    if cfg.enc_dec:
        b["frames"] = np.random.default_rng(100 + step).standard_normal(
            (LM_BATCH, LM_SEQ, cfg.d_model)).astype(np.float32)
    return b


def seq_cache_numpy(shapes: dict, pos0: int, seed: int = 13) -> dict:
    """A seeded decode cache as float32 numpy arrays, {dot.path: array}
    for ``shapes`` ({dot.path: shape} of a cache's layers, either
    package's names): a global layer's K/V and MLA's latent ``c`` and
    rope key ``pe`` (the sequence dim ``SEQ_CACHE["S"]`` long) N(0, 1)
    below ``pos0`` and zero from it, a ring's every slot N(0, 1), a
    recurrent state 0.5 N(0, 1); leaves drawn in name order."""
    rng = np.random.default_rng(seed)
    out = {}
    for name in sorted(shapes):
        shape = tuple(shapes[name])
        x = rng.standard_normal(shape).astype(np.float32)
        leaf = name.rsplit(".", 1)[-1]
        if leaf in ("k", "v", "c", "pe") and shape[2] == SEQ_CACHE["S"]:
            x[:, :, pos0:] = 0
        elif leaf not in ("k", "v"):
            x *= np.float32(0.5)
        out[name] = x
    return out


def seq_prefill_tokens(vocab: int) -> np.ndarray:
    """(4, P + steps) int32 tokens of ``SEQ_PREFILL``: the prompts, then
    each step's token (the "seq" layout's one row is row 0)."""
    return np.random.default_rng(31).integers(
        0, vocab, (4, SEQ_PREFILL["P"] + SEQ_PREFILL["steps"]),
        dtype=np.int32)


def seq_cache_tokens(vocab: int, batch: int) -> np.ndarray:
    """(steps, batch, 1) int32 tokens of the ``seq_cache`` steps."""
    return np.random.default_rng(17).integers(
        0, vocab, (SEQ_CACHE["steps"], batch, 1), dtype=np.int32)


def _setup():
    torch.set_num_threads(1)


def blocks(tree, specs, mesh):
    """This rank's blocks of a tree of whole tensors."""
    leaves = [x for _, x in flatten_with_paths(tree)]
    return unflatten_like(tree, [local_shard(x, sp, mesh).clone() for x, (
        _, sp) in zip(leaves, flatten_specs(specs))])


def gathered(tree, specs, mesh) -> dict:
    """{dot.path: whole array} of a tree of this rank's blocks."""
    return {n: gather_full(x, sp, mesh).float().numpy() for (n, x), (_, sp)
            in zip(flatten_with_paths(tree), flatten_specs(specs))}


def dlrm_torch(tree: dict) -> dict:
    """A numpy DLRM tree (tables as bf16 bit patterns) as tensors."""
    def one(a):
        if a.dtype == np.uint16:
            return torch.from_numpy(a.view(np.int16).copy()).view(
                torch.bfloat16)
        return torch.from_numpy(np.array(a))
    return {k: ({n: one(v) for n, v in x.items()} if isinstance(x, dict)
                else one(x)) for k, x in tree.items()}


def _dlrm_tree(d: dict, prefix: str = "w.") -> dict:
    tree = {"bot": {}, "top": {}}
    for k in d.files:
        if not k.startswith(prefix):
            continue
        parts = k[len(prefix):].split(".")
        if len(parts) == 1:
            tree[parts[0]] = d[k]
        else:
            tree[parts[0]][parts[1]] = d[k]
    return dlrm_torch(tree)


def _port_dlrm_cfg():
    return smoke_config("dlrm")


# ---------------------------------------------------------------------------

def moe_rank(rank, npz, moe_chunks=1):
    """Each (impl, mesh) case of ``moe.npz`` (``moe_chunks.npz``) on this
    rank's tokens and expert blocks, the tokens in ``moe_chunks`` chunks:
    {case: (its rows' output, dropped slots)}."""
    _setup()
    from repro_torch.models import moe as MOE
    d = np.load(npz)
    x = torch.from_numpy(d["x"])
    p = {k[2:]: torch.from_numpy(d[k]) for k in d.files
         if k.startswith("p.") and not k.startswith("p.shared.")}
    shared = {k[len("p.shared."):]: torch.from_numpy(d[k]) for k in d.files
              if k.startswith("p.shared.")}
    base = dataclasses.replace(smoke_config("deepseek-v2-236b"),
                               moe_chunks=moe_chunks)
    out = {}
    for shape, impl in (((4, 1), "ep_a2a"), ((2, 2), "ep_a2a"),
                        ((2, 2), "tp")):
        cfg = dataclasses.replace(base, moe_impl=impl)
        mesh = make_mesh(shape, ("data", "model"))
        local = {"router": p["router"], "shared": shared}
        for k in ("w1", "w3", "w2"):
            local[k] = local_shard(p[k], P(*MOE.BODY_SPECS[impl][k]),
                                   mesh).clone()
        with MOE.count_dropped() as dropped:
            y = MOE.moe_apply(local, local_shard(x, P("data"), mesh).clone(),
                              cfg, mesh)
        out[f"{impl}_{shape[0]}x{shape[1]}"] = (
            y.numpy(), int(dropped), mesh.axis_index("data"))
    return out


# ---------------------------------------------------------------------------

def dlrm_rank(rank, npz, case, zero1_grads):
    """The smoke DLRM's mesh step on ``case``'s mesh, 3 steps: losses,
    gradient norms, the final parameters gathered, the kernel-free bags'
    byte counters."""
    _setup()
    from repro_torch.data import dlrm_batch
    from repro_torch.models import DLRM
    from repro_torch.train.train_step import (init_train_state,
                                              make_train_step, mesh_layout)
    d = np.load(npz)
    cfg = _port_dlrm_cfg()
    shape, axes, overrides = DLRM_CASES[case]
    mesh = make_mesh(shape, axes)
    tree = _dlrm_tree(d)
    full = DLRM(cfg, device="cpu", params=tree)
    specs = full.param_specs(MeshRules.create(mesh, overrides))
    model = DLRM(cfg, device="cpu", params=blocks(tree, specs, mesh),
                 mesh=mesh, rules_overrides=overrides)
    tcfg = TrainConfig(**TCFG)
    grad_specs = (mesh_layout(model, tcfg).moments if zero1_grads else None)
    params, opt = init_train_state(model, None, tcfg, grad_specs)
    step = make_train_step(model, tcfg, grad_specs)
    losses, norms, counts = [], [], []
    for i in range(STEPS):
        comm.reset_counters()
        params, opt, m = step(params, opt, dlrm_batch(0, i, DLRM_BATCH, cfg))
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        counts.append(comm.counters())
    whole = gathered(params, specs, mesh)
    return {"losses": losses, "norms": norms, "params": whole,
            "counters": counts, "specs": dict(flatten_specs(specs))}


# ---------------------------------------------------------------------------

def lm_loss_mask(step: int) -> np.ndarray:
    """The seeded ``loss_mask`` (LM_BATCH, LM_SEQ) float32 of step
    ``step``: each row keeps its positions with its own probability
    (0.9, 0.15, 0.6, 0.35), so the data ranks' and microbatches' shares
    of the kept positions differ."""
    rng = np.random.default_rng(41 + step)
    keep = np.asarray([0.9, 0.15, 0.6, 0.35])[:, None]
    return (rng.random((LM_BATCH, LM_SEQ)) < keep).astype(np.float32)


def lm_rank(rank, npz, microbatch, seq_parallel=False, masked=False):
    """The smoke TinyLlama's ZeRO-1 step on (data=2, model=2), float32
    activations, 3 steps (``seq_parallel`` as given; with ``masked``
    each batch carries ``lm_loss_mask``): losses, norms, the final tree
    gathered, each step's collective counters and step 1's dot FLOPs on
    this rank (``FlopCounterMode``)."""
    _setup()
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.data import lm_batch
    from repro_torch.models import Model
    from repro_torch.train.train_step import (init_mesh_opt_state,
                                              make_train_step, mesh_layout)
    d = np.load(npz)
    cfg = dataclasses.replace(smoke_config("tinyllama-1.1b"),
                              seq_parallel=seq_parallel)
    mesh = make_mesh((2, 2), ("data", "model"))
    model = Model(cfg, device="cpu", mesh=mesh)
    model.compute_dtype = torch.float32
    defs = model.param_defs()
    tree = unflatten_like(defs, [torch.from_numpy(d["w." + n]) for n, _ in
                                 flatten_with_paths(defs)])
    specs = model.param_specs()
    tcfg = TrainConfig(microbatch=microbatch, **TCFG)
    layout = mesh_layout(model, tcfg)
    params = blocks(tree, specs, mesh)
    opt = init_mesh_opt_state(params, layout, keep_master=False)
    step = make_train_step(model, tcfg, layout.moments)
    losses, norms, counts, flops = [], [], [], None
    for i in range(STEPS):
        comm.reset_counters()
        batch = dict(lm_batch(0, i, LM_BATCH, LM_SEQ, cfg.vocab))
        if masked:
            batch["loss_mask"] = lm_loss_mask(i)
        with FlopCounterMode(display=False) as fc:
            params, opt, m = step(params, opt, batch)
        flops = fc.get_total_flops() if flops is None else flops
        counts.append(comm.counters())
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return {"losses": losses, "norms": norms,
            "params": gathered(params, specs, mesh), "counters": counts,
            "flops": flops}


# ---------------------------------------------------------------------------

def gpipe_rank(rank, npz):
    _setup()
    from repro_torch.train.pipeline import gpipe
    d = np.load(npz)
    mesh = make_mesh((4,), ("stage",))
    w = torch.from_numpy(d["w"])
    comm.reset_counters()
    y = gpipe(lambda wi, h: torch.tanh(h @ wi),
              local_shard(w, P("stage"), mesh).clone(),
              torch.from_numpy(d["x"]), mesh)
    return y.numpy(), comm.counters()


# ---------------------------------------------------------------------------

def dlrm_state(mesh, overrides, seed=9):
    """The smoke DLRM's params and an AdamW state (moments 0.5 and 0.25,
    count 7), whole, with their specs (``_mesh_reference.dlrm_state``)."""
    import sys
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke
    from repro_torch.models.dlrm import param_defs, param_shapes
    from repro_torch.train.optimizer import opt_state_specs
    cfg = _port_dlrm_cfg()
    shapes = {k: (v[0] if not isinstance(v, dict) else
                  {n: lv[0] for n, lv in v.items()})
              for k, v in param_shapes(cfg).items()}
    params = dlrm_torch(chip_smoke.dlrm_numpy_params(shapes, seed))
    from repro_torch.common.pytree import tree_map
    opt = {"mu": tree_map(lambda x: torch.full(x.shape, 0.5), params),
           "nu": tree_map(lambda x: torch.full(x.shape, 0.25), params),
           "count": torch.tensor(7, dtype=torch.int32)}
    specs = param_specs_of(cfg, mesh, overrides)
    o_specs = opt_state_specs(specs, param_defs(cfg), mesh, zero1=True,
                              keep_master=False)
    return (params, opt), (specs, o_specs)


def param_specs_of(cfg, mesh, overrides):
    from repro_torch.models.dlrm import param_specs
    return param_specs(cfg, MeshRules.create(mesh, overrides))


def ckpt_rank(rank, out_dir):
    """Save the state on (data=4), restore it onto (data=2, model=2);
    restore the reference's checkpoint onto (data=2, model=2); reshard
    whole arrays and (data=4) blocks onto (data=2, model=2)."""
    _setup()
    from repro_torch.checkpoint import restore, save
    from repro_torch.ft.fault_tolerance import reshard
    m4 = make_mesh((4,), ("data",))
    whole, specs4 = dlrm_state(m4, {"expert": ("data",)})
    mine = blocks(whole, specs4, m4)
    save(f"{out_dir}/port_ckpt", 5, mine, specs4,
         extra_meta={"next_step": 5}, mesh=m4)
    m22 = make_mesh((2, 2), ("data", "model"))
    _, specs22 = dlrm_state(m22, None)
    got, meta = restore(f"{out_dir}/port_ckpt", 5, mine, mesh=m22,
                        specs=specs22)
    ref, ref_meta = restore(f"{out_dir}/ref_ckpt", 7, mine, mesh=m22,
                            specs=specs22)
    want = blocks(whole, specs22, m22)
    from_whole = reshard(whole, m22, specs22)
    from_blocks = reshard(mine, m22, specs22, old_mesh=m4, old_specs=specs4)

    def np_tree(t):
        return {n: x.float().numpy() for n, x in flatten_with_paths(t)}
    return {"restored": np_tree(got), "want": np_tree(want),
            "ref_restored": np_tree(ref), "meta": meta, "ref_meta": ref_meta,
            "dtypes": {n: str(x.dtype) for n, x in flatten_with_paths(got)},
            "reshard_whole": np_tree(from_whole),
            "reshard_blocks": np_tree(from_blocks),
            "index22": m22.coords()}


def runner_rank(rank, ckpt_dir, fail_at):
    """The smoke DLRM on (data=2) through ``TrainRunner`` with a mesh
    step: 4 steps, a checkpoint every 2, a failure injected at
    ``fail_at`` (none when negative).  Returns the log and the final
    parameters gathered."""
    _setup()
    from repro_torch.data import dlrm_batch
    from repro_torch.ft.fault_tolerance import (FailureInjector,
                                                RunnerConfig, TrainRunner)
    from repro_torch.models import DLRM
    from repro_torch.train.optimizer import opt_state_specs
    from repro_torch.train.train_step import init_train_state, make_train_step
    cfg = _port_dlrm_cfg()
    mesh = make_mesh((2,), ("data",))
    ov = {"expert": ("data",)}
    full = DLRM(cfg, device="cpu", seed=3)
    specs = full.param_specs(MeshRules.create(mesh, ov))
    model = DLRM(cfg, device="cpu", params=blocks(full.param_tree(), specs,
                                                   mesh),
                 mesh=mesh, rules_overrides=ov)
    tcfg = TrainConfig(**TCFG)
    params, opt = init_train_state(model, None, tcfg)
    from repro_torch.models.dlrm import param_defs
    o_specs = opt_state_specs(specs, param_defs(cfg), mesh, zero1=True,
                              keep_master=False)
    runner = TrainRunner(
        RunnerConfig(ckpt_dir=ckpt_dir, checkpoint_every=2),
        make_train_step(model, tcfg), lambda s: dlrm_batch(1, s, 8, cfg),
        injector=FailureInjector(() if fail_at < 0 else (fail_at,)),
        mesh=mesh, specs=(specs, o_specs))
    params, opt = runner.run(params, opt, 4)
    return {"restarts": runner.restarts,
            "losses": [r["loss"] for r in runner.metrics_log],
            "params": gathered(params, specs, mesh)}


def dlrm_two_rank_step(rank):
    """One mesh step of the smoke DLRM on (data=2), tables over data: the
    loss and the gradient norm (the isolation test's run)."""
    _setup()
    from repro_torch.data import dlrm_batch
    from repro_torch.models import DLRM
    from repro_torch.train.train_step import init_train_state, make_train_step
    cfg = _port_dlrm_cfg()
    mesh = make_mesh((2,), ("data",))
    ov = {"expert": ("data",)}
    full = DLRM(cfg, device="cpu", seed=0)
    specs = full.param_specs(MeshRules.create(mesh, ov))
    model = DLRM(cfg, device="cpu", params=blocks(full.param_tree(), specs,
                                                   mesh),
                 mesh=mesh, rules_overrides=ov)
    tcfg = TrainConfig(**TCFG)
    params, opt = init_train_state(model, None, tcfg)
    _, _, m = make_train_step(model, tcfg)(params, opt,
                                           dlrm_batch(0, 0, 8, cfg))
    return float(m["loss"]), float(m["grad_norm"])


# ---------------------------------------------------------------------------

def counted_lm_step(rank, seq_parallel, microbatch):
    """One ZeRO-1 step of the smoke TinyLlama (drawn weights) on (data=2,
    model=2): this rank's collective counters."""
    _setup()
    from repro_torch.data import lm_batch
    from repro_torch.models import Model
    from repro_torch.train.train_step import (init_mesh_opt_state,
                                              make_train_step, mesh_layout)
    cfg = dataclasses.replace(smoke_config("tinyllama-1.1b"),
                              seq_parallel=seq_parallel)
    mesh = make_mesh((2, 2), ("data", "model"))
    model = Model(cfg, device="cpu", mesh=mesh)
    tcfg = TrainConfig(microbatch=microbatch, **TCFG)
    layout = mesh_layout(model, tcfg)
    params = blocks(model.init(torch.Generator().manual_seed(0)),
                    model.param_specs(), mesh)
    opt = init_mesh_opt_state(params, layout, keep_master=False)
    step = make_train_step(model, tcfg, layout.moments)
    comm.reset_counters()
    step(params, opt, lm_batch(0, 0, LM_BATCH, LM_SEQ, cfg.vocab))
    return comm.counters()


# ---------------------------------------------------------------------------

def _seq_model(d, arch: str, lay: str, mesh, name: str, max_len: int,
               split: bool = True):
    """(model, this rank's blocks of ``name``'s weights in ``d``, the
    shape cell of ``lay`` with a cache of ``max_len``, this rank's rows)
    of a sequence-split case: the smoke ``arch`` under ``lay``'s
    ``decode_seq_shard``, float32 activations, on ``mesh``; without
    ``split``, the same rows over the batch cell's cache (the sequence
    whole on every rank)."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.common.sharding import shard_slices
    from repro_torch.models import Model
    B, shard_kind, seq_model = SEQ_LAYOUTS[lay]
    if not split:
        shard_kind, seq_model = "batch", False
    cfg = dataclasses.replace(smoke_config(arch), decode_seq_shard=seq_model)
    model = Model(cfg, device="cpu", mesh=mesh)
    model.compute_dtype = torch.float32
    defs = model.param_defs()
    tree = unflatten_like(defs, [torch.from_numpy(d[f"{name}.w.{n}"])
                                 for n, _ in flatten_with_paths(defs)])
    shape = ShapeConfig("seq_cache", seq_len=max_len, global_batch=B,
                        kind="decode", cache_shard=shard_kind)
    rows = shard_slices((B, 1), model.batch_pspecs(shape)["tokens"],
                        mesh)[0]
    return model, blocks(tree, model.param_specs(), mesh), shape, rows


def _seq_cache_case(d, arch: str, lay: str, mesh) -> dict:
    """One (arch, layout) case of ``_mesh_reference.py seq_cache`` on this
    rank: the seeded cache's blocks (``model_api.cache_read_spec``), 8
    decode steps under ``decode_impl="torch"``."""
    from repro_torch.models.model_api import cache_read_spec
    S, pos0 = SEQ_CACHE["S"], SEQ_CACHE["pos0"]
    name = f"{arch}.{lay}"
    model, params, shape, rows = _seq_model(d, arch, lay, mesh, name, S)
    B = shape.global_batch
    cdefs = model.cache_defs(B, S)["layers"]
    named = flatten_with_paths(cdefs)
    whole = seq_cache_numpy({n: c.shape for n, c in named}, pos0)
    specs = dict(flatten_specs(model.batch_pspecs(shape)["cache"]["layers"]))
    layers = unflatten_like(cdefs, [local_shard(
        torch.from_numpy(whole[n]).to(c.dtype),
        cache_read_spec(c, specs[n]), mesh).clone() for n, c in named])
    cache = {"layers": layers, "pos": pos0,
             "seq": model.cache_seq_axes(shape)}
    logits, counts = [], []
    for t in seq_cache_tokens(model.cfg.vocab, B):
        comm.reset_counters()
        lg, cache = model.decode_step(params, cache, t[rows],
                                      decode_impl="torch")
        counts.append(comm.counters())
        logits.append(lg.float().numpy())
    return {"rows": (rows.start, rows.stop), "logits": np.stack(logits),
            "counters": counts[0], "seq": cache["seq"],
            "gathered": model.gathered_leaves()}


def seq_cache_rank(rank, npz):
    """``_mesh_reference.py seq_cache``'s steps on (data=4, model=2): each
    arch and layout from the same weights and seeded cache
    (``_seq_cache_case``): {name: this rank's rows, their logits (steps,
    rows, V) and step 1's collective counters}."""
    _setup()
    d = np.load(npz)
    mesh = make_mesh(SEQ_CACHE["mesh"], ("data", "model"))
    return {f"{arch}.{lay}": _seq_cache_case(d, arch, lay, mesh)
            for arch in SEQ_CACHE_ARCHS for lay in SEQ_LAYOUTS}


def decode_attention_f32(q, k_cache, v_cache, *, length, window=None,
                         softcap=None):
    """``layers.decode_attention`` with p kept in float32 through p.V (the
    output cast to the cache's dtype), as the sequence-split path's pair
    keeps it (``transformer._split_decode``); the layer rounds p to the
    cache's bf16 first, as the reference does."""
    from repro_torch.models import layers as L
    B, _, Hq, D = q.shape
    Hkv = k_cache.shape[2]
    k, v = k_cache[:, :length], v_cache[:, :length]
    s = L._scores(q.reshape(B, Hkv, Hq // Hkv, D), k,
                  "bhgd,bkhd->bhgk") / np.sqrt(D)
    p = torch.softmax(L._softcap(s, softcap), dim=-1)
    o = torch.einsum("bhgk,bkhd->bhgd", p, v.float()).to(v_cache.dtype)
    return o.reshape(B, 1, Hq, D)


def seq_prefill_case(d, arch: str, lay: str, mesh, split=True) -> dict:
    """``SEQ_PREFILL``'s prefill into a cache split along the sequence
    under ``lay`` on this rank (its rows, float32 activations, the
    reference's weights), then its decode steps under
    ``decode_impl="torch"``: the logits (the prefill's last, then each
    step's), the prefill's counters (all, and the hand-off's section),
    each global layer's live positions in this rank's block after the
    prefill, and the cache's ``seq``.  Without ``split``, the same rows
    over an unsplit cache on the same mesh, its global layers' decode
    attention keeping p in float32 (``decode_attention_f32``): the same
    function at the split path's precision."""
    from repro_torch.models import layers as L
    P_len, steps = SEQ_PREFILL["P"], SEQ_PREFILL["steps"]
    model, params, shape, rows = _seq_model(
        d, arch, lay, mesh, arch, SEQ_PREFILL["max_len"][lay], split)
    toks = seq_prefill_tokens(model.cfg.vocab)[rows]
    comm.reset_counters()
    last, cache = model.prefill(params, {"tokens": toks[:, :P_len]},
                                max_len=shape.seq_len, shape=shape)
    counts = {"all": comm.counters(), "handoff": comm.counters("handoff")}
    S_r = shape.seq_len // mesh.axis_size(cache["seq"] or ())
    held = [int((x.float().abs().sum(tuple(i for i in range(x.dim())
                                            if i != 2)) > 0).sum())
            for n, x in flatten_with_paths(cache["layers"])
            if n.rsplit(".", 1)[-1] in ("k", "v", "c", "pe")
            and x.shape[2] == S_r]
    logits = [last.numpy()]
    plain = L.decode_attention
    L.decode_attention = plain if split else decode_attention_f32
    try:
        for i in range(steps):
            lg, cache = model.decode_step(params, cache,
                                          toks[:, P_len + i:P_len + i + 1],
                                          decode_impl="torch")
            logits.append(lg.numpy())
    finally:
        L.decode_attention = plain
    return {"rows": (rows.start, rows.stop), "logits": np.stack(logits),
            "counters": counts, "held": held, "seq": cache["seq"],
            "index": mesh.axis_index(cache["seq"]) if cache["seq"] else 0}


def seq_serve_rank(rank, cache_npz, serve_npz):
    """``seq_cache_rank``'s cases, then ``_mesh_reference.py seq_serve``'s
    on this rank: DeepSeek-V2's seeded decode under ``decode_seq_shard``
    (``_seq_cache_case``) and ``seq_prefill_case`` for each arch of
    ``SEQ_PREFILL_ARCHS`` and each layout, split and unsplit."""
    out = {"cache": seq_cache_rank(rank, cache_npz)}
    d = np.load(serve_npz)
    mesh = make_mesh(SEQ_CACHE["mesh"], ("data", "model"))
    out["deepseek"] = _seq_cache_case(d, "deepseek-v2-236b", "seqshard",
                                      mesh)
    for key, split in (("prefill", True), ("unsplit", False)):
        out[key] = {f"{a}.{lay}": seq_prefill_case(d, a, lay, mesh, split)
                    for a in SEQ_PREFILL_ARCHS for lay in SEQ_LAYOUTS}
    return out


def family_rank(rank, npz, fam, seq_parallel):
    """``_mesh_reference.py families_tp``'s step for the family ``fam`` on
    (data=2, model=2), float32 activations, 3 steps: losses, norms, the
    final tree gathered, step 1's collective counters and dot FLOPs on
    this rank (``FlopCounterMode``), and the leaves gathered whole."""
    _setup()
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.models import Model
    from repro_torch.train.train_step import (init_mesh_opt_state,
                                              make_train_step, mesh_layout)
    d = np.load(npz)
    arch, over = FAMILY_CASES[fam]
    cfg = dataclasses.replace(smoke_config(arch), seq_parallel=seq_parallel,
                              **over)
    mesh = make_mesh((2, 2), ("data", "model"))
    model = Model(cfg, device="cpu", mesh=mesh)
    model.compute_dtype = torch.float32
    defs = model.param_defs()
    tree = unflatten_like(defs, [torch.from_numpy(d[f"{fam}.w.{n}"])
                                 for n, _ in flatten_with_paths(defs)])
    specs = model.param_specs()
    tcfg = TrainConfig(**TCFG)
    layout = mesh_layout(model, tcfg)
    params = blocks(tree, specs, mesh)
    opt = init_mesh_opt_state(params, layout, keep_master=False)
    step = make_train_step(model, tcfg, layout.moments)
    losses, norms, counts, flops = [], [], [], None
    for i in range(STEPS):
        comm.reset_counters()
        with FlopCounterMode(display=False) as fc:
            params, opt, m = step(params, opt, family_batch(cfg, i))
        flops = fc.get_total_flops() if flops is None else flops
        counts.append(comm.counters())
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return {"losses": losses, "norms": norms,
            "params": gathered(params, specs, mesh), "counters": counts,
            "flops": flops, "gathered_leaves": model.gathered_leaves()}


def mla_decode_rank(rank, npz):
    """``_mesh_reference.py mla_decode``'s prefill and steps on (data=2,
    model=2), this rank's rows: the prefill's last logits, each step's
    logits, the latent cache's block shape and step 1's counters."""
    _setup()
    from repro_torch.models import Model
    d = np.load(npz)
    cfg = dataclasses.replace(smoke_config("deepseek-v2-236b"),
                              moe_impl="tp")
    mesh = make_mesh((2, 2), ("data", "model"))
    model = Model(cfg, device="cpu", mesh=mesh)
    model.compute_dtype = torch.float32
    defs = model.param_defs()
    tree = unflatten_like(defs, [torch.from_numpy(d[f"w.{n}"])
                                 for n, _ in flatten_with_paths(defs)])
    params = blocks(tree, model.param_specs(), mesh)
    B, S, steps = (MLA_DECODE[k] for k in ("B", "S", "steps"))
    toks = mla_decode_tokens(cfg.vocab)
    rows = B // 2
    lo = mesh.axis_index("data") * rows
    mine = toks[lo:lo + rows]
    last, cache = model.prefill(params, {"tokens": mine[:, :S]},
                                max_len=S + steps)
    logits, counts = [], []
    for i in range(steps):
        comm.reset_counters()
        lg, cache = model.decode_step(params, cache, mine[:, S + i:S + i + 1])
        counts.append(comm.counters())
        logits.append(lg.numpy())
    c = cache["layers"][-1]["l0"]["c"]
    return {"rows": (lo, lo + rows), "prefill": last.numpy(),
            "logits": np.stack(logits), "c_shape": tuple(c.shape),
            "counters": counts[0], "gathered": model.gathered_leaves()}


def family_serve_rank(rank, npz, fam, steps=6, over=None):
    """The family ``fam``'s prefill (4 rows of 16 tokens, 2 a data rank)
    and ``steps`` decode steps on (data=2, model=2), float32 activations,
    against the same weights in one process on this rank: the relative
    L2 distances of the logits (prefill's last, then each step's) and
    this rank's cache leaves' shapes.  ``over``: config overrides on top
    of the case's."""
    _setup()
    from repro_torch.common.pytree import tree_leaves
    from repro_torch.models import Model
    d = np.load(npz)
    arch, case = FAMILY_CASES[fam]
    cfg = dataclasses.replace(smoke_config(arch), **dict(case, **(over or {})))
    mesh = make_mesh((2, 2), ("data", "model"))
    models = {"mesh": Model(cfg, device="cpu", mesh=mesh),
              "one": Model(cfg, device="cpu")}
    defs = models["one"].param_defs()
    tree = unflatten_like(defs, [torch.from_numpy(d[f"{fam}.w.{n}"])
                                 for n, _ in flatten_with_paths(defs)])
    toks = np.random.default_rng(23).integers(0, cfg.vocab, (4, 16 + steps),
                                              dtype=np.int32)
    lo = 2 * mesh.axis_index("data")
    batch = {"tokens": toks[lo:lo + 2, :16]}
    if cfg.enc_dec:
        batch["frames"] = np.random.default_rng(29).standard_normal(
            (4, 16, cfg.d_model)).astype(np.float32)[lo:lo + 2]
    out = {}
    for name, model in models.items():
        model.compute_dtype = torch.float32
        params = (blocks(tree, model.param_specs(), mesh) if name == "mesh"
                  else tree)
        last, cache = model.prefill(params, batch, max_len=16 + steps)
        got = [last]
        for i in range(steps):
            lg, cache = model.decode_step(params, cache,
                                          toks[lo:lo + 2, 16 + i:17 + i])
            got.append(lg)
        out[name] = (got, [tuple(t.shape) for t in tree_leaves(
            cache["layers"])])
    rel = [float(torch.linalg.vector_norm(a - b)
                 / torch.linalg.vector_norm(b))
           for a, b in zip(out["mesh"][0], out["one"][0])]
    return {"rel": rel, "mesh_cache": out["mesh"][1],
            "one_cache": out["one"][1]}


# chip_smoke.SplitProbe on the CPU: smoke Zamba2 over (data=2, model=2),
# batch 1, the shared block's cache of SEQ_CACHE["S"] positions split
# over data (blocks of 128), 8 steps from position 124: the last step's
# second block holds 4 live keys
SPLIT_PROBE_FAULTS = ("sound", "second_block_dropped")


def split_probe_rank(rank):
    """8 decode steps, the last through ``chip_smoke.SplitProbe``, then the
    last step again from the same state with the second block's pair
    dropped from the merge: {fault: the probe's check on this rank}."""
    import sys
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke
    from repro_torch.common.pytree import tree_map
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.models import Model
    from repro_torch.models import layers as L
    from repro_torch.models.model_api import cache_read_spec
    _setup()
    S, pos0, steps = SEQ_CACHE["S"], SEQ_CACHE["pos0"], SEQ_CACHE["steps"]
    mesh = make_mesh((2, 2), ("data", "model"))
    model = Model(smoke_config("zamba2-1.2b"), device="cpu", mesh=mesh)
    spec_of = dict(flatten_specs(model.param_specs()))
    params = chip_smoke.hashed_blocks(
        tree_map(lambda d: d.shape, model.param_defs()), 3, "cpu",
        lambda path, x: local_shard(x, spec_of[".".join(path)], mesh).clone())
    shape = ShapeConfig("split_probe", seq_len=S, global_batch=1,
                        kind="decode", cache_shard="seq")
    cspec = dict(flatten_specs(model.batch_pspecs(shape)["cache"]["layers"]))
    cdefs = model.cache_defs(1, S)["layers"]
    named = flatten_with_paths(cdefs)
    whole = seq_cache_numpy({n: c.shape for n, c in named}, pos0)
    cache = {"layers": unflatten_like(cdefs, [local_shard(
        torch.from_numpy(whole[n]).to(c.dtype), cache_read_spec(
            c, cspec[n]), mesh).clone() for n, c in named]),
        "pos": pos0, "seq": model.cache_seq_axes(shape)}
    toks = seq_cache_tokens(model.cfg.vocab, 1)
    for t in toks[:-1]:
        _, cache = model.decode_step(params, cache, t, decode_impl="torch")
    before = {n: x.clone() for n, x in flatten_with_paths(cache["layers"])}
    merge = L.merge_split

    def second_dropped(o, lse, m, axes):
        if m.axis_index(axes) == 1:
            o, lse = torch.zeros_like(o), torch.full_like(lse, -float("inf"))
        return merge(o, lse, m, axes)
    out = {}
    for fault in SPLIT_PROBE_FAULTS:
        for n, x in flatten_with_paths(cache["layers"]):
            x.copy_(before[n])
        cache["pos"] = pos0 + steps - 1
        L.merge_split = second_dropped if fault != "sound" else merge
        try:
            with chip_smoke.SplitProbe() as probe:
                _, cache = model.decode_step(params, cache, toks[-1],
                                             decode_impl="torch")
        finally:
            L.merge_split = merge
        out[fault] = probe.check()
    return out
