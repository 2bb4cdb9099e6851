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

def moe_rank(rank, npz):
    """Each (impl, mesh) case of ``moe.npz`` on this rank's tokens and
    expert blocks: {case: (its rows' output, dropped slots)}."""
    _setup()
    from repro_torch.models import moe as MOE
    d = np.load(npz)
    x = torch.from_numpy(d["x"])
    p = {k[2:]: torch.from_numpy(d[k]) for k in d.files
         if k.startswith("p.") and not k.startswith("p.shared.")}
    shared = {k[len("p.shared."):]: torch.from_numpy(d[k]) for k in d.files
              if k.startswith("p.shared.")}
    base = smoke_config("deepseek-v2-236b")
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

def lm_rank(rank, npz, microbatch):
    """The smoke TinyLlama's ZeRO-1 step on (data=2, model=2), float32
    activations, 3 steps."""
    _setup()
    from repro_torch.data import lm_batch
    from repro_torch.models import Model
    from repro_torch.train.train_step import (init_mesh_opt_state,
                                              make_train_step, mesh_layout)
    d = np.load(npz)
    cfg = smoke_config("tinyllama-1.1b")
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
    losses, norms = [], []
    for i in range(STEPS):
        params, opt, m = step(params, opt,
                              lm_batch(0, i, LM_BATCH, LM_SEQ, cfg.vocab))
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return {"losses": losses, "norms": norms,
            "params": gathered(params, specs, mesh)}


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
