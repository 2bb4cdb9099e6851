"""The JAX reference's side of the mesh parity tests, run in a subprocess
of its own with 4 forced host devices (the pytest process must see the
one real CPU device: ``tests/conftest.py``).

    python tests/_mesh_reference.py OUT_DIR NAME [NAME ...]

Each NAME writes ``OUT_DIR/NAME.npz`` (inputs drawn by numpy from fixed
seeds, and the reference's results), which the port's ranks read:

* ``moe``: ``moe_apply`` of the DeepSeek-V2 smoke config (E = 8) under
  ``ep_a2a`` on (data=4, model=1) and (data=2, model=2) and under ``tp``
  on (data=2, model=2), at the config's own capacity factor;
* ``dlrm_train``: the smoke DLRM's ``make_train_step`` jit-ed with the
  meshes' ``in_shardings``, 3 steps, on (data=4) with the tables over
  ``data`` and on (data=2, model=2) with the default rules, ZeRO-1; the
  compiled step's collectives (``scripts/hlo_collectives.py``; its HLO
  kept under ``$REPRO_HLO_DIR`` as ``dlrm_train_<case>``);
* ``dlrm_table2_hlo``: the Table II DLRM's step at B=256 on the same
  meshes, lowered and compiled from abstract arguments (no tables
  allocated): its collectives, its HLO kept as ``dlrm_table2_<case>``;
* ``lm_train``: the smoke TinyLlama's ZeRO-1 step on (data=2, model=2),
  float32 activations, 3 steps, whole batch and microbatches of 2;
* ``lm_masked``: ``lm_train`` with a seeded ``loss_mask`` in every batch
  (``_mesh_ranks.lm_loss_mask``: rows kept in unequal shares);
* ``gpipe``: ``tests/test_pipeline.py``'s case over (stage=4);
* ``ckpt_write``: a checkpoint of the smoke DLRM's state on (data=4)
  with its specs, under ``OUT_DIR/ref_ckpt``;
* ``ckpt_read``: the port's checkpoint under ``OUT_DIR/port_ckpt``
  restored onto (data=2, model=2) with its specs;
* ``lm_tp_comm``: ``lm_train``'s step with and without ``seq_parallel``,
  each step's compiled HLO (``hlo_comm.summarize``, ``hlo_counter.totals``
  and the text);
* ``moe_chunks``: ``moe``'s cases at ``moe_chunks=4``, slots dropped;
* ``dryrun_smoke``: ``repro.launch.dryrun.dryrun_cell`` of the smoke
  cells of ``_mesh_ranks.DRYRUN_CELLS`` on (data=4, model=2): 8 forced
  host devices, so it runs alone (jax is initialised before
  ``repro.launch.dryrun``, which sets ``XLA_FLAGS`` at import, is);
* ``families_tp[:a,b]``: the smoke Zamba2, RWKV-6 (and its one-head
  variant, whose columns cut through a head), DeepSeek-V2 under
  ``ep_a2a`` and ``tp`` and Whisper (``_mesh_ranks.FAMILY_CASES``, or
  the cases named) jit-ed ZeRO-1 steps on (data=2, model=2), with and
  without ``seq_parallel``: losses, norms, the updated tree and the
  compiled step's collectives and dot FLOPs; ``families_tp_a_b.npz``
  for named cases;
* ``mla_decode``: the smoke DeepSeek-V2's prefill and 8 decode steps on
  (data=2, model=2), the latent cache split over ``model``, and on one
  device;
* ``seq_cache``: the smoke Gemma-2 and Zamba2 ``decode_step`` jit-ed on
  (data=4, model=2) (8 forced host devices, alone) over a decode cache
  split along the sequence, ``cache_shard="seq"`` (batch 1, the sequence
  over ``data``) and ``decode_seq_shard`` (batch 4, the sequence over
  ``model``): a seeded cache of ``_mesh_ranks.SEQ_CACHE`` positions
  (``seq_cache_numpy``), 8 steps from position 124 across a block
  boundary, float32 activations; the logits, each compiled step's
  collectives, and the logits of the same steps on one device over the
  whole cache (``single``);
* ``seq_serve``: (8 forced host devices, beside ``seq_cache`` or alone)
  the smoke DeepSeek-V2 under ``decode_seq_shard`` on (data=4, model=2),
  ``seq_cache``'s case: its latent cache split along the sequence over
  ``model`` (every latent column a rank), 8 steps across the block
  boundary with model rank 1 empty at first, the mesh run and one
  device's (``deepseek.seqshard.*``); and for each of
  ``_mesh_ranks.SEQ_PREFILL_ARCHS`` the ordinary prefill of
  ``SEQ_PREFILL``'s prompts, then its decode steps, on one device
  (``<arch>.ref``: the prefill's last logits and each step's).
"""
import os
import sys

# 8 devices for the (data=4, model=2) runs (``dryrun_smoke`` alone); 4
# otherwise
EIGHT = ("dryrun_smoke", "seq_cache", "seq_serve")
N_DEVICES = 8 if set(EIGHT) & set(sys.argv[2:]) else 4
os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count="
                           f"{N_DEVICES}")
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import dataclasses  # noqa: E402
from pathlib import Path  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import NamedSharding, PartitionSpec as P  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402  (numpy only at import: the shared weights)
from repro.common.pytree import flatten_with_paths  # noqa: E402
from repro.common.sharding import MeshRules  # noqa: E402
from repro.configs import smoke_config  # noqa: E402
from repro.configs.base import TrainConfig  # noqa: E402
from repro.data.pipeline import dlrm_batch, lm_batch  # noqa: E402

MOE_CASES = (((4, 1), "ep_a2a"), ((2, 2), "ep_a2a"), ((2, 2), "tp"))
DLRM_CASES = {"data4": ((4,), ("data",), {"expert": ("data",)}),
              "data2_model2": ((2, 2), ("data", "model"), None)}
TCFG = dict(learning_rate=1e-2, warmup_steps=2, total_steps=10)
DLRM_BATCH = 16
LM_BATCH, LM_SEQ = 4, 32
STEPS = 3


def make_mesh(shape, axes):
    """A mesh whose axes GSPMD lays out (``AxisType.Auto``), as
    ``jax.make_mesh`` made them when the reference was written."""
    from jax.sharding import AxisType
    return jax.make_mesh(shape, axes, axis_types=(AxisType.Auto,) * len(axes))


def shard(mesh, tree):
    return jax.tree.map(lambda s: NamedSharding(mesh, s), tree,
                        is_leaf=lambda x: isinstance(x, P))


def flat(tree, prefix=""):
    return {prefix + n: np.asarray(jnp.asarray(v, jnp.float32)
                                   if v.dtype == jnp.bfloat16 else v)
            for n, v in flatten_with_paths(tree)}


# ---------------------------------------------------------------------------

def moe_inputs(cfg):
    """Router, experts (float32) and tokens of the MoE case; the router
    leans toward the first experts, so capacity drops happen."""
    rng = np.random.default_rng(11)
    D, E, F = cfg.d_model, cfg.n_experts, cfg.moe_d_ff
    Fs = F * cfg.n_shared_experts
    f = np.float32
    p = {"router": (rng.standard_normal((D, E)) / np.sqrt(D)).astype(f),
         "w1": (rng.standard_normal((E, D, F)) / np.sqrt(D)).astype(f),
         "w3": (rng.standard_normal((E, D, F)) / np.sqrt(D)).astype(f),
         "w2": (rng.standard_normal((E, F, D)) / np.sqrt(F)).astype(f),
         "shared": {
             "w1": (rng.standard_normal((D, Fs)) / np.sqrt(D)).astype(f),
             "w3": (rng.standard_normal((D, Fs)) / np.sqrt(D)).astype(f),
             "w2": (rng.standard_normal((Fs, D)) / np.sqrt(Fs)).astype(f)}}
    x = rng.standard_normal((64, D)).astype(f)
    p["router"][:, :3] += (0.6 * x.mean(0) / np.linalg.norm(x.mean(0))
                           )[:, None].astype(f)
    return p, x


def run_moe(out: Path):
    from repro.models.moe import moe_apply
    base = smoke_config("deepseek-v2-236b")
    p, x = moe_inputs(base)
    res = {"x": x, **{f"p.{k}": v for k, v in flat(p).items()}}
    for shape, impl in MOE_CASES:
        cfg = dataclasses.replace(base, moe_impl=impl)
        mesh = make_mesh(shape, ("data", "model"))
        y = jax.jit(lambda p_, x_: moe_apply(p_, x_, cfg, mesh))(
            jax.tree.map(jnp.asarray, p), jnp.asarray(x))
        res[f"{impl}_{shape[0]}x{shape[1]}"] = np.asarray(y)
    np.savez(out / "moe.npz", **res)


# ---------------------------------------------------------------------------

def dlrm_numpy(cfg, seed=4):
    from repro_torch.models.dlrm import param_shapes
    shapes = {k: (v[0] if not isinstance(v, dict) else
                  {n: lv[0] for n, lv in v.items()})
              for k, v in param_shapes(cfg).items()}
    return chip_smoke.dlrm_numpy_params(shapes, seed)


def to_jax(tree):
    def one(a):
        if a.dtype == np.uint16:
            return jnp.asarray(a.view(ml_dtypes.bfloat16))
        return jnp.asarray(a)
    return jax.tree.map(one, tree)


def run_dlrm_train(out: Path):
    from repro.models.dlrm import DLRM
    from repro.train.optimizer import init_opt_state, opt_state_specs
    from repro.train.train_step import make_train_step
    cfg = smoke_config("dlrm")
    tree = dlrm_numpy(cfg)
    res = {f"w.{k}": v for k, v in _flat_np(tree).items()}
    tcfg = TrainConfig(**TCFG)
    for name, (shape, axes, overrides) in DLRM_CASES.items():
        mesh = make_mesh(shape, axes)
        model = DLRM(cfg, mesh)
        rules = MeshRules.create(mesh, overrides)
        specs = model.param_specs(rules)
        o_specs = opt_state_specs(specs, model.param_defs(), mesh,
                                  zero1=True, keep_master=False)
        b_specs = model.batch_pspecs(rules)
        params = jax.device_put(to_jax(tree), shard(mesh, specs))
        opt = jax.device_put(init_opt_state(params, keep_master=False),
                             shard(mesh, o_specs))
        step = jax.jit(make_train_step(model, tcfg),
                       in_shardings=(shard(mesh, specs), shard(mesh, o_specs),
                                     shard(mesh, b_specs)),
                       out_shardings=(shard(mesh, specs),
                                      shard(mesh, o_specs), None))
        losses, norms = [], []
        for i in range(STEPS):
            b = {k: jnp.asarray(v) for k, v in
                 dlrm_batch(0, i, DLRM_BATCH, cfg).items()}
            if i == 0:
                with mesh:
                    hlo = step.lower(params, opt, b).compile().as_text()
            params, opt, m = step(params, opt, b)
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
        res[f"{name}.losses"] = np.asarray(losses)
        res[f"{name}.norms"] = np.asarray(norms)
        res[f"{name}.collectives"] = np.asarray(_collectives_json(hlo))
        res.update(flat(params, f"{name}.p."))
        _keep_hlo(f"dlrm_train_{name}", hlo)
    np.savez(out / "dlrm_train.npz", **res)


def run_dlrm_table2_hlo(out: Path):
    """The Table II DLRM's step (``make_train_step``, ``TrainConfig()``,
    B=256) lowered and compiled for each of ``DLRM_CASES``' meshes from
    abstract arguments (nothing allocated, nothing run): its collectives
    (``_collectives_json``), the HLO kept as ``dlrm_table2_<case>``."""
    from repro.configs import get_config
    from repro.models.dlrm import DLRM
    from repro.train.optimizer import init_opt_state, opt_state_specs
    from repro.train.train_step import make_train_step
    cfg = get_config("dlrm")
    res = {}
    for name, (shape, axes, overrides) in DLRM_CASES.items():
        mesh = make_mesh(shape, axes)
        model = DLRM(cfg, mesh)
        rules = MeshRules.create(mesh, overrides)
        specs = model.param_specs(rules)
        o_specs = opt_state_specs(specs, model.param_defs(), mesh,
                                  zero1=True, keep_master=False)
        params = jax.tree.map(lambda d: jax.ShapeDtypeStruct(d.shape,
                                                             d.dtype),
                              model.param_defs(),
                              is_leaf=lambda x: hasattr(x, "axes"))
        opt = jax.eval_shape(lambda p: init_opt_state(p, keep_master=False),
                             params)
        batch = {k: jax.ShapeDtypeStruct(v.shape, v.dtype) for k, v in
                 dlrm_batch(0, 0, 256, cfg).items()}
        step = jax.jit(make_train_step(model, TrainConfig()),
                       in_shardings=(shard(mesh, specs), shard(mesh, o_specs),
                                     shard(mesh, model.batch_pspecs(rules))),
                       out_shardings=(shard(mesh, specs),
                                      shard(mesh, o_specs), None))
        with mesh:
            hlo = step.lower(params, opt, batch).compile().as_text()
        res[f"{name}.collectives"] = np.asarray(_collectives_json(hlo))
        _keep_hlo(f"dlrm_table2_{name}", hlo)
    np.savez(out / "dlrm_table2_hlo.npz", **res)


def _collectives_json(hlo: str) -> str:
    """The compiled step's collectives in program order, as
    ``scripts/hlo_collectives.py`` reads them: [kind, result shape,
    result bytes, op name]."""
    import json
    sys.path.insert(0, str(ROOT / "scripts"))
    from hlo_collectives import collectives, shape_bytes
    return json.dumps([[k, shp, shape_bytes(shp), op]
                       for k, shp, _, op in collectives(hlo)])


def _flat_np(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat_np(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


# ---------------------------------------------------------------------------

def lm_pair_tree(r_model, seed=6):
    shapes = jax.tree.map(lambda d: d.shape, r_model.param_defs(),
                          is_leaf=lambda x: hasattr(x, "axes"))
    return chip_smoke.transformer_numpy_params(shapes, seed, bf16=False)


def run_lm_train(out: Path, masked: bool = False):
    from repro.models.model_api import Model
    from repro.train.optimizer import init_opt_state, opt_state_specs
    from repro.train.train_step import make_train_step
    from _mesh_ranks import lm_loss_mask
    cfg = smoke_config("tinyllama-1.1b")
    mesh = make_mesh((2, 2), ("data", "model"))
    model = Model(cfg, mesh)
    model.compute_dtype = jnp.float32
    tree = lm_pair_tree(model)
    res = {"w." + n: np.asarray(v) for n, v in flatten_with_paths(tree)}
    specs = model.param_specs()
    o_specs = opt_state_specs(specs, model.param_defs(), mesh, zero1=True,
                              keep_master=False)
    b_specs = {"tokens": P("data", None)}
    if masked:
        b_specs["loss_mask"] = P("data", None)
    for mb in (None, 2):
        tcfg = TrainConfig(microbatch=mb, **TCFG)
        params = jax.device_put(jax.tree.map(jnp.asarray, tree),
                                shard(mesh, specs))
        opt = jax.device_put(init_opt_state(params, keep_master=False),
                             shard(mesh, o_specs))
        step = jax.jit(make_train_step(model, tcfg),
                       in_shardings=(shard(mesh, specs), shard(mesh, o_specs),
                                     shard(mesh, b_specs)),
                       out_shardings=(shard(mesh, specs),
                                      shard(mesh, o_specs), None))
        losses, norms = [], []
        for i in range(STEPS):
            b = {"tokens": jnp.asarray(lm_batch(0, i, LM_BATCH, LM_SEQ,
                                                cfg.vocab)["tokens"])}
            if masked:
                b["loss_mask"] = jnp.asarray(lm_loss_mask(i))
            params, opt, m = step(params, opt, b)
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
        name = f"mb{mb}"
        res[f"{name}.losses"] = np.asarray(losses)
        res[f"{name}.norms"] = np.asarray(norms)
        res.update(flat(params, f"{name}.p."))
    np.savez(out / ("lm_masked.npz" if masked else "lm_train.npz"), **res)


def run_lm_masked(out: Path):
    """``lm_train``'s steps with ``_mesh_ranks.lm_loss_mask``'s seeded
    ``loss_mask`` in every batch."""
    run_lm_train(out, masked=True)


def run_lm_tp_comm(out: Path):
    """``run_lm_train``'s step with and without ``seq_parallel``: 3 steps
    of the whole batch and of microbatches of 2, and each step's compiled
    HLO read by ``hlo_comm.summarize`` and ``hlo_counter.totals``."""
    import json

    from repro.core.hlo_comm import extract, summarize
    from repro.core.hlo_counter import totals
    from repro.models.model_api import Model
    from repro.train.optimizer import init_opt_state, opt_state_specs
    from repro.train.train_step import make_train_step
    mesh = make_mesh((2, 2), ("data", "model"))
    tree = lm_pair_tree(Model(smoke_config("tinyllama-1.1b"), mesh))
    res = {"w." + n: np.asarray(v) for n, v in flatten_with_paths(tree)}
    for sp in (False, True):
        cfg = dataclasses.replace(smoke_config("tinyllama-1.1b"),
                                  seq_parallel=sp)
        model = Model(cfg, mesh)
        model.compute_dtype = jnp.float32
        specs = model.param_specs()
        o_specs = opt_state_specs(specs, model.param_defs(), mesh,
                                  zero1=True, keep_master=False)
        b_specs = {"tokens": P("data", None)}
        for mb in (None, 2):
            name = f"sp{int(sp)}.mb{mb}"
            tcfg = TrainConfig(microbatch=mb, **TCFG)
            params = jax.device_put(jax.tree.map(jnp.asarray, tree),
                                    shard(mesh, specs))
            opt = jax.device_put(init_opt_state(params, keep_master=False),
                                 shard(mesh, o_specs))
            step = jax.jit(make_train_step(model, tcfg),
                           in_shardings=(shard(mesh, specs),
                                         shard(mesh, o_specs),
                                         shard(mesh, b_specs)),
                           out_shardings=(shard(mesh, specs),
                                          shard(mesh, o_specs), None))
            batches = [{"tokens": jnp.asarray(lm_batch(
                0, i, LM_BATCH, LM_SEQ, cfg.vocab)["tokens"])}
                for i in range(STEPS)]
            with mesh:
                hlo = step.lower(params, opt, batches[0]).compile().as_text()
                losses, norms = [], []
                for b in batches:
                    params, opt, m = step(params, opt, b)
                    losses.append(float(m["loss"]))
                    norms.append(float(m["grad_norm"]))
            t = totals(hlo)
            res[f"{name}.losses"] = np.asarray(losses)
            res[f"{name}.norms"] = np.asarray(norms)
            res[f"{name}.hlo"] = np.asarray(hlo)
            res[f"{name}.comm"] = np.asarray(json.dumps({
                "summarize": summarize(extract(hlo)),
                "totals": {"flops": t.flops, "bytes": t.bytes,
                           "bytes_floor": t.bytes_floor, "coll": t.coll}}))
            res.update(flat(params, f"{name}.p."))
    np.savez(out / "lm_tp_comm.npz", **res)


def run_moe_chunks(out: Path):
    """``run_moe``'s cases at ``moe_chunks=4``: the skewed router drops
    slots, so the split of the tokens into chunks shows."""
    from repro.models.moe import moe_apply
    base = dataclasses.replace(smoke_config("deepseek-v2-236b"),
                               moe_chunks=4)
    p, x = moe_inputs(base)
    res = {"x": x, **{f"p.{k}": v for k, v in flat(p).items()}}
    for shape, impl in MOE_CASES:
        cfg = dataclasses.replace(base, moe_impl=impl)
        mesh = make_mesh(shape, ("data", "model"))
        y = jax.jit(lambda p_, x_: moe_apply(p_, x_, cfg, mesh))(
            jax.tree.map(jnp.asarray, p), jnp.asarray(x))
        res[f"{impl}_{shape[0]}x{shape[1]}"] = np.asarray(y)
    np.savez(out / "moe_chunks.npz", **res)


def run_dryrun_smoke(out: Path):
    """The reference's ``dryrun_cell`` (lowered and compiled) of each of
    ``_mesh_ranks.DRYRUN_CELLS``: the smoke config, the smoke shape, on
    (data=4, model=2) of 8 forced host devices."""
    import json

    import repro.configs
    import repro.launch.mesh
    from _mesh_ranks import DRYRUN_CELLS, DRYRUN_MESH, DRYRUN_SHAPES
    from repro.configs.base import ShapeConfig
    from repro.configs.shapes import ALL_SHAPES
    from repro.models.model_api import Model
    mesh = make_mesh(DRYRUN_MESH, ("data", "model"))
    # the module sets XLA_FLAGS at import: jax has its 8 devices by now
    from repro.launch import dryrun
    repro.launch.mesh.make_production_mesh = lambda multi_pod=False: mesh
    repro.configs.get_model = lambda arch, mesh_: Model(smoke_config(arch),
                                                        mesh_)
    ALL_SHAPES.update({k: ShapeConfig(k, **v)
                       for k, v in DRYRUN_SHAPES.items()})
    res = {}
    for arch, shape in DRYRUN_CELLS:
        cell = dryrun.dryrun_cell(arch, shape, False, verbose=False)
        res[f"{arch}.{shape}"] = np.asarray(json.dumps(cell))
    np.savez(out / "dryrun_smoke.npz", **res)


def _keep_hlo(name: str, hlo: str) -> None:
    """``$REPRO_HLO_DIR/<name>.hlo.gz`` when the variable is set (for
    ``scripts/hlo_dots.py`` and ``scripts/hlo_collectives.py``)."""
    import gzip
    d = os.environ.get("REPRO_HLO_DIR")
    if d:
        Path(d).mkdir(parents=True, exist_ok=True)
        with gzip.open(Path(d) / f"{name}.hlo.gz", "wt") as f:
            f.write(hlo)


def _comm_json(hlo: str) -> str:
    import json

    from repro.core.hlo_comm import extract, summarize
    from repro.core.hlo_counter import totals
    t = totals(hlo)
    return json.dumps({"summarize": summarize(extract(hlo)),
                       "totals": {"flops": t.flops, "bytes": t.bytes,
                                  "bytes_floor": t.bytes_floor,
                                  "coll": t.coll}})


def run_families_tp(out: Path, names=None):
    """The smoke families' ZeRO-1 step on (data=2, model=2), float32
    activations, 3 steps, with and without ``seq_parallel``
    (``_mesh_ranks.FAMILY_CASES``, or the ``names`` of them): losses,
    norms, the updated tree, and the compiled step's collectives and dot
    FLOPs (``_comm_json``)."""
    from _mesh_ranks import FAMILY_CASES, family_batch
    from repro.models.model_api import Model
    from repro.train.optimizer import init_opt_state, opt_state_specs
    from repro.train.train_step import make_train_step
    mesh = make_mesh((2, 2), ("data", "model"))
    res = {}
    for fam in names or FAMILY_CASES:
        arch, over = FAMILY_CASES[fam]
        tree = None
        for sp in (False, True):
            cfg = dataclasses.replace(smoke_config(arch), seq_parallel=sp,
                                      **over)
            model = Model(cfg, mesh)
            model.compute_dtype = jnp.float32
            if tree is None:
                tree = lm_pair_tree(model)
                res.update({f"{fam}.w.{n}": np.asarray(v)
                            for n, v in flatten_with_paths(tree)})
            specs = model.param_specs()
            o_specs = opt_state_specs(specs, model.param_defs(), mesh,
                                      zero1=True, keep_master=False)
            batches = [{k: jnp.asarray(v) for k, v in
                        family_batch(cfg, i).items()} for i in range(STEPS)]
            b_specs = {k: P("data", *([None] * (v.ndim - 1)))
                       for k, v in batches[0].items()}
            params = jax.device_put(jax.tree.map(jnp.asarray, tree),
                                    shard(mesh, specs))
            opt = jax.device_put(init_opt_state(params, keep_master=False),
                                 shard(mesh, o_specs))
            step = jax.jit(make_train_step(model, TrainConfig(**TCFG)),
                           in_shardings=(shard(mesh, specs),
                                         shard(mesh, o_specs),
                                         shard(mesh, b_specs)),
                           out_shardings=(shard(mesh, specs),
                                          shard(mesh, o_specs), None))
            name = f"{fam}.sp{int(sp)}"
            with mesh:
                hlo = step.lower(params, opt, batches[0]).compile().as_text()
                losses, norms = [], []
                for b in batches:
                    params, opt, m = step(params, opt, b)
                    losses.append(float(m["loss"]))
                    norms.append(float(m["grad_norm"]))
            res[f"{name}.losses"] = np.asarray(losses)
            res[f"{name}.norms"] = np.asarray(norms)
            res[f"{name}.comm"] = np.asarray(_comm_json(hlo))
            res.update(flat(params, f"{name}.p."))
            _keep_hlo(name, hlo)
    tag = "families_tp" if names is None else "families_tp_" + "_".join(names)
    np.savez(out / f"{tag}.npz", **res)


def run_mla_decode(out: Path):
    """The smoke DeepSeek-V2 (``moe_impl="tp"``) on (data=2, model=2):
    prefill of ``_mesh_ranks.MLA_DECODE``'s rows into a cache split by the
    default cache rules (the latent ``c`` over ``model``), then its decode
    steps, float32 activations, jit-ed with the specs: the prefill's last
    logits, each step's logits, and the compiled decode step's
    collectives; and the same on one device (``single``)."""
    from _mesh_ranks import MLA_DECODE, mla_decode_tokens
    from repro.configs.base import ShapeConfig
    from repro.models.model_api import Model
    mesh = make_mesh((2, 2), ("data", "model"))
    cfg = dataclasses.replace(smoke_config("deepseek-v2-236b"),
                              moe_impl="tp")
    model = Model(cfg, mesh)
    model.compute_dtype = jnp.float32
    tree = lm_pair_tree(model)
    B, S, steps = (MLA_DECODE[k] for k in ("B", "S", "steps"))
    max_len = S + steps
    toks = mla_decode_tokens(cfg.vocab)
    res = {f"w.{n}": np.asarray(v) for n, v in flatten_with_paths(tree)}
    specs = model.param_specs()
    shape = ShapeConfig("mla", seq_len=max_len, global_batch=B,
                        kind="decode")
    bspecs = model.batch_pspecs(shape)
    for tag in ("mesh", "single"):
        if tag == "mesh":
            params = jax.device_put(jax.tree.map(jnp.asarray, tree),
                                    shard(mesh, specs))
            pre = jax.jit(lambda p, b: model.prefill(p, b, max_len=max_len),
                          in_shardings=(shard(mesh, specs),
                                        shard(mesh, {"tokens": P("data")})),
                          out_shardings=(None, shard(mesh, bspecs["cache"])))
            step = jax.jit(model.decode_step,
                           in_shardings=(shard(mesh, specs),
                                         shard(mesh, bspecs["cache"]),
                                         shard(mesh, bspecs["tokens"])),
                           out_shardings=(None,
                                          shard(mesh, bspecs["cache"])))
        else:
            params = jax.tree.map(jnp.asarray, tree)
            pre = jax.jit(lambda p, b: model.prefill(p, b, max_len=max_len))
            step = jax.jit(model.decode_step)
        with mesh:
            last, cache = pre(params, {"tokens": jnp.asarray(toks[:, :S])})
            logits = []
            for i in range(steps):
                t = jnp.asarray(toks[:, S + i:S + i + 1])
                if i == 0 and tag == "mesh":
                    hlo = step.lower(params, cache, t).compile().as_text()
                lg, cache = step(params, cache, t)
                logits.append(np.asarray(lg))
        res[f"{tag}.prefill"] = np.asarray(last)
        res[f"{tag}.logits"] = np.stack(logits)
    res["comm"] = np.asarray(_comm_json(hlo))
    _keep_hlo("mla_decode", hlo)
    np.savez(out / "mla_decode.npz", **res)


def _seq_cache_case(mesh, arch: str, lay: str, res: dict) -> None:
    """One (arch, layout) case of ``seq_cache`` into ``res``."""
    from _mesh_ranks import (SEQ_CACHE, SEQ_LAYOUTS, seq_cache_numpy,
                             seq_cache_tokens)
    from repro.configs.base import ShapeConfig
    from repro.models.model_api import Model
    S, pos0 = SEQ_CACHE["S"], SEQ_CACHE["pos0"]
    B, shard_kind, seq_model = SEQ_LAYOUTS[lay]
    cfg = dataclasses.replace(smoke_config(arch), decode_seq_shard=seq_model)
    model = Model(cfg, mesh)
    model.compute_dtype = jnp.float32
    tree = lm_pair_tree(model)
    shape = ShapeConfig("seq_cache", seq_len=S, global_batch=B,
                        kind="decode", cache_shard=shard_kind)
    specs = model.param_specs()
    bspecs = model.batch_pspecs(shape)
    like = model.init_cache(B, S)["layers"]
    cache_np = seq_cache_numpy(
        {n: a.shape for n, a in flatten_with_paths(like)}, pos0)
    leaves = [jnp.asarray(cache_np[n], a.dtype)
              for n, a in flatten_with_paths(like)]
    layers = jax.tree.unflatten(jax.tree.structure(like), leaves)
    toks = seq_cache_tokens(cfg.vocab, B)
    # one device, the whole cache: the yardstick of both runs
    one = jax.jit(model.decode_step)
    c1 = {"layers": layers, "pos": jnp.asarray(pos0, jnp.int32)}
    p1 = jax.tree.map(jnp.asarray, tree)
    single = []
    for t in toks:
        lg, c1 = one(p1, c1, jnp.asarray(t))
        single.append(np.asarray(lg))
    cache = {"layers": jax.device_put(
        layers, shard(mesh, bspecs["cache"]["layers"])),
        "pos": jnp.asarray(pos0, jnp.int32)}
    params = jax.device_put(jax.tree.map(jnp.asarray, tree),
                            shard(mesh, specs))
    step = jax.jit(model.decode_step,
                   in_shardings=(shard(mesh, specs),
                                 shard(mesh, bspecs["cache"]),
                                 shard(mesh, bspecs["tokens"])),
                   out_shardings=(None, shard(mesh, bspecs["cache"])))
    name = f"{arch}.{lay}"
    with mesh:
        hlo = step.lower(params, cache, jnp.asarray(
            toks[0])).compile().as_text()
        logits = []
        for t in toks:
            lg, cache = step(params, cache, jnp.asarray(t))
            logits.append(np.asarray(lg))
    res[f"{name}.logits"] = np.stack(logits)
    res[f"{name}.single"] = np.stack(single)
    _keep_hlo(name, hlo)
    res[f"{name}.comm"] = np.asarray(_comm_json(hlo))
    res.update({f"{name}.w.{n}": np.asarray(v)
                for n, v in flatten_with_paths(tree)})


def run_seq_cache(out: Path):
    """The module docstring's ``seq_cache``."""
    from _mesh_ranks import SEQ_CACHE, SEQ_CACHE_ARCHS, SEQ_LAYOUTS
    mesh = make_mesh(SEQ_CACHE["mesh"], ("data", "model"))
    res = {}
    for arch in SEQ_CACHE_ARCHS:
        for lay in SEQ_LAYOUTS:
            _seq_cache_case(mesh, arch, lay, res)
    np.savez(out / "seq_cache.npz", **res)


def run_seq_serve(out: Path):
    """The module docstring's ``seq_serve``."""
    from _mesh_ranks import (SEQ_CACHE, SEQ_PREFILL, SEQ_PREFILL_ARCHS,
                             seq_prefill_tokens)
    from repro.models.model_api import Model
    mesh = make_mesh(SEQ_CACHE["mesh"], ("data", "model"))
    res = {}
    _seq_cache_case(mesh, "deepseek-v2-236b", "seqshard", res)
    P_len, steps = SEQ_PREFILL["P"], SEQ_PREFILL["steps"]
    for arch in SEQ_PREFILL_ARCHS:
        cfg = smoke_config(arch)
        model = Model(cfg, mesh)
        model.compute_dtype = jnp.float32
        tree = lm_pair_tree(model)
        toks = seq_prefill_tokens(cfg.vocab)
        params = jax.tree.map(jnp.asarray, tree)
        pre = jax.jit(lambda p, b: model.prefill(p, b, max_len=P_len + steps))
        step = jax.jit(model.decode_step)
        last, cache = pre(params, {"tokens": jnp.asarray(toks[:, :P_len])})
        logits = [np.asarray(last)]
        for i in range(steps):
            lg, cache = step(params, cache, jnp.asarray(
                toks[:, P_len + i:P_len + i + 1]))
            logits.append(np.asarray(lg))
        res[f"{arch}.ref"] = np.stack(logits)
        res.update({f"{arch}.w.{n}": np.asarray(v)
                    for n, v in flatten_with_paths(tree)})
    np.savez(out / "seq_serve.npz", **res)


# ---------------------------------------------------------------------------

def run_gpipe(out: Path):
    from repro.train.pipeline import gpipe
    mesh = make_mesh((4,), ("stage",))
    n_stages, n_micro, mb, d = 4, 8, 2, 16
    rng = np.random.default_rng(3)
    w = (rng.standard_normal((n_stages, d, d)) * 0.3).astype(np.float32)
    x = rng.standard_normal((n_micro, mb, d)).astype(np.float32)
    y = gpipe(lambda wi, h: jnp.tanh(h @ wi), jnp.asarray(w), jnp.asarray(x),
              mesh)
    np.savez(out / "gpipe.npz", w=w, x=x, y=np.asarray(y))


# ---------------------------------------------------------------------------

def dlrm_state(cfg, mesh, overrides):
    """The smoke DLRM's params and a nonzero AdamW state, with specs."""
    from repro.models.dlrm import DLRM
    from repro.train.optimizer import init_opt_state, opt_state_specs
    model = DLRM(cfg, mesh)
    rules = MeshRules.create(mesh, overrides)
    specs = model.param_specs(rules)
    o_specs = opt_state_specs(specs, model.param_defs(), mesh, zero1=True,
                              keep_master=False)
    tree = dlrm_numpy(cfg, seed=9)
    params = to_jax(tree)
    opt = init_opt_state(params, keep_master=False)
    opt = dict(opt, mu=jax.tree.map(lambda a: a + 0.5, opt["mu"]),
               nu=jax.tree.map(lambda a: a + 0.25, opt["nu"]),
               count=jnp.asarray(7, jnp.int32))
    return (params, opt), (specs, o_specs)


def run_ckpt_write(out: Path):
    from repro.checkpoint.ckpt import save
    cfg = smoke_config("dlrm")
    mesh = make_mesh((4,), ("data",))
    tree, specs = dlrm_state(cfg, mesh, {"expert": ("data",)})
    tree = jax.device_put(tree, shard(mesh, specs))
    save(str(out / "ref_ckpt"), 7, tree, specs, extra_meta={"next_step": 7})
    np.savez(out / "ckpt_write.npz", **flat(tree))


def run_ckpt_read(out: Path):
    from repro.checkpoint.ckpt import restore
    cfg = smoke_config("dlrm")
    mesh = make_mesh((2, 2), ("data", "model"))
    like, specs = dlrm_state(cfg, mesh, None)
    tree, meta = restore(str(out / "port_ckpt"), 5, like, mesh=mesh,
                         specs=specs)
    shards = {}
    for (n, a), (_, s) in zip(flatten_with_paths(tree),
                              flatten_with_paths(specs, is_leaf=lambda x:
                                                 isinstance(x, P))):
        assert a.sharding.spec == s, (n, a.sharding.spec, s)
        shards["shape." + n] = np.asarray(a.addressable_shards[0].data.shape)
    np.savez(out / "ckpt_read.npz", next_step=meta["next_step"],
             **flat(tree), **shards)


RUNS = {"moe": run_moe, "dlrm_train": run_dlrm_train, "lm_train": run_lm_train,
        "gpipe": run_gpipe, "ckpt_write": run_ckpt_write,
        "ckpt_read": run_ckpt_read, "lm_tp_comm": run_lm_tp_comm,
        "moe_chunks": run_moe_chunks, "dryrun_smoke": run_dryrun_smoke,
        "seq_cache": run_seq_cache, "families_tp": run_families_tp,
        "mla_decode": run_mla_decode, "seq_serve": run_seq_serve,
        "lm_masked": run_lm_masked, "dlrm_table2_hlo": run_dlrm_table2_hlo}

if __name__ == "__main__":
    assert len(jax.devices()) == N_DEVICES, jax.devices()
    names = set(sys.argv[2:])
    if N_DEVICES == 8 and not (names <= set(EIGHT) and (
            "dryrun_smoke" not in names or len(names) == 1)):
        raise SystemExit(f"{EIGHT} run without the 4-device runs, "
                         "dryrun_smoke alone")
    out_dir = Path(sys.argv[1])
    out_dir.mkdir(parents=True, exist_ok=True)
    for name in sys.argv[2:]:
        # NAME:a,b runs the cases a and b of NAME (families_tp)
        name, _, cases = name.partition(":")
        if cases:
            RUNS[name](out_dir, cases.split(","))
        else:
            RUNS[name](out_dir)
