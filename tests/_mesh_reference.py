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
  ``data`` and on (data=2, model=2) with the default rules, ZeRO-1;
* ``lm_train``: the smoke TinyLlama's ZeRO-1 step on (data=2, model=2),
  float32 activations, 3 steps, whole batch and microbatches of 2;
* ``gpipe``: ``tests/test_pipeline.py``'s case over (stage=4);
* ``ckpt_write``: a checkpoint of the smoke DLRM's state on (data=4)
  with its specs, under ``OUT_DIR/ref_ckpt``;
* ``ckpt_read``: the port's checkpoint under ``OUT_DIR/port_ckpt``
  restored onto (data=2, model=2) with its specs.
"""
import os
import sys

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
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
            params, opt, m = step(params, opt, b)
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
        res[f"{name}.losses"] = np.asarray(losses)
        res[f"{name}.norms"] = np.asarray(norms)
        res.update(flat(params, f"{name}.p."))
    np.savez(out / "dlrm_train.npz", **res)


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


def run_lm_train(out: Path):
    from repro.models.model_api import Model
    from repro.train.optimizer import init_opt_state, opt_state_specs
    from repro.train.train_step import make_train_step
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
            params, opt, m = step(params, opt, b)
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
        name = f"mb{mb}"
        res[f"{name}.losses"] = np.asarray(losses)
        res[f"{name}.norms"] = np.asarray(norms)
        res.update(flat(params, f"{name}.p."))
    np.savez(out / "lm_train.npz", **res)


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
        "ckpt_read": run_ckpt_read}

if __name__ == "__main__":
    assert len(jax.devices()) == 4, jax.devices()
    out_dir = Path(sys.argv[1])
    out_dir.mkdir(parents=True, exist_ok=True)
    for name in sys.argv[2:]:
        RUNS[name](out_dir)
