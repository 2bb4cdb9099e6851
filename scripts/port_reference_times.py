"""Results of the JAX reference (CPU) for the scenarios that
``chip_smoke.py`` drives through the PyTorch/CUDA port.

    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/port_reference_times.py [name ...]

with names from ``clos128_1d``, ``clos32_2d`` (collective completion
times, jnp step), ``batch_fig12`` (lanes 0 and 8 of Fig 12's fabric
sweep, each as a serial run), ``dlrm_reference`` (Table II DLRM logits on
a seeded batch), ``dlrm_iteration`` (the DLRM training iteration on the
128-GPU platform), ``serve_reference`` (TinyLlama's logits, prefill
and teacher-forced decode, at full width and 4 layers),
``sliding_reference`` (Gemma-2's and Gemma-3's, at full width and one
attention period, the window cut; ``sliding_reference:gemma3-27b`` one),
``families_reference`` (Zamba2 at one period, RWKV-6 at 2 layers,
DeepSeek-V2 at 2 layers, TinyLlama with the int8 KV cache at 4 layers, at
full width; ``families_reference:rwkv6-3b`` one; each MoE model's expert ids
beside its logits), ``train_reference`` (3 AdamW steps of the TinyLlama
and DLRM smoke configs with float32 activations: losses and gradient
norms),
``autotune_incast8`` (``examples/cc_autotune.py``'s tunings),
``learn_step`` (``chip_smoke.LEARN_STEPS`` Adam steps of the ``mlp``
trainer's curriculum) and
``soft_grad`` (the soft cost and its gradient; ``soft_grad:clos32_2d``,
the default), ``predict32`` (the HLO-replay prediction on the 32-GPU
CLOS) and ``atlas_ring128`` (the committed atlas's lanes re-run, one
batch a policy; ``atlas_ring128:hpcc`` one policy, minutes each); all of
them by default.  Prints one JSON line per result;
``chip_smoke.py`` holds the port's card runs to these values
(``REFERENCE``, ``FIG12_REFERENCE``, ``DLRM_ITER_REFERENCE``,
``DLRM_REF_LOGITS``, ``SERVE_REF``, ``SLIDING_REF``, ``FAMILIES_REF``,
``TRAIN_REF``,
``AUTOTUNE_REFERENCE``,
``LEARN_REFERENCE``, ``SOFT_GRAD_REFERENCE`` and ``PREDICT_REFERENCE``
there; the atlas's cells are held to the committed CSV).
The 128-GPU runs take a few minutes each on a CPU, the DLRM logits about
four.

The reference's DLRM iteration salts its All-To-All's ECMP keys with
Python's ``hash(tag)``, which changes from process to process; this script
shadows ``hash`` in ``repro.core.workload`` with ``zlib.crc32``, the
port's salt, so that both build the same schedule (the reference's files
are not edited).
"""
from __future__ import annotations

import dataclasses
import json
import sys
import time
import warnings
import zlib
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np

import repro.core.workload as rworkload
from repro.configs import get_config
from repro.core.cc import ALL_POLICIES, get_policy
from repro.core.engine import EngineConfig, FabricParams
from repro.core.faults import FaultSpec
from repro.core.scenario import (CollectiveSpec, FabricSpec, IncastSpec,
                                 ScenarioSpec)
from repro.core.sweep import SweepRunner
from repro.configs import smoke_config
from repro.configs.base import TrainConfig
from repro.data.pipeline import dlrm_batch, lm_batch
from repro.kernels.embedding_bag.ops import embedding_bag_stacked
from repro.models.dlrm import DLRM
from repro.models.model_api import Model
from repro.train.optimizer import init_opt_state
from repro.train.train_step import make_train_step

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402  (numpy only at import: the shared inputs)

CFG = EngineConfig(dt=4e-6, max_steps=6000, max_extends=6, queue_stride=0,
                   step_impl="jnp")
PAPER_FABRIC = FabricSpec("clos", n_racks=8, nodes_per_rack=2,
                          gpus_per_node=8, oversubscription=2.0)
SCENARIOS = {
    "clos128_1d": (PAPER_FABRIC, CollectiveSpec("1d", 128e6),
                   ("pfc", "dcqcn", "hpcc")),
    "clos32_2d": (FabricSpec("clos", n_racks=2, nodes_per_rack=2,
                             gpus_per_node=8, oversubscription=2.0),
                  CollectiveSpec("2d", 128e6), ("dcqcn",)),
}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def collective_times(name: str, runner) -> None:
    fabric, workload, policies = SCENARIOS[name]
    for pol in policies:
        t0 = time.perf_counter()
        r = runner.run_spec(ScenarioSpec(fabric=fabric, workload=workload,
                                         policy=pol))
        emit({"scenario": name, "policy": pol,
              "completion_time": r.completion_time,
              "steps_run": r.meta["steps_run"], "finished": r.finished,
              "pause_frames": float(r.pause_count.sum()),
              "n_flows": r.meta["n_flows"],
              "cpu_seconds": time.perf_counter() - t0})


def batch_fig12(runner) -> None:
    """Fig 12's fabric sweep (``chip_smoke.FIG12_*``): lanes 0 and 8 as
    serial runs of the reference's jnp step, DCQCN."""
    cs = chip_smoke
    fab = FabricSpec("clos", n_racks=cs.FIG12_RACKS, nodes_per_rack=2,
                     gpus_per_node=8, oversubscription=cs.FIG12_OVERSUB)
    spec = ScenarioSpec(fabric=fab, workload=CollectiveSpec(
        "a2a", cs.FIG12_BYTES), policy=cs.FIG12_POLICY)
    topo, sched, pol = spec.build()
    pts = cs.fig12_points()
    for lane in cs.FIG12_CHECK_LANES:
        kmin, kmax, xoff = (float(v) for v in pts[lane])
        t0 = time.perf_counter()
        r = runner.run(topo, sched, pol, fabric_params=FabricParams(
            kmin=kmin, kmax=kmax, xoff=xoff))
        emit({"scenario": "batch_fig12", "lane": lane, "kmin": kmin,
              "kmax": kmax, "xoff": xoff, "policy": pol.name,
              "completion_time": r.completion_time,
              "pause_frames": float(r.pause_count.sum()),
              "finished": r.finished, "steps_run": r.meta["steps_run"],
              "n_flows": r.meta["n_flows"],
              "cpu_seconds": time.perf_counter() - t0})


def dlrm_iteration(runner) -> None:
    """pfc and dcqcn on the 128-GPU platform, 2D all-reduce."""
    rworkload.hash = lambda s: zlib.crc32(s.encode())
    topo = PAPER_FABRIC.build()
    gpus = list(range(PAPER_FABRIC.n_gpus))
    comm = rworkload.DLRMCommSpec(allreduce_algo="2d")
    n_flows = rworkload.build_dlrm_iteration(topo, gpus, comm=comm).n_flows
    for pol in ("pfc", "dcqcn"):
        t0 = time.perf_counter()
        rep = rworkload.simulate_dlrm_iteration(topo, gpus, get_policy(pol),
                                                comm=comm, cfg=CFG,
                                                runner=runner)
        emit({"scenario": "dlrm_iteration", "policy": pol,
              "iteration_time": rep.iteration_time,
              "exposed_comm": rep.exposed_comm,
              "pfc_pauses": rep.pfc_pauses, "finished": rep.finished,
              "n_flows": n_flows, "cpu_seconds": time.perf_counter() - t0})


class _PallasPerTable(DLRM):
    """The reference's DLRM with its Pallas embedding path (interpret
    mode), called one table at a time: interpret mode copies the whole
    padded table on every grid step, so 64 calls on one table each are 64
    times cheaper than one on the stack, and sum the same rows in the same
    order."""

    def _embed_bags(self, tables, idx):
        return jnp.concatenate(
            [embedding_bag_stacked(tables[t:t + 1], idx[:, t:t + 1])
             for t in range(tables.shape[0])], axis=1)


def dlrm_reference() -> None:
    """Table II widths with small tables, weights from
    ``chip_smoke.dlrm_numpy_params``, a batch from ``dlrm_batch``; the jnp
    embedding path and the Pallas one must give the same logits."""
    cfg = dataclasses.replace(get_config("dlrm"),
                              rows_per_table=chip_smoke.DLRM_REF_ROWS)
    defs = DLRM(cfg).param_defs()
    tree = chip_smoke.dlrm_numpy_params(
        {"tables": defs["tables"].shape,
         **{part: {k: d.shape for k, d in defs[part].items()}
            for part in ("bot", "top")}}, chip_smoke.DLRM_REF_SEED)
    params = {"tables": jnp.asarray(tree["tables"].view(jnp.bfloat16)),
              "bot": {k: jnp.asarray(v) for k, v in tree["bot"].items()},
              "top": {k: jnp.asarray(v) for k, v in tree["top"].items()}}
    batch = {k: jnp.asarray(v) for k, v in
             dlrm_batch(chip_smoke.DLRM_REF_SEED, 0,
                        chip_smoke.DLRM_REF_BATCH, cfg).items()}
    logits = {}
    for path, model in (("jnp", DLRM(cfg)),
                        ("pallas_interpret", _PallasPerTable(cfg))):
        t0 = time.perf_counter()
        out = jax.jit(model.forward)(params, batch)
        logits[path] = np.asarray(out.astype(jnp.float32))
        emit({"scenario": "dlrm_reference", "path": path,
              "cpu_seconds": time.perf_counter() - t0})
    if not np.array_equal(logits["jnp"], logits["pallas_interpret"]):
        raise AssertionError("the reference's jnp and Pallas embedding paths "
                             "disagree")
    emit({"scenario": "dlrm_reference", "rows_per_table": cfg.rows_per_table,
          "seed": chip_smoke.DLRM_REF_SEED, "batch": len(logits["jnp"]),
          "logits": [float(x) for x in logits["jnp"]]})


def serve_reference() -> None:
    """TinyLlama at full width and ``chip_smoke.SERVE_REF_LAYERS`` layers,
    weights from ``chip_smoke.transformer_numpy_params``, tokens from
    ``chip_smoke.serve_reference_tokens``: the prefill's last logits and 8
    teacher-forced decode steps' (``layers.decode_attention``, the serving
    path's own), at ``SERVE_REF_IDS``, with log-sum-exp, top-1 ids and
    top-2 margins."""
    cs = chip_smoke
    cfg = dataclasses.replace(get_config("tinyllama-1.1b"),
                              n_layers=cs.SERVE_REF_LAYERS)
    model = Model(cfg)
    shapes = jax.tree.map(lambda d: d.shape, model.param_defs(),
                          is_leaf=lambda x: hasattr(x, "axes"))
    t0 = time.perf_counter()
    bits = cs.transformer_numpy_params(shapes, cs.SERVE_REF_SEED, bf16=True)
    params = jax.tree.map(lambda a: jnp.asarray(a.view(jnp.bfloat16)), bits)
    del bits
    toks = cs.serve_reference_tokens(cfg.vocab)
    S = cs.SERVE_REF_PROMPT
    logits, cache = jax.jit(lambda p, b: model.prefill(
        p, b, max_len=S + cs.SERVE_REF_STEPS + 8))(
        params, {"tokens": jnp.asarray(toks[:, :S])})
    rows = [np.asarray(logits)]
    decode = jax.jit(model.decode_step)
    for t in range(S, S + cs.SERVE_REF_STEPS):
        logits, cache = decode(params, cache, jnp.asarray(toks[:, t:t + 1]))
        rows.append(np.asarray(logits))
    lg = np.stack(rows).astype(np.float64)             # (steps + 1, B, V)
    top2 = np.sort(lg, -1)[..., -2:]
    m = lg.max(-1, keepdims=True)
    lse = (m[..., 0] + np.log(np.exp(lg - m).sum(-1)))
    emit({"scenario": "serve_reference", "layers": cfg.n_layers,
          "seed": cs.SERVE_REF_SEED, "cpu_seconds": time.perf_counter() - t0,
          "logits": lg[:, :, cs.SERVE_REF_IDS].astype(np.float32).tolist(),
          "lse": lse.tolist(), "top1": lg.argmax(-1).tolist(),
          "margin": (top2[..., 1] - top2[..., 0]).tolist()})


def _hashed_reference(name: str, cfg) -> None:
    """``cfg`` at full width with ``chip_smoke.hashed_params`` from
    ``SERVE_REF_SEED`` (drawn with torch on the CPU, one leaf at a time:
    the bits the card draws), tokens from
    ``chip_smoke.serve_reference_tokens``: the prefill's last logits and
    ``SERVE_REF_STEPS`` teacher-forced decode steps', at
    ``SERVE_REF_IDS``, with log-sum-exp, top-1 ids and top-2 margins."""
    import torch
    cs = chip_smoke
    model = Model(cfg)
    shapes = jax.tree.map(lambda d: d.shape, model.param_defs(),
                          is_leaf=lambda x: hasattr(x, "axes"))
    t0 = time.perf_counter()
    count = [0]

    def leaf(name, shape, parent):
        count[0] += 1
        t = cs.hashed_bf16(shape, cs.SERVE_REF_SEED * 1_000_003 + count[0],
                           cs._init_std(name, shape, parent), "cpu",
                           mean=cs._LEAF_MEAN.get(name, 0.0))
        return jnp.asarray(t.view(torch.int16).numpy().view(jnp.bfloat16))

    def walk(node, name, parent):
        if isinstance(node, dict):
            return {k: walk(node[k], k, name) for k in sorted(node)}
        if isinstance(node, list):
            return [walk(v, name, parent) for v in node]
        return leaf(name, tuple(node), parent)
    params = walk(shapes, "", "")
    toks = cs.serve_reference_tokens(cfg.vocab)
    S = cs.SERVE_REF_PROMPT
    with _record_routing() as routes:
        logits, cache = jax.jit(lambda p, b: model.prefill(
            p, b, max_len=S + cs.SERVE_REF_STEPS + 8))(
            params, {"tokens": jnp.asarray(toks[:, :S])})
        rows = [np.asarray(logits)]
        n_moe = cfg.n_layers - cfg.first_dense_layers if cfg.moe else 0
        experts = [routes.take(n_moe)]
        decode = jax.jit(model.decode_step)
        for t in range(S, S + cs.SERVE_REF_STEPS):
            logits, cache = decode(params, cache,
                                   jnp.asarray(toks[:, t:t + 1]))
            rows.append(np.asarray(logits))
            experts.append(routes.take(n_moe))
    del params, cache
    lg = np.stack(rows).astype(np.float64)             # (steps + 1, B, V)
    top2 = np.sort(lg, -1)[..., -2:]
    m = lg.max(-1, keepdims=True)
    lse = (m[..., 0] + np.log(np.exp(lg - m).sum(-1)))
    emit({"scenario": "families_reference", "name": name,
          "layers": cfg.n_layers, "vocab": cfg.vocab,
          "seed": cs.SERVE_REF_SEED, "cpu_seconds": time.perf_counter() - t0,
          "logits": lg[:, :, cs.SERVE_REF_IDS].astype(
              np.float32).round(5).tolist(),
          "lse": lse.round(5).tolist(), "top1": lg.argmax(-1).tolist(),
          "margin": (top2[..., 1] - top2[..., 0]).round(5).tolist(),
          **({"experts": experts} if cfg.moe else {})})


class _record_routing:
    """While active, records the top-k experts the reference's router
    picks (``repro.models.moe._router`` wrapped in this process, through
    a host callback; the file is not edited), each token's ids sorted:
    ``take(n)`` returns the n calls since the last ``take``, each a
    (tokens, k) list, tokens in row-major order (the
    port's ``chip_smoke.capture_routing`` layout)."""

    def __enter__(self):
        import repro.models.moe as rmoe
        self.mod, self.orig, self.chunks = rmoe, rmoe._router, []

        def router(w, x, cfg):
            gates, idx = self.orig(w, x, cfg)
            jax.debug.callback(
                lambda i: self.chunks.append(np.sort(np.asarray(i), -1)),
                idx)
            return gates, idx
        rmoe._router = router
        return self

    def take(self, n_calls: int) -> list:
        """The ids recorded since the last ``take``: the prefill's or one
        decode step's ``n_calls`` MoE layer calls, each a (tokens, k)
        list (``moe_chunks`` splits a call's tokens in order, so the
        joined chunks are the calls one after the other)."""
        jax.effects_barrier()
        chunks, self.chunks = self.chunks, []
        if not n_calls:
            return []
        ids = np.concatenate(chunks) if chunks else np.zeros((0, 0), int)
        return [c.astype(int).tolist() for c in np.split(ids, n_calls)]

    def __exit__(self, *exc):
        self.mod._router = self.orig


def families_reference(names=None) -> None:
    """``chip_smoke.FAMILIES_REF_CUTS``' configs (Zamba2 at one period of
    6 Mamba-2 layers and the shared block, RWKV-6 at 2 layers, DeepSeek-V2
    at 2 layers, TinyLlama with the int8 KV cache at 4 layers) through
    ``_hashed_reference``; DeepSeek-V2's 2 layers hold about 11 GB of bf16
    weights here."""
    cs = chip_smoke
    for name in names or cs.FAMILIES_REF_CUTS:
        arch, layers, over = cs.FAMILIES_REF_CUTS[name]
        cfg = dataclasses.replace(get_config(arch), n_layers=layers, **over)
        _hashed_reference(name, cfg)


def train_reference(names=None) -> None:
    """``chip_smoke.TRAIN_REF_STEPS`` AdamW steps (``TRAIN_REF_TCFG``) of
    the TinyLlama and DLRM smoke configs with float32 activations,
    weights from ``chip_smoke.transformer_numpy_params`` /
    ``dlrm_numpy_params`` at ``TRAIN_REF_SEED``, batches from
    ``lm_batch``/``dlrm_batch`` (``TRAIN_REF_BATCH``): each step's loss
    and gradient norm."""
    cs = chip_smoke
    for name in names or cs.TRAIN_REF:
        cfg = smoke_config(name)
        if name == "dlrm":
            model = DLRM(cfg)
            defs = model.param_defs()
            tree = cs.dlrm_numpy_params(
                {"tables": defs["tables"].shape,
                 **{part: {k: d.shape for k, d in defs[part].items()}
                    for part in ("bot", "top")}}, cs.TRAIN_REF_SEED)
            params = {"tables": jnp.asarray(tree["tables"].view(jnp.bfloat16)),
                      **{part: jax.tree.map(jnp.asarray, tree[part])
                         for part in ("bot", "top")}}
        else:
            model = Model(cfg)
            shapes = jax.tree.map(lambda d: d.shape, model.param_defs(),
                                  is_leaf=lambda x: hasattr(x, "axes"))
            params = jax.tree.map(jnp.asarray, cs.transformer_numpy_params(
                shapes, cs.TRAIN_REF_SEED, bf16=False))
        model.compute_dtype = jnp.float32
        opt = init_opt_state(params, jnp.float32, keep_master=False)
        step = jax.jit(make_train_step(model, TrainConfig(
            **cs.TRAIN_REF_TCFG)))
        losses, norms = [], []
        for i in range(cs.TRAIN_REF_STEPS):
            b = (dlrm_batch(cs.TRAIN_REF_SEED, i, cs.TRAIN_REF_BATCH[name],
                            cfg) if name == "dlrm" else
                 lm_batch(cs.TRAIN_REF_SEED, i, *cs.TRAIN_REF_BATCH[name],
                          cfg.vocab))
            params, opt, m = step(params, opt,
                                  {k: jnp.asarray(v) for k, v in b.items()})
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
        emit({"scenario": "train_reference", "name": name,
              "seed": cs.TRAIN_REF_SEED, "loss": losses,
              "grad_norm": norms})


def sliding_reference(archs=None) -> None:
    """Gemma-2 and Gemma-3 at full width, depth one attention period, the
    window cut to ``chip_smoke.SLIDING_REF_WINDOW``, weights from
    ``chip_smoke.hashed_params`` (drawn with torch on the CPU: the same
    bits the card draws), tokens from
    ``chip_smoke.serve_reference_tokens``: the prefill's last
    logits and 8 teacher-forced decode steps' (``_ring_decode`` on the
    local layers, ``layers.decode_attention`` with the softcap on the
    global ones), at ``SERVE_REF_IDS``, with log-sum-exp, top-1 ids and
    top-2 margins."""
    import torch
    cs = chip_smoke
    for arch in archs or ("gemma2-9b", "gemma3-27b"):
        base = get_config(arch)
        cfg = dataclasses.replace(base, n_layers=len(base.attn_pattern),
                                  window=cs.SLIDING_REF_WINDOW)
        model = Model(cfg)
        shapes = jax.tree.map(lambda d: d.shape, model.param_defs(),
                              is_leaf=lambda x: hasattr(x, "axes"))
        t0 = time.perf_counter()
        leaves = cs.hashed_params(shapes, cs.SERVE_REF_SEED, "cpu")
        params = jax.tree.map(lambda t: jnp.asarray(
            t.view(torch.int16).numpy().view(jnp.bfloat16)), leaves)
        del leaves
        toks = cs.serve_reference_tokens(cfg.vocab)
        S = cs.SERVE_REF_PROMPT
        logits, cache = jax.jit(lambda p, b: model.prefill(
            p, b, max_len=S + cs.SERVE_REF_STEPS + 8))(
            params, {"tokens": jnp.asarray(toks[:, :S])})
        rows = [np.asarray(logits)]
        decode = jax.jit(model.decode_step)
        for t in range(S, S + cs.SERVE_REF_STEPS):
            logits, cache = decode(params, cache,
                                   jnp.asarray(toks[:, t:t + 1]))
            rows.append(np.asarray(logits))
        del params, cache
        lg = np.stack(rows).astype(np.float64)         # (steps + 1, B, V)
        top2 = np.sort(lg, -1)[..., -2:]
        m = lg.max(-1, keepdims=True)
        lse = (m[..., 0] + np.log(np.exp(lg - m).sum(-1)))
        emit({"scenario": "sliding_reference", "arch": arch,
              "layers": cfg.n_layers, "window": cfg.window,
              "vocab": cfg.vocab, "seed": cs.SERVE_REF_SEED,
              "cpu_seconds": time.perf_counter() - t0,
              "logits": lg[:, :, cs.SERVE_REF_IDS].astype(
                  np.float32).round(5).tolist(),
              "lse": lse.round(5).tolist(), "top1": lg.argmax(-1).tolist(),
              "margin": (top2[..., 1] - top2[..., 0]).round(5).tolist()})


def _emit_run(r, **tags) -> None:
    emit({**tags, "completion_time": r.completion_time,
          "status": str(r.status), "finished": r.finished,
          "steps_run": r.meta["steps_run"],
          "pause_frames": float(r.pause_count.sum()),
          "lost": None if r.lost is None else float(r.lost.sum()),
          "delivered": float(r.delivered.sum()),
          "n_flows": r.meta["n_flows"]})


def _fig13_spec(policy: str) -> ScenarioSpec:
    return ScenarioSpec(PAPER_FABRIC, CollectiveSpec(
        "1d", chip_smoke.FIG13_BYTES), policy)


def fault_grid_dcqcn(runner, lanes=None) -> None:
    """Fig 13's 8 lanes (``chip_smoke.fig13_lanes``) under DCQCN, each as
    a serial run of the reference's jnp step."""
    topo, sched, pol = _fig13_spec("dcqcn").build()
    for lane in lanes if lanes is not None else range(8):
        fault = chip_smoke.fig13_lane_fault(lane)
        t0 = time.perf_counter()
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            r = runner.run(topo, sched, pol, fault_spec=FaultSpec(**fault))
        _emit_run(r, scenario="fault_grid_dcqcn", lane=lane, fault=fault,
                  cpu_seconds=time.perf_counter() - t0)


def faults_clos32(runner) -> None:
    """The 32-GPU 2D all-reduce under DCQCN with
    ``chip_smoke.FAULTS32_FAULT``."""
    fabric, workload, _ = SCENARIOS["clos32_2d"]
    t0 = time.perf_counter()
    r = runner.run_spec(ScenarioSpec(
        fabric, workload, "dcqcn",
        fault_spec=FaultSpec(**chip_smoke.FAULTS32_FAULT)))
    _emit_run(r, scenario="faults_clos32", policy="dcqcn",
              cpu_seconds=time.perf_counter() - t0)


def mlp_clos128(runner, which=("lossless", "fig13_gbn")) -> None:
    """``mlp`` on clos128_1d (lossless), and on Fig 13's scenario with
    ``FaultSpec.lossy_roce(1e-5, "gbn")``."""
    for w in which:
        t0 = time.perf_counter()
        if w == "lossless":
            fabric, workload, _ = SCENARIOS["clos128_1d"]
            spec = ScenarioSpec(fabric, workload, "mlp")
        else:
            spec = dataclasses.replace(
                _fig13_spec("mlp"),
                fault_spec=FaultSpec.lossy_roce(1e-5, "gbn"))
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            r = runner.run_spec(spec)
        _emit_run(r, scenario="mlp_clos128", run=w,
                  cpu_seconds=time.perf_counter() - t0)


def mlp_heldout16() -> None:
    """examples/learn_cc.py's held-out 16-way incast: every registered
    policy in one ``run_policy_axis`` (the reference's vmapped batch)."""
    cs = chip_smoke
    cfg = EngineConfig(**cs.HELDOUT_CFG, step_impl="jnp")
    spec = ScenarioSpec(FabricSpec(family="single", n_racks=1,
                                   nodes_per_rack=1,
                                   gpus_per_node=cs.HELDOUT_GPUS),
                        IncastSpec(cs.HELDOUT_SENDERS, cs.HELDOUT_BYTES),
                        "mlp")
    topo, sched, _ = spec.build()
    t0 = time.perf_counter()
    batch = SweepRunner(cfg).run_policy_axis(topo, sched, list(ALL_POLICIES))
    status = batch.lane_status()
    for i, pol in enumerate(batch.policy_axis):
        emit({"scenario": "mlp_heldout16", "policy": pol,
              "completion_time": float(batch.completion_time[i]),
              "status": str(status[i]),
              "pause_frames": float(batch.pause_count[i].sum()),
              "n_flows": sched.n_flows,
              "cpu_seconds": time.perf_counter() - t0})


def autotune_incast8() -> None:
    """``examples/cc_autotune.py``'s two tunings (CC keys at population
    4, fabric keys at population 3) for ``chip_smoke.AUTOTUNE_RUNS``'s
    descent steps: every step's history record, baseline and tuned
    cost."""
    from repro.core.autotune import autotune_spec
    from repro.core.cc import make_dcqcn
    cs = chip_smoke
    spec = ScenarioSpec(FabricSpec("single", 1, 1, cs.AUTOTUNE_GPUS),
                        IncastSpec(cs.AUTOTUNE_GPUS - 1, cs.AUTOTUNE_BYTES),
                        make_dcqcn())
    for run, kw in cs.AUTOTUNE_RUNS.items():
        t0 = time.perf_counter()
        res = autotune_spec(spec, cfg=EngineConfig(**cs.AUTOTUNE_CFG), **kw)
        emit({"scenario": "autotune_incast8", "run": run,
              "history": res.history, "baseline_cost": res.baseline_cost,
              "tuned_cost": res.tuned_cost,
              "cpu_seconds": time.perf_counter() - t0})


def learn_step() -> None:
    """``chip_smoke.LEARN_STEPS`` Adam steps of the trainer on
    ``curriculum_default()`` with
    ``default_engine_cfg()``, the default corners, remat, seed 0: each
    step's per-task costs, loss and gradient norm, and the 40 weights."""
    import repro.learn.train  # noqa: F401  (the package exports train)
    tr = sys.modules["repro.learn.train"]
    cs = chip_smoke
    t0 = time.perf_counter()
    res = tr.train(tr.TrainConfig(steps=cs.LEARN_STEPS, seed=0),
                   engine_cfg=tr.default_engine_cfg())
    emit({"scenario": "learn_step",
          "history": [{k: h[k] for k in ("loss", "per_task", "grad_norm")}
                      for h in res.history],
          "weights": res.weights, "cpu_seconds": time.perf_counter() - t0})


def soft_grad(name: str) -> None:
    """The soft cost of a collective scenario under DCQCN and its gradient
    w.r.t. ``chip_smoke.SOFT_GRAD_KEYS`` (remat, the fixed-length scan of
    ``CFG``)."""
    from repro.core.engine import Simulator
    cs = chip_smoke
    fab, wl, _ = SCENARIOS[name]
    topo, sched, pol = ScenarioSpec(fab, wl, "dcqcn").build()
    sim = Simulator(topo, sched, pol, CFG)
    cost = sim.soft_cost_fn(remat=True)
    params = dict(pol.params)
    cc_keys = [k for k in cs.SOFT_GRAD_KEYS if not k.startswith("fabric.")]

    def f(p, fab_p):
        return cost(dict(params, **p), fab_p)

    t0 = time.perf_counter()
    v, (g, gf) = jax.jit(jax.value_and_grad(f, argnums=(0, 1)))(
        {k: jnp.float32(params[k]) for k in cc_keys}, FabricParams())
    grads = {k: float(g[k]) for k in cc_keys}
    grads.update({k: float(getattr(gf, k.split(".")[1]))
                  for k in cs.SOFT_GRAD_KEYS if k.startswith("fabric.")})
    emit({"scenario": f"soft_grad_{name}", "soft_cost": float(v),
          "grad": grads, "cpu_seconds": time.perf_counter() - t0})


def atlas_ring128(policies=None) -> None:
    """``experiments/atlas/atlas_paper_ring128.csv``'s lanes, re-run by
    the reference as one ``run_batch`` per policy (its key parameter x
    the fabric points, ``chip_smoke.atlas_lanes``): each lane's
    completion, PAUSE frames and status, beside the committed CSV's."""
    from repro.core.collectives import allreduce_ring
    cs = chip_smoke
    topo = PAPER_FABRIC.build()
    sched = allreduce_ring(topo, list(range(PAPER_FABRIC.n_gpus)),
                           cs.ATLAS_BYTES, n_chunks=1)
    runner = SweepRunner(EngineConfig(**cs.ATLAS_CFG, step_impl="jnp"))
    csv_rows = cs.atlas_csv()
    for pol in policies or cs.ATLAS_KEY_PARAM:
        key, vals, fab = cs.atlas_lanes(get_policy(pol))
        t0 = time.perf_counter()
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            batch = runner.run_batch(topo, sched, pol, {key: vals},
                                     stacked_fabric=fab)
        status = batch.lane_status()
        want = [r for r in csv_rows if r["policy"] == pol]
        for i in range(batch.n):
            emit({"scenario": "atlas_ring128", "policy": pol, "lane": i,
                  "completion_ms": float(batch.completion_time[i]) * 1e3,
                  "pfc_frames": float(batch.pause_count[i].sum()),
                  "lane_status": str(status[i]),
                  "csv": {k: want[i][k] for k in ("completion_ms",
                                                  "pfc_frames",
                                                  "lane_status")},
                  "n_flows": sched.n_flows,
                  "cpu_seconds": time.perf_counter() - t0})


def predict32() -> None:
    """``predict_policies`` on ``chip_smoke.PREDICT_OPS`` over the
    reference's default 32-GPU CLOS, every policy, serial runs."""
    from repro.core.hlo_comm import CollectiveOp
    from repro.core.predict import predict_policies
    cs = chip_smoke
    t0 = time.perf_counter()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        reps = predict_policies([CollectiveOp(*op) for op in cs.PREDICT_OPS],
                                cs.PREDICT_MESH, list(cs.PREDICT_AXES),
                                batched=False)
    emit({"scenario": "predict32",
          "reports": {r.policy: {"comm_time": r.comm_time,
                                 "pauses": r.pauses, "finished": r.finished}
                      for r in reps},
          "cpu_seconds": time.perf_counter() - t0})


def main(names):
    emit({"jax": jax.__version__, "numpy": np.__version__})
    runner = SweepRunner(CFG)
    for name in names or [*SCENARIOS, "batch_fig12", "dlrm_reference",
                          "dlrm_iteration", "serve_reference",
                          "sliding_reference", "families_reference",
                          "train_reference",
                          "fault_grid_dcqcn", "faults_clos32",
                          "mlp_clos128", "mlp_heldout16",
                          "autotune_incast8", "learn_step", "soft_grad",
                          "predict32", "atlas_ring128"]:
        # fault_grid_dcqcn:3,5 runs those lanes only; mlp_clos128:lossless
        # (or :fig13_gbn) one of its two runs
        name, _, arg = name.partition(":")
        if name in SCENARIOS:
            collective_times(name, runner)
        elif name == "fault_grid_dcqcn":
            fault_grid_dcqcn(runner, [int(i) for i in arg.split(",")]
                             if arg else None)
        elif name == "faults_clos32":
            faults_clos32(runner)
        elif name == "mlp_clos128":
            mlp_clos128(runner, (arg,) if arg else ("lossless",
                                                    "fig13_gbn"))
        elif name == "mlp_heldout16":
            mlp_heldout16()
        elif name == "autotune_incast8":
            autotune_incast8()
        elif name == "learn_step":
            learn_step()
        elif name == "soft_grad":
            soft_grad(arg or "clos32_2d")
        elif name == "predict32":
            predict32()
        elif name == "atlas_ring128":
            atlas_ring128(arg.split(",") if arg else None)
        elif name == "batch_fig12":
            batch_fig12(runner)
        elif name == "dlrm_iteration":
            dlrm_iteration(runner)
        elif name == "dlrm_reference":
            dlrm_reference()
        elif name == "serve_reference":
            serve_reference()
        elif name == "sliding_reference":
            sliding_reference(arg.split(",") if arg else None)
        elif name == "families_reference":
            families_reference(arg.split(",") if arg else None)
        elif name == "train_reference":
            train_reference(arg.split(",") if arg else None)
        else:
            raise SystemExit(f"unknown scenario {name!r}")


if __name__ == "__main__":
    main(sys.argv[1:])
