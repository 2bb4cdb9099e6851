"""Dry run of an (arch x shape x mesh) cell: one rank's train step,
prefill or decode step traced at full width on the ``meta`` device (port
of ``repro/launch/dryrun.py``, which lowers and compiles each cell on 512
forced host devices).

Usage:
  python -m repro_torch.launch.dryrun --arch tinyllama-1.1b --shape train_4k
  python -m repro_torch.launch.dryrun --arch ... --shape ... --multi-pod
  python -m repro_torch.launch.dryrun --all    # every cell, subprocesses

The port has no compiler, so a cell is one rank's step run under a
``comm.RecordingMesh`` (rank 0 of ``make_production_mesh``'s mesh, no
process group) on ``meta`` tensors: no card, no process group, no memory.
Running on ``meta`` is the design, the counterpart of the reference's
forced host devices.  A step whose body reads a value on the host
(``.item()``, a shape that depends on the data) cannot trace there: the
cell raises, and ``--all`` lists it among the failures.

The record's keys are the reference's:

* ``n_params``: the parameter count;
* ``memory.argument_bytes``: this rank's blocks of the parameters, the
  optimizer state (ZeRO-1) and the batch, or of the parameters, the
  decode cache and the tokens (``model_api.cache_block_shape``: a global
  layer's K/V split along the sequence where the cell's cache rules split
  it, ``long_500k`` and ``seqcache``);
  ``memory.output_bytes``, ``temp_bytes`` and ``peak_bytes`` are null:
  the port has no compiler memory plan, and they are not estimated;
* ``flops``: the rank's dot FLOPs (``torch.utils.flop_counter``: matmuls
  and einsums, forward, recomputation and backward), the counterpart of
  ``hlo_counter``'s trip-corrected dot FLOPs;
* ``bytes_accessed``: every ATen op's inputs and outputs (views free),
  the counterpart of ``hlo_counter``'s per-touch bound without fusion;
  ``bytes_floor``: the arguments once plus every op's output once;
* ``collective_bytes``: this rank's input buffers by HLO kind (the
  operand bytes ``hlo_counter`` sums), every trip of a Python loop
  recorded (no trip correction); ``collective_bytes_raw``:
  ``hlo_comm.summarize`` of the records as ``CollectiveOp``s (each op's
  result bytes, as ``hlo_comm.extract`` reads them);
  ``collective_bytes_handoff``: a prefill's hand-off of its K/V into a
  cache split along the sequence (``comm``'s ``"handoff"`` section),
  kept out of the two above: the reference's compiled prefill leaves
  its cache unconstrained and reshards it at the jit boundary, so a
  prefill cell's ``collective_bytes`` under ``seqcache`` equal the same
  cell's without it;
* ``lower_s`` and ``compile_s`` are null (nothing is lowered or
  compiled); ``trace_s`` is the host seconds of the traced step;
* ``gathered_leaves``: the leaves the rank gathers whole for the compute
  (``Model.gathered_leaves``).

``REPRO_OPT`` takes the reference's knobs (flash, kvquant, gradspec,
cap1, tpmoe, chunks4, rwkvchunk, seqp, seqcache).  ``--all`` writes
``experiments/dryrun_torch/<tag>.json`` (never ``experiments/dryrun/``,
the reference's).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.common import comm
from repro_torch.common.pytree import (count_params, flatten_with_paths,
                                       map_with_specs)
from repro_torch.common.sharding import shard_shape
from repro_torch.core.hlo_comm import CollectiveOp, summarize

OUT_DIR = os.path.join("experiments", "dryrun_torch")
OPTS = {"flash": {"flash_attention": True}, "kvquant": {"kv_quant_int8": True},
        "cap1": {"capacity_factor": 1.0}, "tpmoe": {"moe_impl": "tp"},
        "chunks4": {"moe_chunks": 4}, "rwkvchunk": {"rwkv_chunk": 32},
        "seqp": {"seq_parallel": True}, "seqcache": {"decode_seq_shard": True}}


def _nbytes(t) -> int:
    return t.numel() * t.element_size() if isinstance(t, torch.Tensor) else 0


class ByteCounter(TorchDispatchMode):
    """Bytes of every ATen op's tensors: ``touched`` its inputs and
    outputs, ``written`` its outputs (views count nothing)."""

    def __init__(self):
        super().__init__()
        self.touched = 0
        self.written = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not func.is_view:
            ins = sum(_nbytes(t) for t in tree_flatten((args, kwargs))[0])
            outs = sum(_nbytes(t) for t in tree_flatten(out)[0])
            self.touched += ins + outs
            self.written += outs
        return out


def collective_ops(records, mesh) -> tuple:
    """The records as ``hlo_comm.CollectiveOp``s (the result's bytes, as
    ``hlo_comm.extract`` reads a partitioned HLO; identical records merged
    into one op's ``count``, in order of first use) and each op's mesh axis
    (the first of its axes), the inputs of ``core.predict.predict_policies``
    in place of the HLO replay."""
    merged: dict = {}
    for r in records:
        key = (r.hlo_kind, r.out_bytes, r.group_size, r.n_groups, r.axes[0])
        merged[key] = merged.get(key, 0) + 1
    ops = [CollectiveOp(k, b, g, n, count=c)
           for (k, b, g, n, _), c in merged.items()]
    axis_of_op = [mesh.axis_names.index(a) for (*_, a) in merged]
    return ops, axis_of_op


def step_records(records, section: str | None = None) -> list:
    """The records made outside any ``comm.section`` (the step's own), or
    inside ``section``."""
    return [r for r in records if r.section == section]


def collective_bytes(records) -> dict:
    """This rank's input bytes by HLO kind, with ``total``."""
    out: dict = {}
    for r in records:
        out[r.hlo_kind] = out.get(r.hlo_kind, 0.0) + r.bytes
    out["total"] = sum(out.values())
    return out


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def _blocks(defs, specs, mesh):
    """This rank's block of every ``ParamDef`` under its spec, on meta."""
    return map_with_specs(lambda d, sp, _: _meta(
        shard_shape(d.shape, sp, mesh), d.dtype), defs, specs)


def _tree_bytes(tree) -> int:
    return sum(_nbytes(x) for _, x in flatten_with_paths(tree))


def apply_opts(cfg, opts) -> tuple:
    """``cfg`` with ``REPRO_OPT``'s config knobs; whether ``gradspec``."""
    repl = {}
    for o in opts:
        repl.update(OPTS.get(o, {}))
    return (dataclasses.replace(cfg, **repl) if repl else cfg,
            "gradspec" in opts)


def trace_step(model, shape, mesh, gradspec: bool = False,
               tcfg=None, max_len: int | None = None) -> dict:
    """One rank's step of ``shape`` (a ``ShapeConfig``) for ``model`` (on
    ``meta`` over ``mesh``, a ``RecordingMesh``) and its arguments' bytes:
    ``{"run", "argument_bytes", "microbatch"}``; ``run()`` runs it.  A
    train step takes ``tcfg`` (by default the reference's microbatch
    rule), its gradients reduced into the moments' layout with
    ``gradspec``; a prefill builds a cache of ``max_len`` positions (by
    default the prompt's) under the cell's cache rules."""
    from repro_torch.configs.base import TrainConfig
    from repro_torch.models.model_api import cache_block_shape
    from repro_torch.train.optimizer import DTYPES
    from repro_torch.train.train_step import (init_mesh_opt_state,
                                              make_train_step, mesh_layout)
    cfg = model.cfg
    defs = model.param_defs()
    params = _blocks(defs, model.param_specs(), mesh)
    args = _tree_bytes(params)
    B, S = shape.global_batch, shape.seq_len
    b_specs = model.batch_pspecs(shape)
    micro = None
    if shape.kind == "train":
        if tcfg is None:
            n_bshard = mesh.size // mesh.shape.get("model", 1)
            per_dev = 2 if cfg.d_model >= 5000 else 4
            tcfg = TrainConfig(microbatch=min(B, per_dev * n_bshard))
        micro = tcfg.microbatch
        layout = mesh_layout(model, tcfg)
        opt = init_mesh_opt_state(params, layout, DTYPES[cfg.opt_dtype],
                                  model.param_dtype != torch.float32)
        args += _tree_bytes(opt)
        grad_specs = layout.moments if gradspec else None
        step = make_train_step(model, tcfg, grad_specs)
        batch = {k: _meta(s.shape, s.dtype)
                 for k, s in model.input_specs(shape).items()}
        args += sum(_nbytes(_meta(shard_shape(v.shape, b_specs[k], mesh),
                                  v.dtype)) for k, v in batch.items())

        def run():
            return step(params, opt, batch)
    elif shape.kind == "prefill":
        batch = {k: _meta(shard_shape(s.shape, b_specs[k], mesh), s.dtype)
                 for k, s in model.input_specs(shape).items()}
        args += sum(_nbytes(v) for v in batch.values())

        def run():
            with torch.no_grad():
                return model.prefill(params, batch, max_len, shape=shape)
    else:
        cdefs = model.cache_defs(B, S)
        layers = map_with_specs(lambda d, sp, _: _meta(cache_block_shape(
            d, sp, mesh), d.dtype), cdefs["layers"],
            b_specs["cache"]["layers"])
        tokens = _meta(shard_shape((B, 1), b_specs["tokens"], mesh),
                       torch.int32)
        # the last position: the step reads the whole cache, as the
        # reference's masked decode does
        cache = {"layers": layers, "pos": S - 1,
                 "seq": model.cache_seq_axes(shape)}
        args += _tree_bytes(layers) + 4 + _nbytes(tokens)

        def run():
            with torch.no_grad():
                return model.decode_step(params, cache, tokens)
    return {"run": run, "argument_bytes": args, "microbatch": micro}


def dryrun_cell(arch: str, shape_name: str, multi_pod: bool,
                verbose: bool = True, *, cfg=None, shape=None,
                mesh_shape: tuple | None = None, rank: int = 0) -> dict:
    """The record of one cell (the module docstring).  ``cfg``, ``shape``
    and ``mesh_shape`` (sizes over ``("data", "model")``, or with
    ``"pod"`` first when three) stand in for the arch's config, the named
    shape cell and the production mesh (the parity tests' smoke cells);
    ``rank`` is the mesh position traced."""
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import ALL_SHAPES, skip_reason
    from repro_torch.models.model_api import Model
    shape = shape or ALL_SHAPES[shape_name]
    reason = skip_reason(arch, shape.name)
    if reason:
        return {"arch": arch, "shape": shape.name, "skipped": reason}
    if mesh_shape is None:
        mesh_shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model")[-len(mesh_shape):]
    mesh = comm.RecordingMesh(mesh_shape, axes, rank)
    opts = set(filter(None, os.environ.get("REPRO_OPT", "").split(",")))
    cfg, gradspec = apply_opts(cfg or get_config(arch), opts)
    model = Model(cfg, device="meta", mesh=mesh)
    t0 = time.perf_counter()
    cell = trace_step(model, shape, mesh, gradspec)
    comm.reset_counters()
    with FlopCounterMode(display=False) as flops, ByteCounter() as nb:
        cell["run"]()
    trace_s = time.perf_counter() - t0
    mine = step_records(mesh.records)
    ops, _ = collective_ops(mine, mesh)
    coll = collective_bytes(mine)
    calls: dict = {}
    for r in mine:
        calls[r.kind] = calls.get(r.kind, 0) + 1
    out = {
        "arch": arch,
        "shape": shape.name,
        "mesh": "x".join(str(s) for s in mesh_shape),
        "n_devices": mesh.size,
        "n_params": count_params(model.param_defs()),
        "kind": shape.kind,
        "memory": {"argument_bytes": cell["argument_bytes"],
                   "output_bytes": None, "temp_bytes": None,
                   "peak_bytes": None},
        "flops": float(flops.get_total_flops()),
        "bytes_accessed": float(nb.touched),
        "bytes_floor": float(cell["argument_bytes"] + nb.written),
        "collective_bytes": coll,
        "collective_bytes_raw": summarize(ops),
        "collective_bytes_handoff": collective_bytes(
            step_records(mesh.records, "handoff")),
        "collective_calls": calls,
        "microbatch": cell["microbatch"],
        "gathered_leaves": model.gathered_leaves(),
        "lower_s": None,
        "compile_s": None,
        "trace_s": trace_s,
        "rank": rank,
        "device": "meta",
    }
    if verbose:
        print("memory: argument_bytes", out["memory"]["argument_bytes"])
        print("flops=%.3e bytes=%.3e" % (out["flops"], out["bytes_accessed"]))
        print("collectives:", {k: f"{v:.3e}" for k, v in coll.items()})
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    if args.all:
        from repro_torch.configs import ARCHS
        from repro_torch.configs.shapes import shapes_for
        os.makedirs(OUT_DIR, exist_ok=True)
        failures = []
        t_all = time.perf_counter()
        for arch in ARCHS:
            for shape in shapes_for(arch):
                for mp in (False, True):
                    tag = f"{arch}_{shape.name}_{'mp' if mp else 'sp'}"
                    out = os.path.join(OUT_DIR, f"{tag}.json")
                    if os.path.exists(out):
                        continue
                    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                           "--arch", arch, "--shape", shape.name, "--out",
                           out]
                    if mp:
                        cmd.append("--multi-pod")
                    print(">>>", tag, flush=True)
                    t0 = time.perf_counter()
                    r = subprocess.run(cmd, capture_output=True, text=True)
                    print(f"    {time.perf_counter() - t0:.1f} s", flush=True)
                    if r.returncode != 0:
                        failures.append((tag, r.stderr[-2000:]))
                        print("FAIL", tag, r.stderr[-800:], flush=True)
        print(f"done in {time.perf_counter() - t_all:.1f} s; "
              f"{len(failures)} failures")
        for tag, _ in failures:
            print("failed:", tag)
        sys.exit(1 if failures else 0)

    if not (args.arch and args.shape):
        ap.error("--arch and --shape, or --all")
    res = dryrun_cell(args.arch, args.shape, args.multi_pod)
    blob = json.dumps(res, indent=1, default=str)
    print(blob)
    if args.out:
        with open(args.out, "w") as f:
            f.write(blob)


if __name__ == "__main__":
    main()
