"""The smoke TinyLlama's ZeRO-1 step on (data=2, model=2), the port on 4
CPU ranks over ``gloo`` beside the JAX reference jit-ed on 4 forced host
devices (``tests/_mesh_reference.py lm_tp_comm``): each case's per-rank
dot FLOPs (``FlopCounterMode``) against the reference's per-device
``hlo_counter`` FLOPs, and the bytes of a step by collective kind (the
port's ``comm.counters()`` of step 1, named as the HLO names them)
beside the reference's ``hlo_counter`` collective bytes.  CPU only; the
reference needs jax.

    PYTHONPATH=src python scripts/mesh_tp_report.py [--port-src DIR]

``--port-src`` runs another tree's ``repro_torch`` (e.g. a parent
commit's ``src`` from ``git archive``) against the same reference.
Prints one JSON line a case.
"""
import argparse
import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CASES = [(sp, mb) for sp in (False, True) for mb in (None, 2)]
HLO = {"psum": "all-reduce", "pmax": "all-reduce",
       "all_gather": "all-gather", "psum_scatter": "reduce-scatter",
       "all_to_all": "all-to-all", "ppermute": "collective-permute"}


def rank_fn(rank, npz):
    """Every case's step 1 on this rank: its FLOPs and counters."""
    import dataclasses

    import numpy as np
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.common import comm
    from repro_torch.common.pytree import flatten_with_paths, unflatten_like
    from repro_torch.common.sharding import flatten_specs, local_shard
    from repro_torch.configs import smoke_config
    from repro_torch.configs.base import TrainConfig
    from repro_torch.data import lm_batch
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import Model
    from repro_torch.train.train_step import (init_mesh_opt_state,
                                              make_train_step, mesh_layout)
    torch.set_num_threads(1)
    d = np.load(npz)
    out = {}
    for sp, mb in CASES:
        cfg = dataclasses.replace(smoke_config("tinyllama-1.1b"),
                                  seq_parallel=sp)
        mesh = make_mesh((2, 2), ("data", "model"))
        model = Model(cfg, device="cpu", mesh=mesh)
        model.compute_dtype = torch.float32
        defs = model.param_defs()
        tree = unflatten_like(defs, [torch.from_numpy(d["w." + n]) for n, _
                                     in flatten_with_paths(defs)])
        specs = model.param_specs()
        params = unflatten_like(tree, [
            local_shard(x, s, mesh).clone() for (_, x), (_, s) in
            zip(flatten_with_paths(tree), flatten_specs(specs))])
        tcfg = TrainConfig(microbatch=mb, learning_rate=1e-2,
                           warmup_steps=2, total_steps=10)
        layout = mesh_layout(model, tcfg)
        opt = init_mesh_opt_state(params, layout, keep_master=False)
        step = make_train_step(model, tcfg, layout.moments)
        comm.reset_counters()
        with FlopCounterMode(display=False) as fc:
            _, _, m = step(params, opt, lm_batch(0, 0, 4, 32, cfg.vocab))
        by_kind = {}
        for kind, c in comm.counters().items():
            if c["calls"]:
                by_kind[HLO[kind]] = by_kind.get(HLO[kind], 0) + c["bytes"]
        out[f"sp{int(sp)}.mb{mb}"] = {"flops": fc.get_total_flops(),
                                      "loss": float(m["loss"]),
                                      "bytes": by_kind}
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--port-src", default=str(ROOT / "src"))
    args = ap.parse_args()
    with tempfile.TemporaryDirectory() as tmp:
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
        r = subprocess.run([sys.executable, str(ROOT / "tests" /
                                                "_mesh_reference.py"), tmp,
                            "lm_tp_comm"], capture_output=True, text=True,
                           env=env)
        if r.returncode:
            raise SystemExit(r.stderr[-3000:])
        import numpy as np
        d = np.load(Path(tmp) / "lm_tp_comm.npz")
        ref = {k[:-len(".comm")]: json.loads(str(d[k])) for k in d.files
               if k.endswith(".comm")}
        sys.path.insert(0, args.port_src)
        os.environ["PYTHONPATH"] = args.port_src + os.pathsep + str(
            Path(__file__).resolve().parent)
        from repro_torch.launch import mesh as lmesh
        res = lmesh.launch(rank_fn, 4, devices=["cpu"] * 4,
                           args=(str(Path(tmp) / "lm_tp_comm.npz"),),
                           join_s=600)
    for name, want in ref.items():
        flops = [r[name]["flops"] for r in res]
        print(json.dumps({
            "case": name, "port_src": args.port_src,
            "flops_by_rank": flops, "reference_flops": want["totals"]["flops"],
            "ratio": max(flops) / want["totals"]["flops"],
            "loss": res[0][name]["loss"],
            "bytes_by_kind_rank0": res[0][name]["bytes"],
            "reference_bytes_by_kind": want["totals"]["coll"]}))


if __name__ == "__main__":
    main()
