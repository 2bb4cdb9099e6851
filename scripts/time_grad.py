#!/usr/bin/env python3
"""Time the differentiable simulator on the card: the soft cost of the
128-GPU 1D all-reduce under DCQCN (``chip_smoke.py``'s scenario, cut to
``--steps`` steps) and its gradient w.r.t. ``rai_frac`` and ``g``, with
``remat`` at each of ``--chunks`` segment lengths.  One JSON line per
chunk: forward and backward host ms per step and the peak bytes the
gradient held above the start (``torch.cuda.max_memory_allocated``).

    python3 scripts/time_grad.py [--steps 300] [--chunks 100 300]

Needs one CUDA card.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

SRC = Path(__file__).resolve().parents[1] / "src"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--chunks", type=int, nargs="+", default=[100, 300])
    args = ap.parse_args(argv)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("time_grad: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    from repro_torch.core import (CollectiveSpec, EngineConfig, FabricSpec,
                                  ScenarioSpec, Simulator)
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    spec = ScenarioSpec(FabricSpec("clos", n_racks=8, nodes_per_rack=2,
                                   gpus_per_node=8, oversubscription=2.0),
                        CollectiveSpec("1d", 128e6), "dcqcn")
    topo, sched, pol = spec.build()
    for chunk in args.chunks:
        sim = Simulator(topo, sched, pol, EngineConfig(
            dt=4e-6, max_steps=args.steps, max_extends=0, queue_stride=0,
            chunk_steps=chunk))
        leaves = {k: torch.tensor(np.float32(pol.params[k]), device="cuda",
                                  requires_grad=True)
                  for k in ("rai_frac", "g")}
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        v = sim.soft_cost_fn(remat=True)(leaves)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        torch.autograd.grad(v, list(leaves.values()), allow_unused=True)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        print(json.dumps({
            "scenario": "clos128_1d", "gpu": gpu, "steps": args.steps,
            "chunk_steps": chunk,
            "fwd_host_ms_per_step": (t1 - t0) / args.steps * 1e3,
            "bwd_host_ms_per_step": (t2 - t1) / args.steps * 1e3,
            "peak_bytes": torch.cuda.max_memory_allocated() - base}),
            flush=True)
        del v
    return 0


if __name__ == "__main__":
    sys.exit(main())
