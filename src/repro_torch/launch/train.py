"""End-to-end training entry point (port of ``repro/launch/train.py``, same
arguments and output line).

  PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama-1.1b \\
      --smoke --steps 200 --batch 8 --seq 128 [--device cpu]

Trains on the card unless ``--device cpu``.  ``--smoke`` takes the
reduced same-family config; without it the full config is built.
``--arch`` takes ``dlrm`` and every architecture of
``repro_torch.configs.ARCHS``.  Weights are drawn from seed 0 on the
device; batches are ``lm_batch``/``dlrm_batch`` of seed 0, one per step.
Fault tolerance: checkpoint/restart through ``ft.TrainRunner`` under
``--ckpt-dir`` (by default ``repro_torch_ckpt`` in the temporary
directory; a run resumes from the latest checkpoint there); ``--fail-at
N`` injects one failure at step N to exercise the restart.
``--metrics-out PATH`` writes the metrics log (one JSON line a step, the
wall time left out) for a comparison of two runs.
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile

import torch

from repro_torch.configs import build_model, get_config, smoke_config
from repro_torch.configs.base import TrainConfig
from repro_torch.data.pipeline import dlrm_batch, lm_batch
from repro_torch.ft.fault_tolerance import (FailureInjector, RunnerConfig,
                                            StragglerDetector, TrainRunner)
from repro_torch.train.train_step import init_train_state, make_train_step


def main(argv=None) -> dict:
    """Train; returns the runner, the model and the final state (for
    callers that drive the entry point in-process)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-2)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--fail-at", type=int, default=-1)
    ap.add_argument("--microbatch", type=int, default=None)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--metrics-out", default=None)
    args = ap.parse_args(argv)

    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    model = build_model(cfg, device=args.device, seed=0)
    tcfg = TrainConfig(learning_rate=args.lr, warmup_steps=10,
                       total_steps=args.steps, microbatch=args.microbatch)
    gen = torch.Generator(device=model.device).manual_seed(0)
    params, opt_state = init_train_state(model, gen, tcfg)
    step_fn = make_train_step(model, tcfg)
    is_dlrm = cfg.family == "recsys"

    def make_batch(step):
        if is_dlrm:
            b = dlrm_batch(0, step, args.batch, cfg)
        else:
            b = lm_batch(0, step, args.batch, args.seq, cfg.vocab)
        return {k: torch.as_tensor(v, device=model.device)
                for k, v in b.items()}

    runner = TrainRunner(
        RunnerConfig(ckpt_dir=args.ckpt_dir,
                     checkpoint_every=args.ckpt_every),
        step_fn, make_batch,
        injector=FailureInjector((args.fail_at,) if args.fail_at >= 0
                                 else ()),
        straggler=StragglerDetector(),
    )
    params, opt_state = runner.run(params, opt_state, args.steps)
    losses = [m["loss"] for m in runner.metrics_log]
    print(f"steps={len(runner.metrics_log)} restarts={runner.restarts} "
          f"first_loss={losses[0]:.4f} last_loss={losses[-1]:.4f} "
          f"stragglers={len(runner.straggler.flagged)}")
    if args.metrics_out:
        with open(args.metrics_out, "w") as f:
            for m in runner.metrics_log:
                f.write(json.dumps({k: v for k, v in m.items()
                                    if k != "dt"}) + "\n")
    return {"runner": runner, "model": model, "params": params,
            "opt_state": opt_state}


if __name__ == "__main__":
    main()
