"""Batched serving driver: prefill + KV-cache decode over a request queue
(port of ``repro/launch/serve.py``, same arguments and defaults).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama-1.1b \\
      [--smoke] [--device cpu]

Runs on the card unless ``--device cpu``; the weights are drawn from seed
0 by a ``torch.Generator`` on that device.  ``--arch`` takes every
architecture of ``repro_torch.configs.ARCHS``: the GQA models, DeepSeek's
MLA + MoE, Zamba2 and RWKV-6.  On the card the GQA layers' decode
attention (global, sliding-window, Zamba2's shared block, the int8 cache)
runs in the ``flash_decode`` CUDA kernel, on the CPU in its plain
version; MLA, Mamba-2 and RWKV-6 have no kernel in the reference and run
the same torch code on both.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs import get_config, smoke_config
from repro_torch.models.model_api import Model
from repro_torch.serve.engine import Request, ServeEngine


def main(argv=None) -> dict:
    """Serve the requests; returns the engine, the model and the results
    (for callers that drive the entry point in-process)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    model = Model(cfg, device=args.device)
    params = model.init(torch.Generator(device=model.device).manual_seed(0))
    rng = np.random.default_rng(0)
    reqs = [Request(i, rng.integers(0, model.cfg.vocab, args.prompt_len,
                                    dtype=np.int32), args.new_tokens)
            for i in range(args.requests)]
    eng = ServeEngine(model, params, batch_slots=args.slots,
                      max_len=args.prompt_len + args.new_tokens + 8)
    results = eng.run(reqs)
    tput = sum(len(r.tokens) for r in results) / sum(r.latency_s for r in results)
    for r in results[:4]:
        print(f"req {r.rid}: {r.tokens[:8]}... latency={r.latency_s:.2f}s")
    print(f"served {len(results)} requests on {model.device} (decode "
          f"attention: {eng.decode_impl}); decode throughput ~{tput:.1f} tok/s")
    return {"engine": eng, "model": model, "results": results}


if __name__ == "__main__":
    main()
