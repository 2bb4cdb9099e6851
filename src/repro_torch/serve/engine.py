"""Batched serving engine: prefill + KV-cache decode with a request queue
(port of ``repro/serve/engine.py``).

Synchronized batching, as in the reference: requests are grouped into
batches of ``batch_slots`` with a common prompt length (shorter prompts
padded with repeats of their last token, a short group filled with copies
of its last request), one prefill builds the cache, then greedy decode
steps run until the group's longest request is served, at most
``max_len - prompt - 1`` new tokens.

The generated tokens stay on the device between steps (each step's argmax
is the next step's input) and come to the host once per group.  A group's
latency is taken on the host clock after a ``torch.cuda.synchronize()``;
``timings`` keeps, per group, the prefill's and the decode steps' seconds
(split by one more synchronisation) and the number of decode steps.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.models.model_api import resolve_decode_impl


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray          # (S,) int32
    max_new_tokens: int = 16


@dataclasses.dataclass
class Result:
    rid: int
    tokens: np.ndarray
    latency_s: float


class ServeEngine:
    """Serves ``model`` (a ``repro_torch.models.Model``) with ``params``.
    ``decode_impl`` ("auto", "torch" or "cuda") overrides the model's."""

    def __init__(self, model, params, batch_slots: int = 8, max_len: int = 256,
                 greedy: bool = True, decode_impl: str | None = None):
        cfg = model.cfg
        if cfg.vlm_prefix_len or cfg.enc_dec:
            raise NotImplementedError("the VLM and encoder-decoder batch "
                                      "extras come with their configs "
                                      "(ROADMAP.md queue item 9)")
        self.model = model
        self.params = params
        self.slots = batch_slots
        self.max_len = max_len
        self.greedy = greedy
        self.decode_impl = resolve_decode_impl(
            decode_impl or model.decode_impl, model.device)
        self.timings: list[dict] = []

    def _pad_prompts(self, reqs: list[Request]) -> np.ndarray:
        # right-align is unnecessary under synchronized batching: all
        # prompts padded to the max length with repeats of the last token.
        L = max(r.prompt.shape[0] for r in reqs)
        out = np.zeros((len(reqs), L), np.int32)
        for i, r in enumerate(reqs):
            out[i, :len(r.prompt)] = r.prompt
            out[i, len(r.prompt):] = r.prompt[-1]
        return out

    def run(self, requests: list[Request]) -> list[Result]:
        results = []
        for i in range(0, len(requests), self.slots):
            group = requests[i:i + self.slots]
            results.extend(self._run_group(group))
        return results

    def _sync(self) -> None:
        if self.model.device.type == "cuda":
            torch.cuda.synchronize(self.model.device)

    def _run_group(self, group: list[Request]) -> list[Result]:
        t0 = time.monotonic()
        pad = self.slots - len(group)
        reqs = group + [Request(-1, group[-1].prompt, 0)] * pad
        prompts = self._pad_prompts(reqs)
        logits, cache = self.model.prefill(self.params, {"tokens": prompts},
                                           max_len=self.max_len)
        max_new = max(r.max_new_tokens for r in group)
        max_new = min(max_new, self.max_len - prompts.shape[1] - 1)
        cur = torch.argmax(logits, -1)[:, None]
        toks = [cur[:, 0]]
        self._sync()
        t1 = time.monotonic()
        for _ in range(max_new - 1):
            logits, cache = self.model.decode_step(self.params, cache, cur,
                                                   self.decode_impl)
            cur = torch.argmax(logits, -1)[:, None]
            toks.append(cur[:, 0])
        gen = torch.stack(toks, dim=1).cpu().numpy().astype(np.int32)
        self._sync()
        t2 = time.monotonic()
        self.timings.append({"prefill_s": t1 - t0, "decode_s": t2 - t1,
                             "decode_steps": len(toks) - 1})
        return [Result(r.rid, gen[i, :r.max_new_tokens], t2 - t0)
                for i, r in enumerate(group)]
