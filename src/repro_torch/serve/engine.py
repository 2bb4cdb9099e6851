"""Batched serving engine: prefill + KV-cache decode with a request queue
(port of ``repro/serve/engine.py``).

Synchronized batching, as in the reference: requests are grouped into
batches of ``batch_slots`` with a common prompt length (shorter prompts
padded with repeats of their last token, a short group filled with copies
of its last request), one prefill builds the cache, then greedy decode
steps run until the group's longest request is served, at most
``max_len - prompt - 1`` new tokens.  A VLM's batch carries a zero image
prefix (``img``), an encoder-decoder's zero ``frames`` as long as the
padded prompt, as the reference's.

The budget is the reference's rule, which does not count a VLM's image
prefix: where the prefix, the prompt and the decode steps do not fit the
cache, the reference's prefill fails or its decode writes are clamped
onto the cache's last slot; the port raises ``ValueError`` before the
prefill instead.

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

    def batch(self, prompts: np.ndarray) -> dict:
        """The prefill's batch for padded ``prompts`` (B, S): the tokens
        and a config's extras, zeros as the reference's (a VLM's ``img``
        (B, ``vlm_prefix_len``, d_model), an encoder-decoder's ``frames``
        (B, S, d_model), bf16)."""
        cfg = self.model.cfg
        B, S = prompts.shape
        out = {"tokens": prompts}
        dev = self.model.device
        if cfg.vlm_prefix_len:
            out["img"] = torch.zeros((B, cfg.vlm_prefix_len, cfg.d_model),
                                     dtype=torch.bfloat16, device=dev)
        if cfg.enc_dec:
            out["frames"] = torch.zeros((B, S, cfg.d_model),
                                        dtype=torch.bfloat16, device=dev)
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
        max_new = max(r.max_new_tokens for r in group)
        max_new = min(max_new, self.max_len - prompts.shape[1] - 1)
        # the prefix and the prompt, then a position a decode step
        need = self.model.cfg.vlm_prefix_len + prompts.shape[1] + max(
            max_new - 1, 0)
        if need > self.max_len:
            raise ValueError(f"a prompt of {prompts.shape[1]} tokens after "
                             f"{self.model.cfg.vlm_prefix_len} prefix "
                             f"positions and {max_new - 1} decode steps take "
                             f"{need} cache positions; max_len is "
                             f"{self.max_len}")
        logits, cache = self.model.prefill(self.params, self.batch(prompts),
                                           max_len=self.max_len)
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
