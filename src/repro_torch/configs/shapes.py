"""The four assigned input-shape cells and per-arch applicability (port
of ``repro/configs/shapes.py``)."""
from __future__ import annotations

from repro_torch.configs.base import ShapeConfig

TRAIN_4K = ShapeConfig("train_4k", seq_len=4096, global_batch=256, kind="train")
PREFILL_32K = ShapeConfig("prefill_32k", seq_len=32768, global_batch=32,
                          kind="prefill")
DECODE_32K = ShapeConfig("decode_32k", seq_len=32768, global_batch=128,
                         kind="decode", cache_shard="batch")
LONG_500K = ShapeConfig("long_500k", seq_len=524288, global_batch=1,
                        kind="decode", cache_shard="seq")

ALL_SHAPES = {s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K,
                                  LONG_500K)}

# long_500k requires sub-quadratic attention: run only for SSM / hybrid /
# sliding-window archs
LONG_OK = frozenset({"rwkv6-3b", "zamba2-1.2b", "gemma3-27b", "gemma2-9b"})


def shapes_for(arch: str) -> list[ShapeConfig]:
    out = [TRAIN_4K, PREFILL_32K, DECODE_32K]
    if arch in LONG_OK:
        out.append(LONG_500K)
    return out


def skip_reason(arch: str, shape_name: str) -> str | None:
    if shape_name == "long_500k" and arch not in LONG_OK:
        return ("pure full-attention arch: 500k-token decode cache is "
                "quadratic-prefill territory; skipped per brief")
    return None
