#!/usr/bin/env python3
"""Times the flash-decode kernel at ``chip_smoke.py``'s ``serve_long`` shape
(TinyLlama's 4 kv heads x 8 queries x 64 dims, 8 rows of length 2,111 in a
32,768-token bf16 cache, random inputs from a seed), beside one
``F.scaled_dot_product_attention(..., enable_gqa=True)`` call on the cache
sliced to the length, for each given kernel source: the repository's by
default, or others with the same C entry point (an earlier commit's, from
``git archive``) to compare two versions in one run.

    python3 scripts/time_flash_decode.py [--source FILE.cu:CHUNK[:noscale] ...]
        [--out time_flash_decode.json]

Each source is called with softcap 0, the code without the softcap, and
no int8 scales (``:noscale`` marks a source whose entry point predates
the int8 cache's two scale pointers); its line also holds
its kernels' SASS instruction counts (``chip_smoke.sass_counts``).

Per source and for SDPA, cold (each call on the next of 4 input sets, 69 MB
of live K/V, beyond the 50 MB L2) and hot (one set, L2-resident):

- ``event``: CUDA events around 20 back-to-back calls, per call
  (``chip_smoke.cuda_ms``); host-bound when the host's enqueue is slower;
- ``device``: the same 20 calls enqueued while a sleep kernel holds the
  stream, so the host is ahead and the events see device time only;
- ``profiler``: the device-busy µs per call of a ``torch.profiler`` trace
  (``chip_smoke.device_us``), cold;
- ``host_us``: the host's µs per call, unsynchronised.

Each source's output is checked against the plain version at
``chip_smoke.fd_tolerance`` first.  Needs one CUDA card.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke as cs  # noqa: E402  (numpy only at import)

B, S, HKV, G, D, LENGTH = 8, 32768, 4, 8, 64, 2111
SETS, SEED = 4, 0


def device_ms(fn, n: int = 20, reps: int = 10) -> float:
    """Median device ms per call of ``n`` calls enqueued behind a sleep
    kernel long enough for the host to enqueue them all."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(6_000_000)
        a.record()
        for _ in range(n):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / n)
    return statistics.median(times)


def measure(cold, hot) -> dict:
    return {"event_ms": cs.cuda_ms(cold), "event_ms_hot": cs.cuda_ms(hot),
            "device_ms": device_ms(cold), "device_ms_hot": device_ms(hot),
            "profiler_us": cs.device_us(cold), "host_us": cs.host_us(cold)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--source", action="append", default=[],
                    help="FILE.cu:CHUNK, a flash_decode.cu and the chunk its "
                         "wrapper passes (default: the repository's)")
    ap.add_argument("--out", help="also write the lines to this JSON file")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("time_flash_decode: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import torch.nn.functional as F
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_decode import ops, ref
    sources = args.source or [f"{build.SOURCES['flash_decode']}:{ops.CHUNK}"]
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    sets = []
    for _ in range(SETS):
        q, k, v = (torch.randn(shape, generator=gen, device=dev).to(
            torch.bfloat16) for shape in ((B, HKV, G, D), (B, S, HKV, D),
                                          (B, S, HKV, D)))
        sets.append((q, k, v, torch.full((B,), LENGTH, dtype=torch.int32,
                                         device=dev)))
    gpu = cs.gpu_line()
    stream = torch.cuda.current_stream().cuda_stream
    lines = []
    for spec in sources:
        path, chunk, *flags = spec.split(":")
        # the scale pointers follow the softcap (argument 12); the stream
        # is the signature's last argument
        old_entry = "noscale" in flags
        sig = [t for i, t in enumerate(ops._SIGNATURE)
               if not (old_entry and i in (13, 14))]
        lib_path = build.build("flash_decode", Path(path))
        fn = ctypes.CDLL(str(lib_path)).flash_decode
        fn.argtypes, fn.restype = sig, ctypes.c_int
        splits = -(-LENGTH // int(chunk))
        calls = []
        for q, k, v, length in sets:
            out = torch.empty_like(q)
            acc, ml = ops.scratch(q, splits)
            a = ops.kernel_args(q, k, v, length, out, splits, acc, ml)
            a[10] = int(chunk)
            if old_entry:
                a = a[:13] + a[15:]
            calls.append((a, out, acc, ml))
        turn = [0]

        def cold():
            call = calls[turn[0] % SETS]
            turn[0] += 1
            if fn(*call[0], stream) != 0:
                raise RuntimeError(f"{path}: launch failed")

        def hot():
            if fn(*calls[0][0], stream) != 0:
                raise RuntimeError(f"{path}: launch failed")
        hot()
        want = ref.flash_decode_ref(*sets[0])
        err = (calls[0][1].float() - want.float()).abs()
        if not bool((err <= cs.fd_tolerance(*sets[0], want)).all()):
            raise AssertionError(f"{path}: off the plain version by "
                                 f"{float(err.max())}")
        lines.append({"source": path, "chunk": int(chunk), "gpu": gpu,
                      "max_abs_err": float(err.max()), **measure(cold, hot),
                      "sass": cs.sass_counts(lib_path)})
        print(json.dumps(lines[-1]), flush=True)
    sdpa_in = [(q.reshape(B, HKV * G, 1, D), k[:, :LENGTH].transpose(1, 2),
                v[:, :LENGTH].transpose(1, 2)) for q, k, v, _ in sets]
    turn = [0]

    def sdpa_cold():
        i = turn[0] % SETS
        turn[0] += 1
        F.scaled_dot_product_attention(*sdpa_in[i], enable_gqa=True)
    lines.append({"source": "F.scaled_dot_product_attention", "gpu": gpu,
                  **measure(sdpa_cold, lambda: F.scaled_dot_product_attention(
                      *sdpa_in[0], enable_gqa=True))})
    print(json.dumps(lines[-1]), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(lines, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
