"""CLI for resilient sweep campaigns (``repro_torch.core.campaign``; the
port of ``scripts/run_campaign.py``, same flags and exit codes, plus
``--device``).

Runs a campaign with the durable chunk journal, retry ladder, lane
quarantine and deadline enforcement, and reports the manifest verdict.
The built-in ``--smoke`` campaign (a dcqcn CC sweep + a lossy-RoCE fault
sweep on a 4-GPU ring all-reduce) is shared with the crash/resume tests:

    # run it, SIGKILL it after 3 journaled chunks, then resume:
    PYTHONPATH=src python -m repro_torch.launch.run_campaign --smoke \\
        --chunk-lanes 4 --kill-after-chunks 3 || true
    PYTHONPATH=src python -m repro_torch.launch.run_campaign --smoke \\
        --chunk-lanes 4 --resume --expect-full

Runs on the card unless ``--device cpu``.  ``--kill-after-chunks N``
SIGKILLs the process right before dispatching chunk N+1 — the
crash-injection half of the kill/resume contract (the journal then holds
exactly N completed chunks).  ``--expect-full`` makes the exit code
enforce complete coverage after a resume.

Exit codes: 0 = complete with full coverage; 2 = partial (failed chunks
or incomplete coverage); 3 = ``--expect-full`` violated; 4 = stopped by
deadline or chunk watchdog.
"""
from __future__ import annotations

import argparse
import json
import os
import signal
import sys

from repro_torch.core.campaign import run_campaign, smoke_tasks
from repro_torch.core.sweep import SweepRunner


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__.split("\n")[0],
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--smoke", action="store_true",
                    help="run the built-in two-task smoke campaign")
    ap.add_argument("--name", default="smoke", help="campaign name")
    ap.add_argument("--out", default="experiments",
                    help="output root (journal + manifest live under "
                         "<out>/<name>/)")
    ap.add_argument("--resume", action="store_true",
                    help="replay journaled chunks of a previous run")
    ap.add_argument("--fresh", action="store_true",
                    help="discard an existing journal and restart")
    ap.add_argument("--deadline", type=float, default=None, metavar="S",
                    help="wall-clock budget in seconds; the campaign "
                         "checkpoints and exits when exceeded")
    ap.add_argument("--chunk-timeout", type=float, default=None,
                    metavar="S", help="per-chunk watchdog timeout")
    ap.add_argument("--max-retries", type=int, default=3,
                    help="retry attempts per chunk beyond the first "
                         "(each takes one rung down the demotion ladder)")
    ap.add_argument("--backoff", type=float, default=0.5,
                    help="base retry backoff in seconds (doubles per "
                         "attempt)")
    ap.add_argument("--chunk-lanes", type=int, default=None,
                    help="lanes per journaled chunk (default: 4)")
    ap.add_argument("--no-quarantine", action="store_true",
                    help="skip the relaxed-budget retry of unhealthy "
                         "lanes")
    ap.add_argument("--kill-after-chunks", type=int, default=None,
                    metavar="N", help="SIGKILL self before dispatching "
                    "chunk N+1 (crash-injection for the resume test)")
    ap.add_argument("--expect-full", action="store_true",
                    help="exit 3 unless the campaign completed with "
                         "coverage 1.0")
    ap.add_argument("--device", default="cuda",
                    help="device the simulations run on (default: the "
                         "card)")
    args = ap.parse_args(argv)

    if not args.smoke:
        ap.error("only --smoke campaigns are built in; drive custom "
                 "campaigns via repro_torch.core.campaign.run_campaign")
    tasks, cfg = smoke_tasks()
    chunk_lanes = args.chunk_lanes or 4

    dispatched = {"n": 0}

    def hook(lo, hi, B):
        if (args.kill_after_chunks is not None
                and dispatched["n"] >= args.kill_after_chunks):
            print(f"[kill-injection] SIGKILL before dispatch "
                  f"{dispatched['n'] + 1}", flush=True)
            os.kill(os.getpid(), signal.SIGKILL)
        dispatched["n"] += 1

    runner = SweepRunner(cfg=cfg, chunk_lanes=chunk_lanes,
                         dispatch_hook=hook
                         if args.kill_after_chunks is not None else None,
                         device=args.device)
    res = run_campaign(
        tasks, name=args.name, out_dir=args.out, runner=runner, cfg=cfg,
        chunk_lanes=chunk_lanes, resume=args.resume, fresh=args.fresh,
        max_retries=args.max_retries, backoff_s=args.backoff,
        deadline_s=args.deadline, chunk_timeout_s=args.chunk_timeout,
        quarantine=not args.no_quarantine,
        progress=lambda m: print(f"[campaign] {m}", flush=True))

    cov = float(res.manifest["coverage"])
    print(json.dumps({"campaign": res.name, "status": res.status,
                      "coverage": cov,
                      "wall_s": res.manifest["wall_s"],
                      "device": str(runner.device),
                      "manifest": os.path.join(res.out_dir,
                                               "manifest.json")},
                     indent=1))
    if args.expect_full and not res.ok:
        print(f"--expect-full: FAILED (status={res.status}, "
              f"coverage={cov:.0%})", file=sys.stderr)
        return 3
    if res.status in ("deadline", "chunk_timeout"):
        return 4
    return 0 if res.ok else 2


if __name__ == "__main__":
    raise SystemExit(main())
