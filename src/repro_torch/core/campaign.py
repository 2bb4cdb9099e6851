"""Resilient campaign execution: kill-safe, self-healing, accountable
paper-scale sweeps on top of ``SweepRunner`` (port of
``repro.core.campaign``).

The full policy x tuned-param x fabric x fault atlas is hours of compute;
one OOM, preemption or diverged lane must not throw it away.
``run_campaign`` adds that layer:

* **durable chunk journal** — a campaign is content-fingerprinted (task
  scenarios + stacked grids + EngineConfig with its step path resolved on
  the runner's device + torch version); every dispatched chunk's results
  are written atomically (tmp-file + ``os.replace``) under
  ``<out>/<campaign>/journal/`` as numpy arrays, and ``resume=True``
  replays completed chunks from disk, so a SIGKILL mid-campaign loses at
  most one chunk of work and the merged results are bitwise-identical to
  an uninterrupted run.  A journal written by the JAX package (or under
  another torch version) is refused on resume, never replayed;
* **retry ladder with graceful degradation** — a failed chunk dispatch
  (``torch.OutOfMemoryError``, a failed launch) is retried with
  exponential backoff down an explicit ladder: halve the chunk -> serial
  per-lane runs (on the task's own config: the kernel path on the card).
  Every rung keeps the step on the kernels: the port has no counterpart
  of the reference's "force the jnp step" rung, which exists there for
  Pallas lowering failures that prebuilt CUDA kernels cannot have, so a
  fault of the kernel path fails the chunk instead of finishing it on
  the op path.  On a runner with a device mesh, the reference's "abandon
  the mesh" rung (``no_mesh``) sits between the two: the chunk runs on
  the runner's own device alone, everything else kept.  Each demotion is
  recorded in the manifest and
  passed to ``progress``, never silent, and sticks for the task's
  remaining chunks.  After an out-of-memory error the caching
  allocator's free blocks are returned to the card before the next rung.
  A sticky CUDA error (an illegal address; the kernels' launch check
  raises ``RuntimeError``) poisons the process's CUDA context: the ladder
  walks on as for any error, but no rung can recover from it in that
  process — resume the campaign in a fresh one;
* **lane quarantine** — lanes that finish unhealthy (diverged,
  deadlocked, budget-exhausted; see ``faults.LaneStatus``) are
  re-dispatched once with a relaxed step budget
  (``max_steps * quarantine_relax``); the retry is journaled too, and
  only lanes that come back healthy are patched in;
* **deadline / per-chunk watchdog** — a wall-clock deadline is checked
  before every dispatch, and ``chunk_timeout_s`` runs each dispatch
  under a watchdog thread; either trips a clean checkpoint-and-exit
  with a partial manifest.  A timed-out dispatch thread cannot be
  stopped and keeps launching on the card until the process exits: run
  a campaign that may time out in a process of its own;
* **structured manifest** — ``manifest.json`` carries per-chunk
  attempts/demotions/wall, quarantined lanes with before/after status,
  uncovered lanes, and the coverage fraction.

Sub-runners made for a demoted chunk carry the parent runner's device
and share its prepared scenarios (``SweepRunner.share_prep``), so a
demotion neither re-runs ``_prep`` nor holds a second copy of the plan on
the card.

Usage::

    tasks = [CampaignTask("dcqcn", topo, sched, "dcqcn",
                          stacked_params={"rai_frac": grid})]
    res = run_campaign(tasks, name="atlas_smoke", resume=True,
                       deadline_s=3600, max_retries=3)   # device="cuda"
    res.results["dcqcn"]      # merged BatchResults (NaN rows = uncovered)
    res.manifest["coverage"]  # 1.0 when nothing was dropped

``python -m repro_torch.launch.run_campaign`` is the CLI.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import re
import threading
import time
import warnings

import numpy as np
import torch

from repro_torch.core.engine import (EngineConfig, FabricParams, _as_fabric,
                                     _cfg_static)
from repro_torch.core.faults import (FaultSpec, LaneStatus, _as_fault,
                                     classify_lane, is_faulty)
from repro_torch.core.sweep import (BatchResults, SweepRunner, _resolve,
                                    _stack_fabric, _stack_fault)

JOURNAL_DIR = "journal"
MANIFEST = "manifest.json"
FINGERPRINT = "fingerprint.json"

# the per-lane result arrays a chunk journals, with the reference's dtypes
# (exactly the array fields of the reference's BatchResults; params/
# fabric/fault are re-derived from the task spec at merge time)
RESULT_DTYPES = {"completion_time": np.float32, "t_finish": np.float32,
                 "pause_count": np.float32, "delivered": np.float32,
                 "soft_cost": np.float32, "finished": np.bool_,
                 "diverged": np.bool_, "deadlock_step": np.int32,
                 "storm_step": np.int32, "extend_exhausted": np.bool_}
RESULT_KEYS = tuple(RESULT_DTYPES)

# graceful-degradation ladder, applied cumulatively and in order; rungs
# that cannot apply on the runner (no mesh) are skipped when the ladder is
# instantiated per task
DEMOTION_LADDER = ("half_chunk", "no_mesh", "serial")


class CampaignError(RuntimeError):
    """Base for campaign-layer failures."""


class CampaignFingerprintMismatch(CampaignError):
    """The on-disk journal belongs to a different campaign definition."""


class ChunkTimeout(CampaignError):
    """A chunk dispatch exceeded ``chunk_timeout_s`` under the watchdog."""


# ---------------------------------------------------------------------------
# campaign definition
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class CampaignTask:
    """One journaled unit of a campaign: a ``run_batch`` call's inputs.

    ``stacked_*`` dicts follow ``SweepRunner.run_batch`` exactly (CC
    param / FabricParams field / FaultSpec field -> length-B arrays); at
    least one must be non-empty.  ``policy`` may be a name, a ``Policy``
    or a stacked product policy (then set ``policy_axis`` to its member
    labels, e.g. via ``sweep.stack_policy_axis``).  ``cfg`` overrides
    the campaign's EngineConfig for this task only.
    """
    name: str
    topo: object
    sched: object
    policy: object
    stacked_params: dict | None = None
    stacked_fabric: dict | None = None
    stacked_fault: dict | None = None
    cc_params: dict | None = None
    fabric_params: FabricParams | None = None
    fault_spec: FaultSpec | None = None
    policy_axis: tuple = ()
    cfg: EngineConfig | None = None

    @property
    def n_lanes(self) -> int:
        sizes = [np.asarray(v).shape[0]
                 for d in (self.stacked_params, self.stacked_fabric,
                           self.stacked_fault) if d
                 for v in d.values()]
        if not sizes:
            raise CampaignError(
                f"task {self.name!r} has no stacked axes; campaigns journal "
                "batched lanes (provide stacked_params / stacked_fabric / "
                "stacked_fault)")
        if len(set(sizes)) > 1:
            raise CampaignError(f"task {self.name!r} has inconsistent lane "
                                f"counts {sorted(set(sizes))}")
        return sizes[0]

    def _sliced(self, idx) -> tuple[dict, dict, dict]:
        """The three stacked dicts restricted to lanes ``idx`` (a slice
        or an index array)."""
        return tuple({k: np.asarray(v)[idx] for k, v in (d or {}).items()}
                     for d in (self.stacked_params, self.stacked_fabric,
                               self.stacked_fault))


def _sanitize(name: str) -> str:
    safe = re.sub(r"[^A-Za-z0-9._-]+", "_", name).strip("._")
    if not safe:
        raise CampaignError(f"unusable task/campaign name {name!r}")
    return safe


def _policy_token(policy) -> dict:
    """A cross-process-stable identity for a policy: name, wire factor,
    default params, member labels (``sweep._policy_key`` is NOT usable
    here — it holds ``__code__`` objects)."""
    policy = _resolve(policy)
    return {"name": policy.name,
            "wire_factor": float(policy.wire_factor),
            "params": {k: float(v)
                       for k, v in sorted(policy.params.items())},
            "members": list(getattr(policy, "members", ()) or ())}


def _task_fingerprint(task: CampaignTask, cfg: EngineConfig, chunk: int,
                      device) -> str:
    h = hashlib.sha1()

    def upd(obj):
        h.update(json.dumps(obj, sort_keys=True, default=str).encode())

    upd({"package": "repro_torch",
         "scenario": list(SweepRunner._scenario_key(task.topo, task.sched)),
         "policy": _policy_token(task.policy),
         "policy_axis": list(task.policy_axis),
         "cc_params": {k: float(v)
                       for k, v in sorted((task.cc_params or {}).items())},
         "cfg": repr(_cfg_static(cfg, device)),
         "chunk": int(chunk), "n_lanes": int(task.n_lanes)})
    for label, d in (("params", task.stacked_params),
                     ("fabric", task.stacked_fabric),
                     ("fault", task.stacked_fault)):
        for k in sorted(d or {}):
            h.update(f"{label}.{k}".encode())
            h.update(np.ascontiguousarray(
                np.asarray(d[k], np.float32)).tobytes())
    fab = _as_fabric(task.fabric_params, cfg)
    flt = _as_fault(task.fault_spec)
    for f in FabricParams.FIELDS:
        h.update(np.ascontiguousarray(
            np.asarray(getattr(fab, f), np.float32)).tobytes())
    for f in FaultSpec.FIELDS:
        h.update(np.ascontiguousarray(
            np.asarray(getattr(flt, f), np.float32)).tobytes())
    return h.hexdigest()


# ---------------------------------------------------------------------------
# journal I/O (atomic tmp-file + rename, corrupt files log-and-rerun)
# ---------------------------------------------------------------------------

def _atomic_json(path: str, obj: dict) -> None:
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(obj, f, indent=1, default=str)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def _save_chunk(path: str, arrays: dict, meta: dict) -> None:
    payload = {k: np.asarray(arrays[k]) for k in RESULT_KEYS}
    payload["__meta__"] = np.frombuffer(
        json.dumps(meta, default=str).encode(), np.uint8).copy()
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "wb") as f:
        np.savez(f, **payload)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def _load_chunk(path: str):
    """(arrays, meta) or None — a corrupt/truncated chunk is warned about
    and re-run, not fatal."""
    if not os.path.exists(path):
        return None
    try:
        with np.load(path) as z:
            arrays = {k: np.asarray(z[k]) for k in RESULT_KEYS}
            meta = json.loads(bytes(z["__meta__"]).decode())
        return arrays, meta
    except Exception as e:
        warnings.warn(f"ignoring unreadable journal chunk {path} "
                      f"({type(e).__name__}: {e}); it will be re-run",
                      RuntimeWarning, stacklevel=2)
        return None


def _clean_tmp(journal: str) -> None:
    for fn in os.listdir(journal):
        if ".tmp." in fn:
            try:
                os.unlink(os.path.join(journal, fn))
            except OSError:
                pass


# ---------------------------------------------------------------------------
# chunk dispatch: the retry ladder's rungs
# ---------------------------------------------------------------------------

def _applicable_ladder(runner: SweepRunner, cfg: EngineConfig) -> tuple:
    rungs = ["half_chunk"]
    if runner.mesh is not None:
        rungs.append("no_mesh")
    rungs.append("serial")
    return tuple(rungs)


def _chunk_arrays(batch) -> dict:
    """A dispatch's journal arrays in the reference's dtypes."""
    return {k: np.asarray(getattr(batch, k), dt)
            for k, dt in RESULT_DTYPES.items()}


def _normalized_lanes(task: CampaignTask, cfg: EngineConfig):
    """Replicate ``run_batch``'s lane normalization for the full task:
    (policy, full CC dict, stacked FabricParams, stacked FaultSpec)."""
    policy = _resolve(task.policy)
    B = task.n_lanes
    base_cc = dict(policy.params, **(task.cc_params or {}))
    sp = task.stacked_params or {}
    full = {k: np.asarray(sp.get(k, np.full(B, float(v))), np.float32)
            for k, v in base_cc.items()}
    cfg0 = dataclasses.replace(cfg, queue_stride=0)
    fab = _stack_fabric(_as_fabric(task.fabric_params, cfg0),
                        task.stacked_fabric, B)
    flt = _stack_fault(_as_fault(task.fault_spec), task.stacked_fault, B)
    return policy, full, fab, flt


def _serial_lanes(runner: SweepRunner, task: CampaignTask,
                  cfg: EngineConfig, idx: np.ndarray) -> dict:
    """Bottom rung: one engine run per lane, under the task's own config
    (on the card: the kernel path).  Uses the fully-normalized per-lane
    param/fabric/fault sets (``Simulator.run`` takes the raw dict, so
    baked keys and the stacked-policy ``_which`` selector pass through
    unchanged)."""
    policy, full, fab, flt = _normalized_lanes(task, cfg)
    cfg = dataclasses.replace(cfg, queue_stride=0)
    rows = []
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        for i in idx:
            cc_i = {k: np.float32(v[i]) for k, v in full.items()}
            fab_i = FabricParams(**{f: np.asarray(getattr(fab, f))[i]
                                    for f in FabricParams.FIELDS})
            flt_i = FaultSpec(**{f: np.asarray(getattr(flt, f))[i]
                                 for f in FaultSpec.FIELDS})
            rows.append(runner.run(task.topo, task.sched, policy,
                                   cc_params=cc_i, cfg=cfg,
                                   fabric_params=fab_i, fault_spec=flt_i))
    return {k: np.stack([np.asarray(getattr(r, k), dt) for r in rows])
            for k, dt in RESULT_DTYPES.items()}


def _dispatch_chunk(runner: SweepRunner, task: CampaignTask,
                    cfg: EngineConfig, idx: np.ndarray,
                    demotions: tuple) -> dict:
    """Run lanes ``idx`` of ``task`` under the given cumulative demotion
    set and return the journal arrays."""
    if "serial" in demotions:
        return _serial_lanes(runner, task, cfg, idx)
    changes = {}
    if "half_chunk" in demotions:
        changes["chunk_lanes"] = max(1, (len(idx) + 1) // 2)
    if "no_mesh" in demotions and runner.mesh is not None:
        changes["mesh"] = None
    sub = runner.share_prep(**changes) if changes else runner
    sp, sf, sq = task._sliced(idx)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        batch = sub.run_batch(task.topo, task.sched, task.policy, sp,
                              stacked_fabric=sf,
                              fabric_params=task.fabric_params,
                              cc_params=task.cc_params, cfg=cfg,
                              policy_axis=task.policy_axis,
                              stacked_fault=sq,
                              fault_spec=task.fault_spec)
    return _chunk_arrays(batch)


def _run_with_timeout(fn, timeout_s):
    """Watchdog: run ``fn`` on a worker thread and raise ``ChunkTimeout``
    if it outlives ``timeout_s``.  The hung dispatch thread cannot be
    killed — it is left daemonized (still launching on the card) and the
    campaign checkpoints and exits; the process is expected to terminate
    soon after."""
    if not timeout_s:
        return fn()
    box: dict = {}
    done = threading.Event()

    def target():
        try:
            box["out"] = fn()
        except BaseException as e:          # noqa: BLE001 — re-raised below
            box["err"] = e
        finally:
            done.set()

    th = threading.Thread(target=target, daemon=True,
                          name="campaign-chunk-dispatch")
    th.start()
    done.wait(timeout_s)
    if not done.is_set():
        raise ChunkTimeout(f"chunk dispatch exceeded {timeout_s:g}s "
                           "watchdog; checkpointing and exiting")
    th.join()
    if "err" in box:
        raise box["err"]
    return box["out"]


def _release_memory(err: Exception, device) -> None:
    """After an out-of-memory error, hand the caching allocator's free
    blocks back to the card before the next rung."""
    if isinstance(err, torch.OutOfMemoryError) and device.type == "cuda":
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# merge + result
# ---------------------------------------------------------------------------

def _fill_arrays(n: int, F: int, D: int) -> dict:
    """Journal-shaped placeholder rows for uncovered lanes: NaN where a
    measurement would be, inert flags elsewhere."""
    return {"completion_time": np.full(n, np.nan, np.float32),
            "t_finish": np.full((n, F), np.nan, np.float32),
            "pause_count": np.zeros((n, D), np.float32),
            "delivered": np.full((n, F), np.nan, np.float32),
            "soft_cost": np.full(n, np.nan, np.float32),
            "finished": np.zeros(n, bool),
            "diverged": np.zeros(n, bool),
            "deadlock_step": np.full(n, -1, np.int32),
            "storm_step": np.full(n, -1, np.int32),
            "extend_exhausted": np.zeros(n, bool)}


def _status_of(arrays: dict, i: int) -> LaneStatus:
    return classify_lane(bool(arrays["diverged"][i]),
                         bool(arrays["deadlock_step"][i] >= 0),
                         bool(arrays["finished"][i]))


def _merged_batch(task: CampaignTask, cfg: EngineConfig,
                  arrays: dict) -> BatchResults:
    policy, full, fab, flt = _normalized_lanes(task, cfg)
    faulty = is_faulty(flt)
    return BatchResults(
        policy=policy.name, params=full,
        fabric={k: np.asarray(getattr(fab, k))
                for k in FabricParams.FIELDS},
        completion_time=arrays["completion_time"],
        t_finish=arrays["t_finish"],
        pause_count=arrays["pause_count"],
        delivered=arrays["delivered"],
        soft_cost=arrays["soft_cost"],
        finished=arrays["finished"],
        policy_axis=tuple(task.policy_axis),
        fault=({k: np.asarray(getattr(flt, k)) for k in FaultSpec.FIELDS}
               if faulty else {}),
        diverged=arrays["diverged"],
        deadlock_step=arrays["deadlock_step"],
        storm_step=arrays["storm_step"],
        extend_exhausted=arrays["extend_exhausted"],
    )


@dataclasses.dataclass
class CampaignResult:
    """What ``run_campaign`` hands back: merged per-task ``BatchResults``
    plus the structured manifest (also on disk as ``manifest.json``)."""
    name: str
    out_dir: str
    status: str            # "complete" | "partial" | "deadline" | "chunk_timeout"
    results: dict          # task name -> BatchResults
    manifest: dict

    @property
    def ok(self) -> bool:
        return (self.status == "complete"
                and float(self.manifest.get("coverage", 0.0)) >= 1.0)


# ---------------------------------------------------------------------------
# the campaign driver
# ---------------------------------------------------------------------------

def run_campaign(tasks, name: str, out_dir: str = "experiments",
                 runner: SweepRunner | None = None,
                 cfg: EngineConfig | None = None,
                 chunk_lanes: int | None = None,
                 resume: bool = False, fresh: bool = False,
                 max_retries: int = 3, backoff_s: float = 0.5,
                 deadline_s: float | None = None,
                 chunk_timeout_s: float | None = None,
                 quarantine: bool = True,
                 quarantine_relax: float = 4.0,
                 quarantine_statuses=(LaneStatus.DIVERGED,
                                      LaneStatus.DEADLOCKED,
                                      LaneStatus.EXHAUSTED),
                 progress=None, device="cuda") -> CampaignResult:
    """Execute ``tasks`` with journaling, retries, quarantine, deadlines.

    ``resume=True`` replays completed chunks from the journal (after
    verifying the campaign fingerprint matches; mismatch raises
    ``CampaignFingerprintMismatch``).  ``resume=False`` on a non-empty
    journal refuses unless ``fresh=True`` wipes it first.  ``max_retries``
    caps retry attempts per chunk *beyond* the first (each retry takes one
    more rung down the demotion ladder and backs off exponentially from
    ``backoff_s``); a chunk that exhausts the ladder and budget is marked
    failed and the campaign continues (``status="partial"``, uncovered
    lanes NaN-filled and listed in the manifest).  ``deadline_s`` /
    ``chunk_timeout_s`` trigger checkpoint-and-exit with a partial
    manifest.  ``progress`` is an optional ``callable(str)``.  Without a
    ``runner`` one is made on ``device`` (the card by default).
    """
    t_start = time.monotonic()
    say = progress or (lambda _msg: None)
    runner = runner or SweepRunner(cfg=cfg, chunk_lanes=chunk_lanes
                                   if chunk_lanes else "auto", device=device)
    base_cfg = cfg or runner.cfg

    tasks = list(tasks)
    safe_names = [_sanitize(t.name) for t in tasks]
    if len(set(safe_names)) != len(safe_names):
        raise CampaignError(f"duplicate task names: {sorted(safe_names)}")

    camp_dir = os.path.join(out_dir, _sanitize(name))
    journal = os.path.join(camp_dir, JOURNAL_DIR)
    os.makedirs(journal, exist_ok=True)
    _clean_tmp(journal)

    # -- fingerprint + resume gate ---------------------------------------
    plans = []
    for t, safe in zip(tasks, safe_names):
        tcfg = t.cfg or base_cfg
        B = t.n_lanes
        chunk = (min(B, max(int(chunk_lanes), 1)) if chunk_lanes
                 else runner._chunk_size(B))
        n_chunks = -(-B // chunk)
        plans.append({"task": t, "safe": safe, "cfg": tcfg, "B": B,
                      "chunk": chunk, "n_chunks": n_chunks,
                      "fingerprint": _task_fingerprint(t, tcfg, chunk,
                                                       runner.device)})
    fp = {"campaign": _sanitize(name), "torch": torch.__version__,
          "tasks": {p["safe"]: {"fingerprint": p["fingerprint"],
                                "n_lanes": p["B"], "chunk": p["chunk"],
                                "n_chunks": p["n_chunks"]}
                    for p in plans}}
    fp["fingerprint"] = hashlib.sha1(json.dumps(
        fp["tasks"], sort_keys=True).encode() +
        torch.__version__.encode()).hexdigest()

    fp_path = os.path.join(camp_dir, FINGERPRINT)
    have_chunks = any(f.endswith(".npz") for f in os.listdir(journal))
    if os.path.exists(fp_path) and have_chunks:
        try:
            with open(fp_path) as f:
                on_disk = json.load(f)
        except (OSError, ValueError):
            on_disk = None
        if resume:
            if on_disk is None or on_disk.get("fingerprint") != \
                    fp["fingerprint"]:
                raise CampaignFingerprintMismatch(
                    f"journal at {journal} was written by a different "
                    "campaign definition (tasks/grids/config/device/torch "
                    "changed, or another package); pass fresh=True to "
                    "discard it")
        elif fresh:
            for fn in os.listdir(journal):
                os.unlink(os.path.join(journal, fn))
            for fn in (MANIFEST,):
                p = os.path.join(camp_dir, fn)
                if os.path.exists(p):
                    os.unlink(p)
        else:
            raise CampaignError(
                f"journal at {journal} is non-empty; pass resume=True to "
                "continue it or fresh=True to discard it")
    _atomic_json(fp_path, fp)

    manifest = {"campaign": fp["campaign"], "fingerprint": fp["fingerprint"],
                "torch": torch.__version__, "status": "running",
                "config": {"chunk_lanes": chunk_lanes,
                           "max_retries": max_retries,
                           "backoff_s": backoff_s,
                           "deadline_s": deadline_s,
                           "chunk_timeout_s": chunk_timeout_s,
                           "quarantine": quarantine,
                           "quarantine_relax": quarantine_relax,
                           "mesh_devices": runner.n_mesh_devices},
                "tasks": {}, "coverage": 0.0, "wall_s": 0.0}

    def checkpoint(status):
        manifest["status"] = status
        covered = total = 0
        for p in plans:
            ts = manifest["tasks"].get(p["safe"])
            total += p["B"]
            if ts:
                covered += round(ts["coverage"] * p["B"])
        manifest["coverage"] = covered / total if total else 0.0
        manifest["wall_s"] = round(time.monotonic() - t_start, 3)
        _atomic_json(os.path.join(camp_dir, MANIFEST), manifest)

    def past_deadline():
        return (deadline_s is not None
                and time.monotonic() - t_start > deadline_s)

    results: dict = {}
    exit_status: str | None = None
    any_failed = False

    for p in plans:
        task, safe, tcfg = p["task"], p["safe"], p["cfg"]
        B, chunk, n_chunks = p["B"], p["chunk"], p["n_chunks"]
        ladder = _applicable_ladder(runner, tcfg)
        level = 0                        # sticky demotion level for the task
        tstate = {"n_lanes": B, "chunk_lanes": chunk, "n_chunks": n_chunks,
                  "ladder": list(ladder), "chunks": [], "demotions": [],
                  "quarantine": None, "uncovered_lanes": [],
                  "coverage": 0.0, "lane_status": None}
        manifest["tasks"][safe] = tstate
        chunk_arrays: dict = {}

        for ci in range(n_chunks):
            lo, hi = ci * chunk, min((ci + 1) * chunk, B)
            cpath = os.path.join(journal, f"{safe}__c{ci:04d}.npz")
            loaded = _load_chunk(cpath)
            if loaded is not None and loaded[1].get("lo") == lo \
                    and loaded[1].get("hi") == hi:
                chunk_arrays[ci] = loaded[0]
                rec = dict(loaded[1], index=ci, status="replayed")
                tstate["chunks"].append(rec)
                continue
            if past_deadline():
                exit_status = "deadline"
                break
            attempts = []
            while True:
                demos = ladder[:level]
                t0 = time.perf_counter()
                try:
                    arrays = _run_with_timeout(
                        lambda d=demos: _dispatch_chunk(
                            runner, task, tcfg, np.arange(lo, hi), d),
                        chunk_timeout_s)
                except ChunkTimeout as e:
                    attempts.append({"demotions": list(demos),
                                     "error": str(e),
                                     "wall_s": round(
                                         time.perf_counter() - t0, 3)})
                    tstate["chunks"].append(
                        {"index": ci, "lo": lo, "hi": hi,
                         "status": "timeout", "attempts": attempts})
                    exit_status = "chunk_timeout"
                    break
                except Exception as e:   # the retry ladder's domain
                    _release_memory(e, runner.device)
                    wall = round(time.perf_counter() - t0, 3)
                    attempts.append({"demotions": list(demos),
                                     "error": f"{type(e).__name__}: {e}"[:300],
                                     "wall_s": wall})
                    if len(attempts) > max_retries:
                        tstate["chunks"].append(
                            {"index": ci, "lo": lo, "hi": hi,
                             "status": "failed", "attempts": attempts})
                        any_failed = True
                        say(f"{safe} chunk {ci}: FAILED after "
                            f"{len(attempts)} attempts")
                        break
                    if level < len(ladder):
                        level += 1
                        tstate["demotions"].append(
                            {"chunk": ci, "rung": ladder[level - 1],
                             "after_error": attempts[-1]["error"]})
                        say(f"{safe} chunk {ci}: demoting to "
                            f"{ladder[:level]} after "
                            f"{attempts[-1]['error']}")
                    if backoff_s:
                        time.sleep(backoff_s * 2 ** (len(attempts) - 1))
                else:
                    wall = round(time.perf_counter() - t0, 3)
                    meta = {"lo": lo, "hi": hi,
                            "attempts": len(attempts) + 1,
                            "demotions": list(demos), "wall_s": wall}
                    _save_chunk(cpath, arrays, meta)
                    chunk_arrays[ci] = {k: np.asarray(arrays[k])
                                        for k in RESULT_KEYS}
                    tstate["chunks"].append(
                        dict(meta, index=ci, status="done"))
                    break
            if exit_status:
                break

        # -- merge this task's journaled chunks ---------------------------
        if chunk_arrays:
            ref = next(iter(chunk_arrays.values()))
            F = ref["t_finish"].shape[1]
            D = ref["pause_count"].shape[1]
        else:
            sim = runner.simulator(task.topo, task.sched,
                                   _resolve(task.policy),
                                   dataclasses.replace(tcfg, queue_stride=0))
            F, D = sim.plan.n_flows, sim.plan.n_dev
        parts, covered = [], np.zeros(B, bool)
        for ci in range(n_chunks):
            lo, hi = ci * chunk, min((ci + 1) * chunk, B)
            got = chunk_arrays.get(ci)
            if got is None:
                parts.append(_fill_arrays(hi - lo, F, D))
            else:
                parts.append(got)
                covered[lo:hi] = True
        merged = {k: np.concatenate([pt[k] for pt in parts], axis=0)
                  for k in RESULT_KEYS}

        # -- lane quarantine ----------------------------------------------
        if quarantine and exit_status is None:
            qset = {LaneStatus(s) for s in quarantine_statuses}
            qlanes = [i for i in range(B) if covered[i]
                      and _status_of(merged, i) in qset]
            if qlanes:
                qpath = os.path.join(journal, f"{safe}__q.npz")
                qrec = {"lanes": [int(i) for i in qlanes],
                        "before": [str(_status_of(merged, i))
                                   for i in qlanes],
                        "relax": quarantine_relax,
                        "after": None, "patched": [], "error": None}
                qcfg = dataclasses.replace(
                    tcfg, max_steps=int(tcfg.max_steps * quarantine_relax))
                qloaded = _load_chunk(qpath)
                qarrays = None
                if qloaded is not None and \
                        qloaded[1].get("lanes") == qrec["lanes"]:
                    qarrays = qloaded[0]
                    qrec["status"] = "replayed"
                elif not past_deadline():
                    try:
                        qarrays = _run_with_timeout(
                            lambda: _dispatch_chunk(
                                runner, task, qcfg,
                                np.asarray(qlanes, np.int64), ()),
                            chunk_timeout_s)
                        _save_chunk(qpath, qarrays,
                                    {"lanes": qrec["lanes"],
                                     "relax": quarantine_relax})
                        qrec["status"] = "done"
                    except Exception as e:
                        _release_memory(e, runner.device)
                        qrec["error"] = f"{type(e).__name__}: {e}"[:300]
                        qrec["status"] = "failed"
                        say(f"{safe} quarantine retry failed: "
                            f"{qrec['error']}")
                else:
                    qrec["status"] = "skipped_deadline"
                if qarrays is not None:
                    after = []
                    for j, lane in enumerate(qlanes):
                        st = _status_of(qarrays, j)
                        after.append(str(st))
                        if st is LaneStatus.OK:   # only patch healed lanes
                            for k in RESULT_KEYS:
                                merged[k][lane] = qarrays[k][j]
                            qrec["patched"].append(int(lane))
                    qrec["after"] = after
                tstate["quarantine"] = qrec

        batch = _merged_batch(task, tcfg, merged)
        results[task.name] = batch
        tstate["uncovered_lanes"] = [int(i) for i in np.where(~covered)[0]]
        tstate["coverage"] = float(covered.mean()) if B else 1.0
        status_list = [str(s) if covered[i] else "uncovered"
                       for i, s in enumerate(batch.lane_status())]
        tstate["lane_status"] = {
            s: status_list.count(s) for s in dict.fromkeys(status_list)}
        checkpoint(exit_status or "running")
        say(f"{safe}: coverage {tstate['coverage']:.0%} "
            f"({tstate['lane_status']})")
        if exit_status:
            break

    if exit_status is None:
        exit_status = "partial" if any_failed or any(
            ts["coverage"] < 1.0 for ts in manifest["tasks"].values()) \
            else "complete"
    checkpoint(exit_status)
    return CampaignResult(name=fp["campaign"], out_dir=camp_dir,
                          status=exit_status, results=results,
                          manifest=manifest)


# ---------------------------------------------------------------------------
# the shared smoke campaign (CLI --smoke and the kill/resume tests)
# ---------------------------------------------------------------------------

def smoke_tasks(n_grid: int = 12) -> tuple[list, EngineConfig]:
    """A tiny two-task campaign (a dcqcn CC-param sweep and a lossy-RoCE
    fault sweep on a 4-GPU ring all-reduce) sized so ``chunk_lanes=4``
    yields several journaled chunks in seconds — shared by
    ``python -m repro_torch.launch.run_campaign --smoke`` and the
    crash/resume tests."""
    from repro_torch.core.collectives import allreduce_1d
    from repro_torch.core.topology import single_switch

    cfg = EngineConfig(dt=2e-6, max_steps=600, max_extends=1,
                       queue_stride=0)
    topo = single_switch(4)
    sched = allreduce_1d(topo, list(range(4)), 4e6)
    tasks = [
        CampaignTask(
            "dcqcn_rai", topo, sched, "dcqcn",
            stacked_params={"rai_frac": np.geomspace(
                0.005, 0.2, n_grid).astype(np.float32)}),
        CampaignTask(
            "hpcc_lossy", topo, sched, "hpcc",
            stacked_fault={"loss_rate": np.asarray(
                [0.0, 1e-5, 1e-4, 1e-3], np.float32),
                "pfc_on": np.zeros(4, np.float32)}),
    ]
    return tasks, cfg
