"""The port's resilient campaign runner (``repro_torch.core.campaign``)
against the reference's (``repro.core.campaign``): every contract of
``tests/test_campaign.py`` on the port (journal/resume, retry ladder,
quarantine, deadline/watchdog, manifest), and the port's merged results
held against the reference's run of the same campaign on the CPU.

The crash/resume contract: a campaign killed mid-run and resumed produces
merged ``BatchResults`` bitwise-identical to an uninterrupted run — the
port's, and (for the lossless DCQCN sweep) the reference's.
"""
import json
import os
import signal
import subprocess
import sys
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core import campaign as rcamp
from repro.core import sweep as rsweep
from repro.core.collectives import allreduce_1d as r_allreduce_1d
from repro.core.engine import EngineConfig as REngineConfig
from repro.core.faults import FaultSpec as RFaultSpec
from repro.core.topology import single_switch as r_single_switch
from repro_torch.core import campaign as pcamp
from repro_torch.core.campaign import (CampaignError,
                                       CampaignFingerprintMismatch,
                                       CampaignTask, _applicable_ladder,
                                       _dispatch_chunk, run_campaign,
                                       smoke_tasks)
from repro_torch.core.collectives import allreduce_1d
from repro_torch.core.engine import EngineConfig
from repro_torch.core.faults import LaneStatus, classify_lane
from repro_torch.core.sweep import SweepRunner, reset_unhealthy_warnings
from repro_torch.core.topology import single_switch

pytestmark = pytest.mark.campaign

CFG_KW = dict(dt=2e-6, max_steps=600, max_extends=1, queue_stride=0)
CFG = EngineConfig(**CFG_KW)
TIGHT_KW = dict(dt=2e-6, max_steps=60, max_extends=0, queue_stride=0)
ROOT = Path(__file__).resolve().parents[1]

RESULT_ARRAYS = ("completion_time", "t_finish", "pause_count", "delivered",
                 "soft_cost", "finished", "diverged", "deadlock_step",
                 "storm_step", "extend_exhausted")
GRID = np.geomspace(0.005, 0.2, 12).astype(np.float32)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def scenario(n=4, mb=4e6):
    topo = single_switch(n)
    return topo, allreduce_1d(topo, list(range(n)), mb)


def one_task(n_lanes=12, name="dcqcn_rai"):
    topo, sched = scenario()
    grid = np.geomspace(0.005, 0.2, n_lanes).astype(np.float32)
    return CampaignTask(name, topo, sched, "dcqcn",
                        stacked_params={"rai_frac": grid})


def runner(**kw):
    return SweepRunner(kw.pop("cfg", CFG), device="cpu", **kw)


def campaign(tasks, name, out_dir, **kw):
    kw.setdefault("cfg", CFG)
    if "runner" not in kw:
        kw["device"] = "cpu"
    return run_campaign(tasks, name, out_dir=str(out_dir), **kw)


@pytest.fixture(scope="module")
def reference_dcqcn(tmp_path_factory):
    """The reference's uninterrupted run of ``one_task()`` (chunks of 4)."""
    topo = r_single_switch(4)
    sched = r_allreduce_1d(topo, list(range(4)), 4e6)
    task = rcamp.CampaignTask("dcqcn_rai", topo, sched, "dcqcn",
                              stacked_params={"rai_frac": GRID})
    res = rcamp.run_campaign([task], "ref",
                             out_dir=str(tmp_path_factory.mktemp("ref")),
                             cfg=REngineConfig(**CFG_KW), chunk_lanes=4)
    assert res.ok
    return res.results["dcqcn_rai"]


def assert_batches_bitwise(a, b, keys=RESULT_ARRAYS):
    for k in keys:
        va, vb = np.asarray(getattr(a, k)), np.asarray(getattr(b, k))
        assert va.dtype == vb.dtype, (k, va.dtype, vb.dtype)
        assert np.array_equal(va, vb, equal_nan=True), f"{k} differs"


# ---------------------------------------------------------------------------
# happy path + manifest schema
# ---------------------------------------------------------------------------

def test_campaign_completes_with_manifest(tmp_path, reference_dcqcn):
    task = one_task()
    res = campaign([task], "happy", tmp_path, chunk_lanes=4)
    assert res.status == "complete" and res.ok
    m = res.manifest
    assert m["coverage"] == 1.0 and m["torch"] == torch.__version__
    assert "jax" not in m
    ts = m["tasks"]["dcqcn_rai"]
    assert ts["n_chunks"] == 3 and ts["coverage"] == 1.0
    assert [c["status"] for c in ts["chunks"]] == ["done"] * 3
    assert all(c["attempts"] == 1 and not c["demotions"]
               for c in ts["chunks"])
    assert ts["uncovered_lanes"] == [] and ts["lane_status"] == {"ok": 12}
    on_disk = json.load(open(os.path.join(res.out_dir, "manifest.json")))
    assert on_disk["fingerprint"] == m["fingerprint"]
    assert on_disk["status"] == "complete"
    files = sorted(os.listdir(os.path.join(res.out_dir, "journal")))
    assert [f for f in files if f.endswith(".npz")] == [
        f"dcqcn_rai__c{i:04d}.npz" for i in range(3)]
    # the journal holds exactly the reference's keys, in its dtypes
    with np.load(os.path.join(res.out_dir, "journal",
                              "dcqcn_rai__c0000.npz")) as z:
        assert sorted(z.files) == sorted(RESULT_ARRAYS + ("__meta__",))
        for k in RESULT_ARRAYS:
            assert z[k].dtype == pcamp.RESULT_DTYPES[k], k
    # merged results == a direct run_batch == the reference's campaign
    direct = runner().run_batch(task.topo, task.sched, "dcqcn",
                                task.stacked_params)
    assert_batches_bitwise(res.results["dcqcn_rai"],
                           pcamp._merged_batch(task, CFG,
                                               pcamp._chunk_arrays(direct)))
    assert_batches_bitwise(res.results["dcqcn_rai"], reference_dcqcn)


def test_campaign_refuses_unnamed_overwrite_and_fresh(tmp_path):
    task = one_task()
    campaign([task], "c", tmp_path, chunk_lanes=4)
    with pytest.raises(CampaignError, match="resume=True"):
        campaign([task], "c", tmp_path, chunk_lanes=4)
    res = campaign([task], "c", tmp_path, chunk_lanes=4, fresh=True)
    assert res.ok


def test_fingerprint_mismatch_raises(tmp_path):
    campaign([one_task()], "fp", tmp_path, chunk_lanes=4)
    changed = one_task()
    changed.stacked_params = {
        "rai_frac": changed.stacked_params["rai_frac"] * 2.0}
    with pytest.raises(CampaignFingerprintMismatch):
        campaign([changed], "fp", tmp_path, chunk_lanes=4, resume=True)


def test_reference_journal_refused_on_resume(tmp_path):
    """A journal the JAX package wrote (same campaign, same directory) is
    refused on resume, never replayed."""
    topo = r_single_switch(4)
    sched = r_allreduce_1d(topo, list(range(4)), 4e6)
    rtask = rcamp.CampaignTask("dcqcn_rai", topo, sched, "dcqcn",
                               stacked_params={"rai_frac": GRID})
    rcamp.run_campaign([rtask], "shared", out_dir=str(tmp_path),
                       cfg=REngineConfig(**CFG_KW), chunk_lanes=4)
    with pytest.raises(CampaignFingerprintMismatch, match="another package"):
        campaign([one_task()], "shared", tmp_path, chunk_lanes=4,
                 resume=True)
    # without resume it is a non-empty journal: refused unless fresh
    with pytest.raises(CampaignError, match="non-empty"):
        campaign([one_task()], "shared", tmp_path, chunk_lanes=4)


def test_fingerprint_names_the_step_path():
    """The fingerprint resolves ``step_impl`` on the runner's device and
    normalizes the fabric scalars out (``engine._cfg_static``)."""
    from repro_torch.core.engine import _cfg_static
    task = one_task()
    cpu = torch.device("cpu")
    auto = pcamp._task_fingerprint(task, CFG, 4, cpu)
    torch_cfg = EngineConfig(**CFG_KW, step_impl="torch")
    assert pcamp._task_fingerprint(task, torch_cfg, 4, cpu) == auto
    assert _cfg_static(CFG, "cuda").step_impl == "cuda"
    assert _cfg_static(EngineConfig(kmin=1.0), cpu) == \
        _cfg_static(EngineConfig(), cpu)
    # ...but a fabric default changes the fingerprint (it is hashed as the
    # task's resolved FabricParams)
    moved = EngineConfig(**CFG_KW, kmin=123e3)
    assert pcamp._task_fingerprint(task, moved, 4, cpu) != auto


# ---------------------------------------------------------------------------
# crash / resume bitwise equivalence
# ---------------------------------------------------------------------------

def test_crash_resume_bitwise_identical(tmp_path, reference_dcqcn):
    """Injected mid-campaign crash (a BaseException the retry ladder must
    NOT swallow), then resume: merged results bitwise-equal to an
    uninterrupted run (the port's and the reference's), exactly the
    journaled chunks are skipped."""
    ref = campaign([one_task()], "ref", tmp_path / "a", chunk_lanes=4)
    calls = {"n": 0}

    def hook(lo, hi, B):
        calls["n"] += 1
        if calls["n"] > 2:
            raise KeyboardInterrupt("injected crash")

    with pytest.raises(KeyboardInterrupt):
        campaign([one_task()], "crash", tmp_path / "b",
                 runner=runner(chunk_lanes=4, dispatch_hook=hook),
                 chunk_lanes=4)
    journal = tmp_path / "b" / "crash" / "journal"
    done = sorted(f for f in os.listdir(journal) if f.endswith(".npz"))
    assert len(done) == 2              # at most one in-flight chunk lost

    res = campaign([one_task()], "crash", tmp_path / "b", chunk_lanes=4,
                   resume=True)
    assert res.ok
    replayed = [c["status"] for c in
                res.manifest["tasks"]["dcqcn_rai"]["chunks"]]
    assert replayed == ["replayed", "replayed", "done"]
    assert_batches_bitwise(res.results["dcqcn_rai"],
                           ref.results["dcqcn_rai"])
    assert_batches_bitwise(res.results["dcqcn_rai"], reference_dcqcn)


def test_subprocess_sigkill_resume(tmp_path):
    """A real SIGKILL of ``python -m repro_torch.launch.run_campaign``
    mid-campaign, then resume completes with full coverage and results
    bitwise-equal to an uninterrupted in-process run."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               REPRO_CALIBRATION_CACHE="0", OMP_NUM_THREADS="1")
    cmd = [sys.executable, "-m", "repro_torch.launch.run_campaign",
           "--smoke", "--device", "cpu", "--out", str(tmp_path / "kill"),
           "--chunk-lanes", "4", "--kill-after-chunks", "2"]
    p = subprocess.run(cmd, env=env, capture_output=True, text=True,
                       timeout=300)
    assert p.returncode in (-signal.SIGKILL, 137), p.stderr
    journal = tmp_path / "kill" / "smoke" / "journal"
    assert len([f for f in os.listdir(journal) if f.endswith(".npz")]) == 2

    p2 = subprocess.run(cmd[:-2] + ["--resume", "--expect-full"], env=env,
                        capture_output=True, text=True, timeout=300)
    assert p2.returncode == 0, p2.stdout + p2.stderr
    assert '"device": "cpu"' in p2.stdout

    tasks, cfg = smoke_tasks()
    ref = campaign(tasks, "smoke", tmp_path / "ref", cfg=cfg, chunk_lanes=4)
    resumed = campaign(tasks, "smoke", tmp_path / "kill", cfg=cfg,
                       chunk_lanes=4, resume=True)
    assert resumed.ok
    for tname in ref.results:
        assert_batches_bitwise(resumed.results[tname], ref.results[tname])


def test_cli_exit_codes(tmp_path):
    """Exit 4 when the deadline stops the campaign, 3 when --expect-full
    is violated, 2 for a partial campaign (in-process ``main``)."""
    from repro_torch.launch import run_campaign as cli
    base = ["--smoke", "--device", "cpu", "--chunk-lanes", "4"]
    assert cli.main(base + ["--out", str(tmp_path / "d"),
                            "--deadline", "0"]) == 4
    assert cli.main(base + ["--out", str(tmp_path / "d"), "--resume",
                            "--deadline", "0", "--expect-full"]) == 3
    assert cli.main(base + ["--out", str(tmp_path / "d"),
                            "--resume"]) == 0
    with pytest.raises(SystemExit):
        cli.main(["--device", "cpu"])          # only --smoke is built in


def test_corrupt_journal_chunk_rerun(tmp_path):
    ref = campaign([one_task()], "corrupt", tmp_path, chunk_lanes=4)
    cpath = os.path.join(ref.out_dir, "journal", "dcqcn_rai__c0001.npz")
    with open(cpath, "wb") as f:
        f.write(b"\x00truncated")
    with pytest.warns(RuntimeWarning, match="unreadable journal chunk"):
        res = campaign([one_task()], "corrupt", tmp_path, chunk_lanes=4,
                       resume=True)
    assert res.ok
    statuses = [c["status"] for c in
                res.manifest["tasks"]["dcqcn_rai"]["chunks"]]
    assert statuses == ["replayed", "done", "replayed"]
    assert_batches_bitwise(res.results["dcqcn_rai"],
                           ref.results["dcqcn_rai"])


# ---------------------------------------------------------------------------
# retry ladder
# ---------------------------------------------------------------------------

def test_retry_ladder_demotion_order(tmp_path, reference_dcqcn):
    """Injected dispatch failures walk the ladder in order, every
    demotion recorded; the serial bottom rung bypasses the failing
    dispatch hook and completes, bit-equal to the reference's
    uninterrupted run."""
    task = one_task()
    assert _applicable_ladder(runner(), CFG) == ("half_chunk", "serial")

    def hook(lo, hi, B):
        raise torch.OutOfMemoryError("injected OOM")

    messages = []
    res = campaign([task], "ladder", tmp_path,
                   runner=runner(chunk_lanes=4, dispatch_hook=hook),
                   chunk_lanes=4, max_retries=3, backoff_s=0.0,
                   progress=messages.append)
    assert res.ok and res.status == "complete"
    ts = res.manifest["tasks"]["dcqcn_rai"]
    assert [d["rung"] for d in ts["demotions"]] == ["half_chunk", "serial"]
    assert all(d["chunk"] == 0 for d in ts["demotions"])
    c0 = ts["chunks"][0]
    assert c0["attempts"] == 3 and c0["demotions"] == ["half_chunk",
                                                       "serial"]
    assert all(c["status"] == "done" for c in ts["chunks"])
    assert all("OutOfMemoryError: injected OOM" in d["after_error"]
               for d in ts["demotions"])
    # every demotion is also passed to progress, never silent
    assert sum("demoting to" in m for m in messages) == 2
    assert_batches_bitwise(res.results["dcqcn_rai"], reference_dcqcn)


def test_torch_step_rung(tmp_path):
    """The port's ladder has no op-path rung: on a CUDA device (the step
    resolves to the kernels) it is half_chunk -> serial as on the CPU, so
    no rung moves a chunk off the kernels; each rung's chunk equals the
    plain run."""
    class OnCard:                       # a runner as it is on the card
        device = torch.device("cuda")
        mesh = None
    assert _applicable_ladder(OnCard(), CFG) == ("half_chunk", "serial")
    assert _applicable_ladder(OnCard(), EngineConfig(step_impl="torch")) \
        == ("half_chunk", "serial")
    assert "torch_step" not in pcamp.DEMOTION_LADDER
    task = one_task(n_lanes=4)
    r = runner()
    idx = np.arange(4)
    plain = _dispatch_chunk(r, task, CFG, idx, ())
    for demos in (("half_chunk",), ("half_chunk", "serial")):
        got = _dispatch_chunk(r, task, CFG, idx, demos)
        for k in RESULT_ARRAYS:
            assert got[k].dtype == plain[k].dtype, (demos, k)
            assert np.array_equal(got[k], plain[k]), (demos, k)


def test_sub_runners_share_prepared_scenarios():
    """A demoted chunk's runner carries the parent's device and hook and
    shares its prepared scenarios: no second ``_prep``."""
    task = one_task(n_lanes=4)
    hook = lambda lo, hi, B: None        # noqa: E731
    r = runner(dispatch_hook=hook)
    _dispatch_chunk(r, task, CFG, np.arange(4), ())
    sims = dict(r._sims)
    sub = r.share_prep(chunk_lanes=2)
    assert sub._sims is r._sims and sub.device == r.device
    assert sub.dispatch_hook is hook and sub.chunk_lanes == 2
    assert sub.cfg is r.cfg and sub.bucket == r.bucket
    _dispatch_chunk(r, task, CFG, np.arange(4), ("half_chunk",))
    assert r._sims == sims


def test_retry_budget_exhausted_marks_partial(tmp_path):
    """With too few retries to reach a working rung, the chunk is marked
    failed (never silent) and the campaign continues: later chunks ride
    the sticky demotion level and succeed, uncovered lanes are NaN-filled
    and listed."""

    def hook(lo, hi, B):
        raise RuntimeError("injected OOM")

    res = campaign([one_task()], "exhaust", tmp_path,
                   runner=runner(chunk_lanes=4, dispatch_hook=hook),
                   chunk_lanes=4, max_retries=1, backoff_s=0.0)
    assert res.status == "partial" and not res.ok
    ts = res.manifest["tasks"]["dcqcn_rai"]
    assert ts["chunks"][0]["status"] == "failed"
    assert len(ts["chunks"][0]["attempts"]) == 2
    assert [c["status"] for c in ts["chunks"][1:]] == ["done", "done"]
    assert ts["uncovered_lanes"] == [0, 1, 2, 3]
    assert ts["coverage"] == pytest.approx(8 / 12)
    batch = res.results["dcqcn_rai"]
    assert np.isnan(batch.completion_time[:4]).all()
    assert np.isfinite(batch.completion_time[4:]).all()
    assert res.manifest["coverage"] == pytest.approx(8 / 12)


# ---------------------------------------------------------------------------
# lane quarantine
# ---------------------------------------------------------------------------

def test_quarantine_relaxed_budget_heals_lanes(tmp_path):
    """Lanes that exhaust a too-tight step budget are re-dispatched once
    with max_steps * quarantine_relax and patched in when they heal."""
    topo, sched = scenario()
    tight = EngineConfig(**TIGHT_KW)
    task = CampaignTask("tight", topo, sched, "dcqcn",
                        stacked_params={"rai_frac": np.asarray(
                            [0.01, 0.03, 0.1, 0.2], np.float32)})
    res = campaign([task], "quar", tmp_path, cfg=tight, chunk_lanes=4,
                   quarantine_relax=32.0)
    q = res.manifest["tasks"]["tight"]["quarantine"]
    assert q is not None and q["status"] == "done"
    assert q["lanes"] == [0, 1, 2, 3]
    assert q["before"] == ["exhausted"] * 4
    assert q["after"] == ["ok"] * 4 and q["patched"] == [0, 1, 2, 3]
    batch = res.results["tight"]
    assert batch.lane_status() == ["ok"] * 4
    assert bool(batch.finished.all())
    res2 = campaign([task], "quar", tmp_path, cfg=tight, chunk_lanes=4,
                    quarantine_relax=32.0, resume=True)
    assert res2.manifest["tasks"]["tight"]["quarantine"]["status"] == \
        "replayed"
    assert_batches_bitwise(res2.results["tight"], batch)


def test_quarantine_off_leaves_lanes_flagged(tmp_path):
    topo, sched = scenario()
    task = CampaignTask("tight", topo, sched, "dcqcn",
                        stacked_params={"rai_frac": np.asarray(
                            [0.01, 0.03], np.float32)})
    res = campaign([task], "noquar", tmp_path, cfg=EngineConfig(**TIGHT_KW),
                   quarantine=False)
    assert res.manifest["tasks"]["tight"]["quarantine"] is None
    assert res.results["tight"].lane_status() == ["exhausted"] * 2
    assert res.status == "complete"    # unhealthy-but-covered is complete


# ---------------------------------------------------------------------------
# deadline / watchdog
# ---------------------------------------------------------------------------

def test_deadline_checkpoints_partial_manifest(tmp_path):
    res = campaign([one_task()], "ddl", tmp_path, chunk_lanes=4,
                   deadline_s=0.0)
    assert res.status == "deadline" and not res.ok
    assert res.manifest["coverage"] == 0.0
    on_disk = json.load(open(os.path.join(res.out_dir, "manifest.json")))
    assert on_disk["status"] == "deadline"
    assert np.isnan(res.results["dcqcn_rai"].completion_time).all()
    res2 = campaign([one_task()], "ddl", tmp_path, chunk_lanes=4,
                    resume=True)
    assert res2.ok


def test_chunk_watchdog_timeout_checkpoints(tmp_path):
    res = campaign([one_task()], "wdt", tmp_path, chunk_lanes=4,
                   chunk_timeout_s=1e-4)
    assert res.status == "chunk_timeout" and not res.ok
    ts = res.manifest["tasks"]["dcqcn_rai"]
    assert ts["chunks"][0]["status"] == "timeout"
    assert "watchdog" in ts["chunks"][0]["attempts"][0]["error"]


# ---------------------------------------------------------------------------
# typed lane status, warnings, task validation
# ---------------------------------------------------------------------------

def test_lane_status_is_typed_enum():
    topo, sched = scenario()
    batch = runner().run_batch(topo, sched, "dcqcn",
                               {"rai_frac": np.asarray([0.01, 0.05],
                                                       np.float32)})
    statuses = batch.lane_status()
    assert all(isinstance(s, LaneStatus) for s in statuses)
    assert statuses == ["ok", "ok"]
    assert json.loads(json.dumps(statuses)) == ["ok", "ok"]
    assert f"{statuses[0]}" == "ok"
    r = runner().run(topo, sched, "dcqcn")
    assert isinstance(r.status, LaneStatus) and r.status == "ok"
    assert classify_lane(True, True, False) is LaneStatus.DIVERGED
    assert classify_lane(False, True, True) is LaneStatus.DEADLOCKED
    assert classify_lane(False, False, False) is LaneStatus.EXHAUSTED


def test_unhealthy_warning_names_lanes_and_dedupes():
    topo, sched = scenario()
    r = runner(cfg=EngineConfig(**TIGHT_KW))
    stacked = {"rai_frac": np.asarray([0.01, 0.03], np.float32)}
    reset_unhealthy_warnings()
    with pytest.warns(RuntimeWarning, match=r"exhausted: lanes \[0, 1\]"):
        r.run_batch(topo, sched, "dcqcn", stacked)
    with warnings.catch_warnings():
        warnings.simplefilter("error", RuntimeWarning)
        r.run_batch(topo, sched, "dcqcn", stacked)
    reset_unhealthy_warnings()
    with pytest.warns(RuntimeWarning, match="lanes unhealthy"):
        r.run_batch(topo, sched, "dcqcn", stacked)


def test_campaign_task_validation(tmp_path):
    topo, sched = scenario()
    with pytest.raises(CampaignError, match="no stacked axes"):
        CampaignTask("empty", topo, sched, "dcqcn").n_lanes
    with pytest.raises(CampaignError, match="inconsistent"):
        CampaignTask("bad", topo, sched, "dcqcn",
                     stacked_params={"rai_frac": np.zeros(3)},
                     stacked_fault={"loss_rate": np.zeros(4)}).n_lanes
    with pytest.raises(CampaignError, match="duplicate task names"):
        run_campaign([one_task(name="a"), one_task(name="a")], "dup",
                     out_dir=str(tmp_path / "never-created"), device="cpu")
    assert not (tmp_path / "never-created").exists()


# ---------------------------------------------------------------------------
# the smoke campaign through both packages
# ---------------------------------------------------------------------------

def _strip(manifest):
    """A manifest without wall seconds, the version key and the
    fingerprint (a hash over the version)."""
    out = json.loads(json.dumps(manifest))
    for k in ("jax", "torch", "fingerprint", "wall_s"):
        out.pop(k, None)
    for ts in out["tasks"].values():
        for c in ts["chunks"]:
            c.pop("wall_s")
    return out


def test_smoke_campaign_matches_reference(tmp_path):
    """``smoke_tasks()`` through both packages' ``run_campaign``: the same
    dtypes, the same manifest apart from wall seconds and version keys,
    and the DCQCN sweep bit-equal.  The lossy HPCC task is bit-equal in
    completion, finish times, PAUSE counts and flags; its delivered bytes
    and soft cost are held at the fault tolerances (per flow and per lane,
    rtol 1e-4), because the reference's own vmapped lanes there differ from its
    serial runs of the same lane (``test_reference_lossy_lanes_differ_
    from_its_serial_runs``) while the port's lanes equal its serial runs
    bit for bit."""
    rtasks, rcfg = rcamp.smoke_tasks()
    ref = rcamp.run_campaign(rtasks, "smoke", out_dir=str(tmp_path / "r"),
                             cfg=rcfg, chunk_lanes=4)
    ptasks, pcfg = smoke_tasks()
    got = campaign(ptasks, "smoke", tmp_path / "p", cfg=pcfg, chunk_lanes=4)
    assert ref.ok and got.ok
    assert _strip(got.manifest) == _strip(ref.manifest)
    assert_batches_bitwise(got.results["dcqcn_rai"],
                           ref.results["dcqcn_rai"])
    a, b = got.results["hpcc_lossy"], ref.results["hpcc_lossy"]
    assert_batches_bitwise(a, b, tuple(k for k in RESULT_ARRAYS
                                       if k not in ("delivered",
                                                    "soft_cost")))
    for k in ("delivered", "soft_cost"):
        assert getattr(a, k).dtype == getattr(b, k).dtype
    np.testing.assert_allclose(a.delivered, b.delivered, rtol=1e-4)
    np.testing.assert_allclose(a.soft_cost, b.soft_cost, rtol=1e-4)
    # the port's lossy lanes are its serial runs, bit for bit
    serial = _dispatch_chunk(runner(cfg=pcfg), ptasks[1], pcfg,
                             np.arange(4), ("serial",))
    for k in RESULT_ARRAYS:
        assert np.array_equal(serial[k], np.asarray(getattr(a, k))), k


def test_reference_lossy_lanes_differ_from_its_serial_runs():
    """Pins why the lossy smoke task is not held bit for bit: the
    reference's vmapped lane 1 (loss 1e-5, PFC off) delivers other
    float32 bytes than its own serial run of the same lane."""
    rtasks, rcfg = rcamp.smoke_tasks()
    t = rtasks[1]
    r = rsweep.SweepRunner(rcfg)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        batch = r.run_batch(t.topo, t.sched, t.policy,
                            stacked_fault=t.stacked_fault)
        lane = RFaultSpec(**{k: float(v[1])
                             for k, v in t.stacked_fault.items()})
        serial = r.run(t.topo, t.sched, t.policy, fault_spec=lane)
    assert np.array_equal(serial.t_finish, batch.t_finish[1])
    assert not np.array_equal(serial.delivered, batch.delivered[1])
