"""The port's backend calibration (``repro_torch.core.sweep``): the
crossover table, its persistence and warm start, and the advice that
``simulate_dlrm_policies`` and ``predict_policies`` follow — the cases of
``tests/test_policy_api.py``, ``tests/test_engine_step_kernel.py``,
``tests/test_sharded.py`` (persistence) and ``tests/test_campaign.py``
(hardening) on the port, and both packages' ``calibrate_backend`` on the
same injected probes."""
import json
import os
import warnings

import pytest
import torch

from repro.core import sweep as rsweep
from repro_torch.core import sweep as sweep_mod
from repro_torch.core import workload as pw
from repro_torch.core.engine import EngineConfig
from repro_torch.core.sweep import (BackendCalibration, SweepRunner,
                                    calibrate_backend, get_calibration,
                                    load_calibration, reset_calibration,
                                    save_calibration)
from repro_torch.core.topology import clos

pytestmark = pytest.mark.campaign

INF = float("inf")


@pytest.fixture(autouse=True)
def clean_tables():
    """Every test starts from the defaults and leaves the process's tables
    (both packages') as it found them."""
    saved = {m: (dict(m._CALIBRATION), set(m._NO_DISK))
             for m in (sweep_mod, rsweep)}
    reset_calibration()
    yield
    for m, (mem, nodisk) in saved.items():
        m._CALIBRATION.clear()
        m._CALIBRATION.update(mem)
        m._NO_DISK.clear()
        m._NO_DISK.update(nodisk)


def _sched(n_flows):
    return type("S", (), {"n_flows": n_flows})()


def fake(kind, n, B, cfg):
    # batched wins below 1000 flows for sweeps, never for the axis
    if kind == "sweep":
        return n, 1.0, (0.5 if n < 1000 else 2.0)
    return n, 1.0, 2.0


# -- defaults and advice ------------------------------------------------------

def test_defaults_are_the_port_s_measurement():
    """The "cpu" row is the port's own CPU measurement (batching won at
    every probe); "cuda" is unlisted (the card's policy-axis probe tied at
    96 flows and won at 1,920), so the card batches everywhere."""
    cal = get_calibration("cpu")
    assert cal.source == "default" and cal.backend == "cpu"
    assert cal.crossover == {"sweep": INF, "policy_axis": INF}
    assert cal.crossover != rsweep.DEFAULT_CROSSOVERS["cpu"]
    card = get_calibration("cuda")
    assert card.source == "default" and card.backend == "cuda"
    assert "cuda" not in sweep_mod.DEFAULT_CROSSOVERS
    assert card.crossover == {"sweep": INF, "policy_axis": INF}
    assert card.pays_off("sweep", 10**9) and card.pays_off("policy_axis")
    # a device type neither table lists batches everywhere
    assert sweep_mod.BackendCalibration("mps").pays_off("policy_axis")
    # None is the port's default device, the card
    assert get_calibration().backend == "cuda"
    assert get_calibration(torch.device("cpu")).backend == "cpu"


def test_batch_pays_off_heuristics():
    """The runner asks the table of its own device type."""
    r = SweepRunner(device="cpu")
    assert r.batch_pays_off(_sched(7)) and r.batch_pays_off(_sched(10**6))
    assert r.policy_axis_pays_off()
    sweep_mod.set_calibration(BackendCalibration(
        "cpu", crossover={"sweep": 2048.0, "policy_axis": 0.0}))
    assert r.batch_pays_off(_sched(2048))
    assert not r.batch_pays_off(_sched(2049))
    assert not r.policy_axis_pays_off()
    assert not r.policy_axis_pays_off(_sched(7))
    # a table for another device type is not this runner's
    sweep_mod.set_calibration(BackendCalibration(
        "cuda", crossover={"sweep": 0.0, "policy_axis": 0.0}))
    sweep_mod.reset_calibration("cpu")
    assert r.batch_pays_off(_sched(10**6)) and r.policy_axis_pays_off()


def test_no_mesh_no_sharding():
    r = SweepRunner(device="cpu")
    assert r.mesh is None and r.n_mesh_devices == 1
    assert not r.sharded_pays_off() and not r.sharded_pays_off(_sched(8))
    # "auto" on a host with at most one CUDA device is no mesh
    auto = SweepRunner(device="cpu", mesh="auto")
    assert auto.mesh is None and not auto.sharded_pays_off()


def test_pays_off_follows_measured_crossover():
    """batch/policy-axis decisions come from the cached measured table."""
    cal = calibrate_backend(probe_flows=(100, 1600), B=4, device="cpu",
                            _measure=fake)
    assert cal.source == "measured" and cal.backend == "cpu"
    assert 100 < cal.crossover["sweep"] < 1600
    assert cal.crossover["policy_axis"] == 0.0
    runner = SweepRunner(device="cpu")
    assert runner.batch_pays_off(_sched(64))
    assert not runner.batch_pays_off(_sched(4096))
    assert not runner.policy_axis_pays_off()
    assert not runner.policy_axis_pays_off(_sched(64))

    cal = calibrate_backend(probe_flows=(100, 1600), B=4, device="cpu",
                            _measure=lambda k, n, B, c: (n, 2.0, 1.0))
    assert cal.crossover["sweep"] == INF
    assert runner.batch_pays_off(_sched(4096))
    assert runner.policy_axis_pays_off()
    rec = cal.record()
    json.dumps(rec)
    assert rec["crossover"]["sweep"] == "inf"


def test_injected_probes_give_the_reference_s_table():
    """The same probes through both packages' ``calibrate_backend``: the
    same crossover table and probe records."""
    for measure in (fake, lambda k, n, B, c: (n, 2.0, 1.0),
                    lambda k, n, B, c: (n + 3, 1.0, 1.0 + (n > 500))):
        want = rsweep.calibrate_backend(probe_flows=(90, 700, 1806), B=6,
                                        backend="cpu", _measure=measure)
        got = calibrate_backend(probe_flows=(90, 700, 1806), B=6,
                                device="cpu", _measure=measure)
        assert got.crossover == want.crossover
        assert got.probes == want.probes
        assert got.record() == want.record()


def test_calibrate_kinds_and_sharded_probe():
    """Default kinds are "sweep" and "policy_axis"; the "sharded" probe
    raises, as the reference's does with one device."""
    seen = []

    def spy(kind, n, B, cfg):
        seen.append(kind)
        return n, 1.0, 0.5
    calibrate_backend(probe_flows=(90,), device="cpu", _measure=spy)
    assert seen == ["sweep", "policy_axis"]
    with pytest.raises(RuntimeError, match="mesh"):
        sweep_mod._measure_crossover("sharded", 90, 2, EngineConfig(),
                                     device="cpu")
    with pytest.raises(ValueError, match="unknown calibration kind"):
        sweep_mod._measure_crossover("bogus", 90, 2, EngineConfig(),
                                     device="cpu")


def test_measure_crossover_times_both_paths():
    """The default probe on the CPU at a tiny size: the flow count of its
    all-reduce and two positive wall times per kind."""
    n_threads = torch.get_num_threads()
    torch.set_num_threads(1)
    cfg = EngineConfig(dt=2e-6, max_steps=40, max_extends=0,
                       queue_stride=0)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        for kind in ("sweep", "policy_axis"):
            n, serial_s, batched_s = sweep_mod._measure_crossover(
                kind, 90, 2, cfg, device="cpu")
            assert n == 96 and serial_s > 0 and batched_s > 0
    torch.set_num_threads(n_threads)


def test_injected_probes_are_never_persisted(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_CACHE_DIR", str(tmp_path))
    calibrate_backend(probe_flows=(90,), device="cpu", _measure=fake)
    assert os.listdir(tmp_path) == []


# -- persistence ----------------------------------------------------------------

def test_calibration_save_load_roundtrip(tmp_path):
    cal = BackendCalibration(
        backend="cpu", source="measured",
        crossover={"sweep": 123.0, "policy_axis": 0.0, "sharded": INF},
        probes=(("sweep", 90, 0.5, 0.2),))
    path = str(tmp_path / "cal.json")
    assert save_calibration(cal, path) == path
    rec = json.load(open(path))
    assert rec["torch"] == {"version": torch.__version__,
                            "cuda_devices": torch.cuda.device_count()}
    assert "jax" not in rec
    got = load_calibration("cpu", path=path)
    assert got is not None
    assert got.crossover == cal.crossover
    assert got.probes == cal.probes
    assert got.source == "measured"


def test_calibration_load_rejects_mismatch(tmp_path):
    cal = BackendCalibration(backend="cpu", source="measured",
                             crossover={"sweep": 1.0})
    path = str(tmp_path / "cal.json")
    save_calibration(cal, path)
    rec = json.load(open(path))
    for bad in (dict(rec, backend="cuda"),
                dict(rec, torch=dict(rec["torch"], version="0.0.0")),
                dict(rec, torch=dict(rec["torch"], cuda_devices=99)),
                {k: v for k, v in rec.items() if k != "torch"}):
        json.dump(bad, open(path, "w"))
        assert load_calibration("cpu", path=path) is None
    json.dump(dict(rec, saved_at=0.0), open(path, "w"))
    assert load_calibration("cpu", path=path, max_age_days=1.0) is None
    json.dump(rec, open(path, "w"))
    assert load_calibration("cpu", path=path) is not None


def test_get_calibration_warm_starts_from_disk(tmp_path, monkeypatch):
    """A fresh process (simulated: cleared in-memory table + _NO_DISK)
    picks up the persisted measurement; reset_calibration pins back to
    the defaults without reconsulting the file."""
    monkeypatch.setenv("REPRO_CACHE_DIR", str(tmp_path))
    save_calibration(BackendCalibration(backend="cpu", source="measured",
                                        crossover={"sweep": 777.0}))
    assert os.listdir(tmp_path) == ["repro_torch_calibration_cpu.json"]
    sweep_mod._CALIBRATION.clear()
    sweep_mod._NO_DISK.clear()
    got = get_calibration("cpu")
    assert got.source == "measured" and got.crossover["sweep"] == 777.0
    assert not SweepRunner(device="cpu").batch_pays_off(_sched(778))
    reset_calibration()
    assert get_calibration("cpu").source == "default"


def test_get_calibration_env_gate(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_CACHE_DIR", str(tmp_path))
    monkeypatch.setenv("REPRO_CALIBRATION_CACHE", "0")
    save_calibration(BackendCalibration(
        backend="cpu", source="measured", crossover={"sweep": 777.0}))
    sweep_mod._CALIBRATION.clear()
    sweep_mod._NO_DISK.clear()
    assert get_calibration("cpu").source == "default"


def test_calibration_corrupt_cache_ignored(tmp_path):
    path = str(tmp_path / "repro_torch_calibration_cpu.json")
    with open(path, "w") as f:
        f.write('{"backend": "cpu", "crossover": {"sweep": ')   # truncated
    with pytest.warns(RuntimeWarning, match="corrupt calibration cache"):
        assert load_calibration("cpu", path=path) is None
    with open(path, "w") as f:
        json.dump({"backend": "cpu", "torch": sweep_mod._torch_record(),
                   "probes": [{"bogus": 1}]}, f)
    with pytest.warns(RuntimeWarning, match="malformed calibration cache"):
        assert load_calibration("cpu", path=path) is None
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert load_calibration("cpu",
                                path=str(tmp_path / "nope.json")) is None


def test_save_calibration_atomic(tmp_path):
    cal = BackendCalibration(backend="cpu", source="measured",
                             crossover={"sweep": 123.0})
    path = str(tmp_path / "cal.json")
    assert save_calibration(cal, path=path) == path
    assert not [f for f in os.listdir(tmp_path) if ".tmp." in f]
    loaded = load_calibration("cpu", path=path)
    assert loaded is not None and loaded.crossover["sweep"] == 123.0


def test_cache_files_do_not_collide(tmp_path, monkeypatch):
    """Both packages persist under one ``REPRO_CACHE_DIR`` without
    overwriting each other, and neither reads the other's table."""
    monkeypatch.setenv("REPRO_CACHE_DIR", str(tmp_path))
    assert sweep_mod.calibration_cache_path("cpu") != \
        rsweep.calibration_cache_path("cpu")
    rsweep.save_calibration(rsweep.BackendCalibration(
        backend="cpu", source="measured", crossover={"sweep": 111.0}))
    save_calibration(BackendCalibration(
        backend="cpu", source="measured", crossover={"sweep": 222.0}))
    assert sorted(os.listdir(tmp_path)) == [
        "repro_calibration_cpu.json", "repro_torch_calibration_cpu.json"]
    assert load_calibration("cpu").crossover["sweep"] == 222.0
    assert rsweep.load_calibration("cpu").crossover["sweep"] == 111.0
    # the reference's file, read by the port, is refused (no torch record)
    assert load_calibration(
        "cpu", path=rsweep.calibration_cache_path("cpu")) is None


# -- the DLRM policy loop follows the advice ---------------------------------

class SpyRunner(SweepRunner):
    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.calls = []

    def run_policy_axis(self, *a, **kw):
        self.calls.append("policy_axis")
        return super().run_policy_axis(*a, **kw)

    def run_spec(self, *a, **kw):
        self.calls.append("serial")
        return super().run_spec(*a, **kw)


@pytest.mark.parametrize("axis, want", [(0.0, ["serial", "serial"]),
                                        (INF, ["policy_axis"])])
def test_dlrm_policies_follow_installed_table(axis, want):
    """``simulate_dlrm_policies(batched=None)`` runs the policy axis as one
    batch only where the installed table says it pays off."""
    sweep_mod.set_calibration(BackendCalibration(
        "cpu", crossover={"sweep": INF, "policy_axis": axis}))
    cfg = EngineConfig(dt=1e-6, max_steps=30, max_extends=0, queue_stride=0)
    runner = SpyRunner(cfg, device="cpu")
    comm = pw.DLRMCommSpec(allreduce_bytes=1e5, alltoall_fwd_bytes=1e5,
                           alltoall_bwd_bytes=1e5, n_chunks=1,
                           allreduce_algo="1d")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        reps = pw.simulate_dlrm_policies(clos(1, 2, 2), list(range(4)),
                                         ("pfc", "dcqcn"), comm=comm,
                                         cfg=cfg, runner=runner)
    assert runner.calls == want
    assert [r.policy for r in reps] == ["pfc", "dcqcn"]
