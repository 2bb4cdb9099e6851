"""Sweep lanes over a device mesh in the port (``repro_torch.common.
sharding``, ``SweepRunner(mesh=...)``) against the reference's mesh
functions and against the port's own ``mesh=None`` batches.

The CPU has one device, so the meshes here repeat it
(``grid_mesh(n, devices=["cpu"] * n)``): each mesh position's block of
lanes runs as a batch of its own, one after another.  Every lane of a
mesh batch must equal the ``mesh=None`` batch bit for bit (a lane equals
its serial run bit for bit, whatever batch it is in), and the reference's
vmapped batch at the repository's tolerances (rtol 1e-5 on
``completion_time``).
"""
import dataclasses
import warnings

import numpy as np
import pytest
import torch

from repro.common import sharding as rshard
from repro.core import sweep as rsweep
from repro.core.collectives import allreduce_1d as r_allreduce_1d
from repro.core.collectives import incast as r_incast
from repro.core.engine import EngineConfig as REngineConfig
from repro.core.faults import FaultSpec as RFaultSpec
from repro.core.topology import single_switch as r_single_switch
from repro_torch import convert
from repro_torch.common import sharding as pshard
from repro_torch.core import campaign as pcamp
from repro_torch.core import engine as peng
from repro_torch.core import sweep as psweep
from repro_torch.core.faults import FaultSpec

CFG_KW = dict(dt=2e-6, max_steps=600, max_extends=1, queue_stride=0)
CFG = peng.EngineConfig(**CFG_KW)
ARRAYS = ("completion_time", "t_finish", "pause_count", "delivered",
          "soft_cost", "finished", "diverged", "deadlock_step", "storm_step",
          "extend_exhausted")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _rearm_unhealthy_warning():
    rsweep.reset_unhealthy_warnings()
    psweep.reset_unhealthy_warnings()


def cpu_mesh(n):
    return pshard.grid_mesh(n, devices=["cpu"] * n)


def allreduce(n=4, mb=4e6):
    topo = r_single_switch(n)
    sched = r_allreduce_1d(topo, list(range(n)), mb)
    return (topo, sched), (convert.topology_from_numpy(topo),
                           convert.schedule_from_numpy(sched))


def assert_bitwise(a, b):
    assert a.n == b.n and a.policy_axis == b.policy_axis
    for k in ARRAYS:
        va, vb = np.asarray(getattr(a, k)), np.asarray(getattr(b, k))
        assert va.dtype == vb.dtype, k
        assert np.array_equal(va, vb, equal_nan=True), k
    assert a.lane_status() == b.lane_status()
    for k in a.params:
        assert np.array_equal(a.params[k], b.params[k]), k
    assert a.meta["lane_steps"] == b.meta["lane_steps"]


def assert_near_reference(port, ref):
    assert port.lane_status() == ref.lane_status()
    np.testing.assert_allclose(port.completion_time, ref.completion_time,
                               rtol=1e-5)
    np.testing.assert_allclose(port.delivered, ref.delivered, rtol=1e-4,
                               atol=1e-3)


# -- mesh resolution ---------------------------------------------------------

@pytest.mark.parametrize("n_avail, n_want", [
    (1, None), (1, 1), (2, None), (2, 1), (2, 2), (3, 2), (8, 8), (2, 3),
    (0, 1)])
def test_grid_mesh_matches_reference(n_avail, n_want):
    """``grid_mesh(n, devices=...)`` over the same number of devices:
    ``None`` below two, a mesh of the first n, ``ValueError`` past the
    list, as the reference's over its (repeated) host device."""
    rdev = [rshard.jax.devices()[0]] * n_avail
    pdev = ["cpu"] * n_avail
    try:
        want = rshard.grid_mesh(n_want, devices=rdev)
    except ValueError:
        with pytest.raises(ValueError, match="wants"):
            pshard.grid_mesh(n_want, devices=pdev)
        return
    got = pshard.grid_mesh(n_want, devices=pdev)
    if want is None:
        assert got is None
        return
    assert (got.axis,) == tuple(want.axis_names) == (pshard.GRID_AXIS,)
    assert got.size == rshard._mesh_size(want) == pshard._mesh_size(got)
    assert got.devices == (torch.device("cpu"),) * got.size


def test_resolve_grid_mesh_matches_reference():
    """None stays None; "auto" and int counts take every visible device
    (one JAX host device there, no CUDA device here: no mesh); a count
    past them raises ValueError (1 here, where no CUDA device is
    visible); anything else TypeError; a prebuilt mesh passes through
    (None when it holds one device)."""
    for mesh in (None, "auto", 1, 0):
        assert rshard.resolve_grid_mesh(mesh) is None
    for mesh in (None, "auto", 0):
        assert pshard.resolve_grid_mesh(mesh) is None
    assert not torch.cuda.is_available()
    with pytest.raises(ValueError, match="only 0 are available"):
        pshard.resolve_grid_mesh(1)
    for bad in (2, 5):
        with pytest.raises(ValueError):
            rshard.resolve_grid_mesh(bad)
        with pytest.raises(ValueError):
            pshard.resolve_grid_mesh(bad)
    for bad in (3.5, "all", [0, 1]):
        with pytest.raises(TypeError):
            rshard.resolve_grid_mesh(bad)
        with pytest.raises(TypeError, match="GridMesh"):
            pshard.resolve_grid_mesh(bad)
    m = cpu_mesh(3)
    assert pshard.resolve_grid_mesh(m) is m
    assert pshard.resolve_grid_mesh(pshard.GridMesh(("cpu",))) is None
    assert dataclasses.replace(m, axis="lanes").axis == "lanes"


def _reference_chunk_size(n_dev, chunk_lanes, B):
    """The reference's ``SweepRunner._chunk_size`` on a mesh of
    ``n_dev`` devices (its mesh only supplies the device count)."""
    class Mesh:
        devices = np.empty(n_dev)
    r = rsweep.SweepRunner(REngineConfig(**CFG_KW),
                           chunk_lanes=chunk_lanes)
    if n_dev > 1:
        r.mesh = Mesh()
    return r._chunk_size(B)


@pytest.mark.parametrize("chunk_lanes", [None, 0, "auto", 1, 3, 4, 10])
def test_chunk_size_matches_reference(chunk_lanes):
    """Chunks are a multiple of the mesh, padded up from B, capped by
    ``chunk_lanes`` (rounded up to the mesh) or 256 lanes a device."""
    for n_dev in (1, 2, 3, 8):
        pr = psweep.SweepRunner(CFG, device="cpu", chunk_lanes=chunk_lanes,
                                mesh=cpu_mesh(n_dev) if n_dev > 1 else None)
        assert pr.n_mesh_devices == n_dev
        for B in (1, 2, 3, 5, 7, 8, 9, 16, 255, 256, 257, 600, 2049):
            got = pr._chunk_size(B)
            assert got == _reference_chunk_size(n_dev, chunk_lanes, B), \
                (n_dev, B)
            assert got % n_dev == 0 and got >= min(B, 1)


# -- lanes over a mesh of repeated CPU devices --------------------------------

@pytest.mark.parametrize("n_dev, chunk_lanes", [(2, "auto"), (3, None),
                                                (2, 3)])
def test_run_batch_on_mesh_bit_equal(n_dev, chunk_lanes):
    """7 lanes (not a multiple of 2 or 3; with ``chunk_lanes=3`` three
    chunks of 4, the last padded): bit-equal to ``mesh=None``, near the
    reference, lanes in input order, the hook called once a chunk."""
    (rt, rs), (pt, ps) = allreduce()
    scale = np.linspace(0.5, 2.0, 7).astype(np.float32)
    stacked = {"rai_frac": 0.03 * scale}
    seen = []
    mesh = psweep.SweepRunner(CFG, device="cpu", mesh=cpu_mesh(n_dev),
                              chunk_lanes=chunk_lanes,
                              dispatch_hook=lambda *a: seen.append(a))
    got = mesh.run_batch(pt, ps, "dcqcn", stacked)
    plain = psweep.SweepRunner(CFG, device="cpu").run_batch(
        pt, ps, "dcqcn", stacked)
    assert_bitwise(got, plain)
    assert got.meta["mesh_devices"] == n_dev
    chunk = mesh._chunk_size(7)
    assert got.meta["chunk_lanes"] == chunk
    assert seen == [(lo, min(lo + chunk, 7), 7) for lo in range(0, 7, chunk)]
    assert np.array_equal(got.params["rai_frac"], stacked["rai_frac"])
    ref = rsweep.SweepRunner(REngineConfig(**CFG_KW)).run_batch(
        rt, rs, "dcqcn", stacked)
    assert_near_reference(got, ref)


def test_grid_and_policy_axis_on_mesh_bit_equal():
    """A CC x fabric grid (6 lanes) and the policy axis over five
    policies (5 lanes on a mesh of 2) through the mesh."""
    (rt, rs), (pt, ps) = allreduce()
    mesh = psweep.SweepRunner(CFG, device="cpu", mesh=cpu_mesh(2))
    plain = psweep.SweepRunner(CFG, device="cpu")
    ref = rsweep.SweepRunner(REngineConfig(**CFG_KW))
    grid = {"rai_frac": [0.01, 0.05, 0.2]}
    fab = {"xoff": [0.3e6, 1e6]}
    g = mesh.grid(pt, ps, "dcqcn", grid, fabric_grid=fab)
    assert_bitwise(g, plain.grid(pt, ps, "dcqcn", grid, fabric_grid=fab))
    assert_near_reference(g, ref.grid(rt, rs, "dcqcn", grid,
                                      fabric_grid=fab))
    pols = ["dcqcn", "timely", "hpcc", "dctcp", "pfc"]
    a = mesh.run_policy_axis(pt, ps, pols)
    assert [a.policy_of(i) for i in range(a.n)] == pols
    assert_bitwise(a, plain.run_policy_axis(pt, ps, pols))
    assert_near_reference(a, ref.run_policy_axis(rt, rs, pols))


def test_fault_stack_on_mesh_bit_equal():
    """The reference's sharded fault grid (loss x recovery, PFC off, 6
    lanes on a mesh of 4: one pad lane) with unhealthy lanes: the same
    statuses, bit-equal lanes, the port's lost bytes included."""
    topo = r_single_switch(8)
    sched = r_incast(topo, list(range(1, 8)), 0, 5e6)
    pt, ps = convert.topology_from_numpy(topo), \
        convert.schedule_from_numpy(sched)
    kw = dict(dt=1e-6, max_steps=400, max_extends=0, queue_stride=0)
    fault_grid = {"loss_rate": [0.0, 1e-4, 3e-3], "gbn": [0.0, 1.0]}
    args = (("dcqcn",), dict(param_grid={"rai_frac": [0.03]},
                             fault_grid=fault_grid))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        got = psweep.SweepRunner(peng.EngineConfig(**kw), device="cpu",
                                 mesh=cpu_mesh(4)).grid(
            pt, ps, *args[0], fault_spec=FaultSpec(pfc_on=0.0), **args[1])
        plain = psweep.SweepRunner(peng.EngineConfig(**kw),
                                   device="cpu").grid(
            pt, ps, *args[0], fault_spec=FaultSpec(pfc_on=0.0), **args[1])
        ref = rsweep.SweepRunner(REngineConfig(**kw)).grid(
            topo, sched, *args[0], fault_spec=RFaultSpec(pfc_on=0.0),
            **args[1])
    assert_bitwise(got, plain)
    assert np.array_equal(got.lost, plain.lost)
    assert got.lane_status() == ref.lane_status()
    ok = np.asarray([s == "ok" for s in ref.lane_status()])
    np.testing.assert_allclose(got.completion_time[ok],
                               ref.completion_time[ok], rtol=1e-5)
    np.testing.assert_allclose(got.delivered[ok], ref.delivered[ok],
                               rtol=1e-4, atol=1e-3)


def test_distinct_devices_run_in_threads(monkeypatch):
    """The branch a mesh of distinct devices takes (one host thread a
    device), on the CPU by naming each mesh position a device of its own:
    the lanes come back in order, bit-equal; an error raised on one
    device's thread raises from ``run_batch``."""
    (_, _), (pt, ps) = allreduce()
    names = iter(range(10**6))
    threads = set()
    real_block = psweep._run_block

    def block(sim, idx, *a):
        import threading
        threads.add(threading.get_ident())
        return real_block(sim, idx, *a)
    monkeypatch.setattr(psweep, "_canonical", lambda d: next(names))
    monkeypatch.setattr(psweep, "_device_context", lambda d: torch.no_grad())
    monkeypatch.setattr(peng.Simulator, "on", lambda self, d: self)
    monkeypatch.setattr(psweep, "_run_block", block)
    stacked = {"rai_frac": np.geomspace(0.005, 0.2, 5).astype(np.float32)}
    mesh = psweep.SweepRunner(CFG, device="cpu", mesh=cpu_mesh(3))
    got = mesh.run_batch(pt, ps, "dcqcn", stacked)
    assert len(threads) == 3
    monkeypatch.setattr(psweep, "_run_block", real_block)
    assert_bitwise(got, psweep.SweepRunner(CFG, device="cpu").run_batch(
        pt, ps, "dcqcn", stacked))

    def fail(sim, idx, *a):
        if 4 in idx:
            raise RuntimeError("injected device fault")
        return real_block(sim, idx, *a)
    monkeypatch.setattr(psweep, "_run_block", fail)
    with pytest.raises(RuntimeError, match="injected device fault"):
        mesh.run_batch(pt, ps, "dcqcn", stacked)


def test_mesh_devices_must_match_the_runner():
    """No fallback: a mesh device of another type, or one the process
    cannot see, is refused."""
    with pytest.raises(ValueError, match="not a cpu device"):
        psweep.SweepRunner(CFG, device="cpu", mesh=pshard.GridMesh(
            ("cpu", "meta")))
    with pytest.raises(ValueError, match="cuda:0 is not a cpu device"):
        psweep.SweepRunner(CFG, device="cpu", mesh=pshard.GridMesh(
            ("cuda:0", "cuda:0")))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        psweep.SweepRunner(CFG, mesh=pshard.GridMesh(("cuda:0", "cuda:0")))
    r = psweep.SweepRunner(CFG, device="cpu", mesh=cpu_mesh(2))
    sub = r.share_prep(chunk_lanes=2)
    assert sub.mesh is r.mesh and sub._sims is r._sims
    assert r.share_prep(mesh=None).mesh is None


def test_simulator_replica_on_its_own_device_is_itself():
    (_, _), (pt, ps) = allreduce()
    sim = psweep.SweepRunner(CFG, device="cpu").simulator(
        pt, ps, psweep._resolve("dcqcn"))
    assert sim.on("cpu") is sim and sim.on(torch.device("cpu")) is sim
    with pytest.raises(ValueError, match="unsupported device"):
        sim.on("meta")


# -- advice and calibration ---------------------------------------------------

def test_sharded_pays_off_follows_the_table():
    """False without a mesh; with one, the "sharded" row of the runner's
    device type decides (unlisted: inf, always), as in the reference."""
    plain = psweep.SweepRunner(CFG, device="cpu")
    mesh = psweep.SweepRunner(CFG, device="cpu", mesh=cpu_mesh(2))
    try:
        assert not plain.sharded_pays_off()
        assert mesh.sharded_pays_off()
        psweep.set_calibration(psweep.BackendCalibration(
            "cpu", crossover={"sharded": 1000.0}))

        class Sched:
            n_flows = 2000
        assert not mesh.sharded_pays_off() and not mesh.sharded_pays_off(
            Sched)
        Sched.n_flows = 500
        assert mesh.sharded_pays_off(Sched)
        assert not plain.sharded_pays_off(Sched)
    finally:
        psweep.reset_calibration()


def test_sharded_calibration_on_one_device_host():
    """The "sharded" probe times the mesh of every visible CUDA device
    against one device: on a host without two it raises with the
    reference's reason, and the default kinds leave it out."""
    seen = []

    def spy(kind, n, B, cfg):
        seen.append(kind)
        return n, 1.0, 0.5
    try:
        psweep.calibrate_backend(probe_flows=(90,), device="cpu",
                                 _measure=spy)
    finally:
        psweep.reset_calibration()
    assert seen == ["sweep", "policy_axis"]
    with pytest.raises(RuntimeError, match="more than one CUDA device"):
        psweep._measure_crossover("sharded", 90, 2, CFG, device="cpu")
    with pytest.raises(RuntimeError, match="JAX device"):
        rsweep._measure_crossover("sharded", 90, 2, REngineConfig(**CFG_KW))


# -- the campaign's no_mesh rung ------------------------------------------------

def test_campaign_no_mesh_rung(tmp_path):
    """On a mesh runner the ladder is half_chunk -> no_mesh -> serial, as
    the reference's without its jnp rung; failures on the first two
    dispatches take the no_mesh rung, which runs the chunk on the
    runner's own device, and the campaign equals the plain one bit for
    bit."""
    (_, _), (pt, ps) = allreduce()
    grid = np.geomspace(0.005, 0.2, 5).astype(np.float32)
    task = pcamp.CampaignTask("dcqcn_rai", pt, ps, "dcqcn",
                              stacked_params={"rai_frac": grid})
    mesh_runner = psweep.SweepRunner(CFG, device="cpu", mesh=cpu_mesh(2))
    assert pcamp._applicable_ladder(mesh_runner, CFG) == \
        ("half_chunk", "no_mesh", "serial")
    assert pcamp._applicable_ladder(psweep.SweepRunner(CFG, device="cpu"),
                                    CFG) == ("half_chunk", "serial")
    # each rung's chunk equals the plain dispatch
    idx = np.arange(5)
    plain = pcamp._dispatch_chunk(mesh_runner, task, CFG, idx, ())
    for demos in (("half_chunk",), ("half_chunk", "no_mesh")):
        got = pcamp._dispatch_chunk(mesh_runner, task, CFG, idx, demos)
        for k in ARRAYS:
            assert np.array_equal(got[k], plain[k]), (demos, k)

    attempts = []

    def hook(lo, hi, B):
        attempts.append((lo, hi, B))
        if len(attempts) <= 2:
            raise torch.OutOfMemoryError("injected OOM")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        res = pcamp.run_campaign(
            [task], "no_mesh", out_dir=str(tmp_path), cfg=CFG,
            runner=psweep.SweepRunner(CFG, device="cpu", mesh=cpu_mesh(2),
                                      dispatch_hook=hook),
            max_retries=3, backoff_s=0.0)
        ref = pcamp.run_campaign([task], "plain", out_dir=str(tmp_path),
                                 cfg=CFG, device="cpu")
    assert res.ok and ref.ok
    ts = res.manifest["tasks"]["dcqcn_rai"]
    assert [d["rung"] for d in ts["demotions"]] == ["half_chunk", "no_mesh"]
    assert ts["chunks"][0]["demotions"] == ["half_chunk", "no_mesh"]
    assert res.manifest["config"]["mesh_devices"] == 2
    for k in ARRAYS:
        assert np.array_equal(getattr(res.results["dcqcn_rai"], k),
                              getattr(ref.results["dcqcn_rai"], k)), k
