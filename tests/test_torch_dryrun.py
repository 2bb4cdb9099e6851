"""``repro_torch.launch.dryrun`` against the reference's dry run: the
smoke TinyLlama's and Gemma-2's train and prefill cells and TinyLlama's
decode cell (``tests/_mesh_ranks.DRYRUN_CELLS``) on (data=4, model=2),
the reference lowered and compiled on 8 forced host devices in a
subprocess (``tests/_mesh_reference.py dryrun_smoke``), the port traced
on ``meta`` under a recording mesh:

* ``n_params`` and ``memory.argument_bytes`` equal;
* ``flops`` within 10%; in the cells that accumulate microbatches the
  reference's GSPMD lays each microbatch over half the data ranks and
  repeats dots (PERF.md names them): there the port does no more than
  the reference and exactly one eighth of the one-process step (it
  repeats no dot);
* the collective bytes by kind printed beside the reference's;
* a step's recording equal to the live ``comm.counters()`` of the same
  step on 4 CPU ranks: calls and bytes by kind, exactly;
* the CLI's flags and record at full width, ``--all`` writing only under
  ``experiments/dryrun_torch/`` and listing its failing cells, the
  records as ``CollectiveOp``s for ``predict``'s replay, and the cells the
  port does not trace raising."""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import _mesh_ranks
from repro_torch.common import comm
from repro_torch.configs import smoke_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as lmesh

ROOT = Path(__file__).resolve().parents[1]
SHAPES = {k: ShapeConfig(k, **v) for k, v in
          _mesh_ranks.DRYRUN_SHAPES.items()}
CELLS = _mesh_ranks.DRYRUN_CELLS
IDS = [f"{a}-{s}" for a, s in CELLS]


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun_ref")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, str(ROOT / "tests" /
                                            "_mesh_reference.py"), str(out),
                        "dryrun_smoke"], capture_output=True, text=True,
                       env=env, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    d = np.load(out / "dryrun_smoke.npz")
    return {k: json.loads(str(d[k])) for k in d.files}


def _port(arch, shape, mesh_shape=_mesh_ranks.DRYRUN_MESH):
    return dryrun.dryrun_cell(arch, shape, False, False,
                              cfg=smoke_config(arch), shape=SHAPES[shape],
                              mesh_shape=mesh_shape)


@pytest.mark.parametrize("arch,shape", CELLS, ids=IDS)
def test_smoke_cell_matches_reference(ref, arch, shape):
    want = ref[f"{arch}.{shape}"]
    got = _port(arch, shape)
    print(f"{arch} {shape}: flops {got['flops']} (reference "
          f"{want['flops']}); collective bytes {got['collective_bytes']} "
          f"(reference {want['collective_bytes']})")
    assert got["n_params"] == want["n_params"]
    assert got["memory"]["argument_bytes"] == \
        want["memory"]["argument_bytes"]
    assert got["gathered_leaves"] == []
    s = SHAPES[shape]
    if s.kind == "train" and got["microbatch"] < s.global_batch:
        one = _port(arch, shape, (1, 1))["flops"]
        assert got["flops"] * 8 == one
        assert got["flops"] <= want["flops"]
    else:
        assert abs(got["flops"] / want["flops"] - 1) <= 0.10


def counted_rank(rank, seq_parallel):
    return _mesh_ranks.counted_lm_step(rank, seq_parallel, 2)


def _recording(rank, seq_parallel):
    from repro_torch.configs.base import TrainConfig
    from repro_torch.models import Model
    cfg = dataclasses.replace(smoke_config("tinyllama-1.1b"),
                              seq_parallel=seq_parallel)
    mesh = comm.RecordingMesh((2, 2), ("data", "model"), rank)
    model = Model(cfg, device="meta", mesh=mesh)
    shape = ShapeConfig("t", seq_len=_mesh_ranks.LM_SEQ,
                        global_batch=_mesh_ranks.LM_BATCH, kind="train")
    cell = dryrun.trace_step(model, shape, mesh, gradspec=True,
                             tcfg=TrainConfig(microbatch=2,
                                              **_mesh_ranks.TCFG))
    cell["run"]()
    out = {k: {"calls": 0, "bytes": 0} for k in comm.KINDS}
    for r in mesh.records:
        out[r.kind]["calls"] += 1
        out[r.kind]["bytes"] += r.bytes
    return out


@pytest.mark.parametrize("sp", [False, True], ids=["plain", "seq_parallel"])
def test_recording_equals_live_counters(sp):
    live = lmesh.launch(counted_rank, 4, devices=["cpu"] * 4, args=(sp,),
                        join_s=120)
    for rank, counters in enumerate(live):
        got = {k: {"calls": v["calls"], "bytes": v["bytes"]}
               for k, v in counters.items()}
        assert _recording(rank, sp) == got, rank


def test_cli_writes_a_full_width_cell(tmp_path, capsys):
    out = tmp_path / "cell.json"
    dryrun.main(["--arch", "tinyllama-1.1b", "--shape", "decode_32k",
                 "--out", str(out)])
    cell = json.loads(out.read_text())
    printed = capsys.readouterr().out
    assert json.loads(printed[printed.index("{\n"):]) == cell
    for key in ("arch", "shape", "mesh", "n_devices", "n_params", "kind",
                "memory", "flops", "bytes_accessed", "bytes_floor",
                "collective_bytes", "collective_bytes_raw",
                "gathered_leaves", "lower_s", "compile_s"):
        assert key in cell, key
    assert (cell["mesh"], cell["n_devices"], cell["kind"]) == \
        ("16x16", 256, "decode")
    assert cell["n_params"] == 1_100_048_384
    assert cell["memory"]["peak_bytes"] is None
    assert cell["memory"]["temp_bytes"] is None
    assert cell["flops"] > 0 and cell["collective_bytes"]["total"] > 0
    # TinyLlama's 4 kv heads stay whole over model=16; nothing is gathered
    assert cell["gathered_leaves"] == []


def test_all_lists_failing_cells_and_writes_only_its_own_dir(
        tmp_path, monkeypatch, capsys):
    import repro_torch.configs as configs
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(configs, "ARCHS", ("tinyllama-1.1b",))
    ran = []

    def fake_run(cmd, **kw):
        tag = Path(cmd[cmd.index("--out") + 1]).stem
        ran.append(tag)
        if tag == "tinyllama-1.1b_prefill_32k_mp":
            return subprocess.CompletedProcess(cmd, 1, "", "Traceback: x")
        Path(cmd[cmd.index("--out") + 1]).write_text("{}")
        return subprocess.CompletedProcess(cmd, 0, "", "")
    monkeypatch.setattr(dryrun.subprocess, "run", fake_run)
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--all"])
    assert e.value.code == 1
    assert len(ran) == 6 and "tinyllama-1.1b_train_4k_sp" in ran
    assert "failed: tinyllama-1.1b_prefill_32k_mp" in capsys.readouterr().out
    written = sorted(str(p.relative_to(tmp_path))
                     for p in tmp_path.rglob("*") if p.is_file())
    assert written and all(p.startswith(os.path.join("experiments",
                                                     "dryrun_torch"))
                           for p in written)


def test_records_feed_the_hlo_replay():
    from repro_torch.core.hlo_comm import summarize
    from repro_torch.core.predict import HLOReplaySpec
    from repro_torch.core.topology import single_switch
    got = _port("tinyllama-1.1b", "smoke_train1")
    mesh = comm.RecordingMesh(_mesh_ranks.DRYRUN_MESH, ("data", "model"))
    model_cfg = smoke_config("tinyllama-1.1b")
    from repro_torch.models import Model
    model = Model(model_cfg, device="meta", mesh=mesh)
    dryrun.trace_step(model, SHAPES["smoke_train1"], mesh)["run"]()
    ops, axis_of_op = dryrun.collective_ops(mesh.records, mesh)
    assert summarize(ops) == got["collective_bytes_raw"]
    assert sum(op.count for op in ops) == len(mesh.records)
    sched = HLOReplaySpec(tuple(ops), _mesh_ranks.DRYRUN_MESH,
                          tuple(axis_of_op)).build_schedule(
                              single_switch(8))
    assert sched is not None


@pytest.mark.parametrize("arch,shape,over", [
    ("gemma2-9b", ShapeConfig("long", seq_len=512, global_batch=1,
                              kind="decode", cache_shard="seq"), {}),
    ("deepseek-v2-236b", SHAPES["smoke_train1"], {"seq_parallel": True})],
    ids=["sequence-split-cache", "seq_parallel-over-mla"])
def test_cells_the_port_does_not_trace_raise(arch, shape, over):
    cfg = dataclasses.replace(smoke_config(arch), **over)
    with pytest.raises(NotImplementedError):
        dryrun.dryrun_cell(arch, shape.name, False, False, cfg=cfg,
                           shape=shape, mesh_shape=(2, 2))
