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
  records as ``CollectiveOp``s for ``predict``'s replay, the cells the
  port once refused now tracing (a sequence-split cache, ``seq_parallel``
  over MLA) and the one it does not trace raising;
* the smoke ``long_500k``-style cells (a cache split along the sequence
  over ``data``) of the long-context families traced, and no leaf of any
  arch gathered whole on the production mesh (16, 16) or (2, 16, 16)."""
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
from repro_torch.configs import ARCHS, smoke_config
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


LONG = ShapeConfig("long", seq_len=512, global_batch=1, kind="decode",
                   cache_shard="seq")


@pytest.mark.parametrize("arch,shape,over,traces", [
    ("gemma2-9b", LONG, {}, True),
    ("deepseek-v2-236b", SHAPES["smoke_train1"],
     {"seq_parallel": True, "moe_impl": "tp"}, True),
    ("deepseek-v2-236b", ShapeConfig("seqcache", seq_len=512,
                                     global_batch=4, kind="decode"),
     {"decode_seq_shard": True, "moe_impl": "ep_a2a"}, True)],
    ids=["sequence-split-cache", "seq_parallel-over-mla",
         "mla-sequence-split-cache"])
def test_cells_the_port_does_not_trace_raise(arch, shape, over, traces):
    """A cache split along the sequence (``long_500k``'s layout),
    ``seq_parallel`` over MLA and MLA over a latent cache split along the
    sequence over ``model`` (``decode_seq_shard``, DeepSeek-V2's own
    ``ep_a2a`` body) once raised here; they trace now, the first merging
    its blocks' attention across the data ranks (a ``pmax`` and a
    ``psum`` a global layer), the last across the model ranks (one
    ``pmax`` an MLA layer), and none gathering a leaf whole."""
    cfg = dataclasses.replace(smoke_config(arch), **over)
    if not traces:
        with pytest.raises(NotImplementedError):
            dryrun.dryrun_cell(arch, shape.name, False, False, cfg=cfg,
                               shape=shape, mesh_shape=(2, 2))
        return
    cell = dryrun.dryrun_cell(arch, shape.name, False, False, cfg=cfg,
                              shape=shape, mesh_shape=(2, 2))
    assert cell["gathered_leaves"] == []
    assert np.isfinite(cell["flops"]) and cell["flops"] > 0
    if shape.cache_shard == "seq":
        n_global = sum(c == "g" for c in cfg.attn_pattern) * (
            cfg.n_layers // len(cfg.attn_pattern))
        assert cell["collective_calls"]["pmax"] == n_global
    if cfg.decode_seq_shard:
        assert cell["collective_calls"]["pmax"] == cfg.n_layers


def _moe_own(arch) -> dict:
    """An MoE arch's own mesh body (the smoke configs run the dense
    path, which gathers the experts whole)."""
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    return {"moe_impl": cfg.moe_impl} if cfg.moe else {}


SMOKE_ARCHS = [a for a in ARCHS if a != "dlrm"]


@pytest.mark.parametrize("arch", SMOKE_ARCHS)
def test_smoke_prefill_cell_traces_under_seqcache(arch):
    """Every smoke arch's prefill cell under the reference's ``seqcache``
    knob (``decode_seq_shard``) on (2, 2) traces, gathering no leaf,
    with the same ``collective_bytes`` as the cell without it (the
    reference's prefill is its ordinary one, its cache resharded at the
    jit boundary); the hand-off into the ranks' blocks of the sequence
    is recorded apart (``collective_bytes_handoff``): one all-to-all a
    global layer where the kv heads split over ``model``, an all-gather
    a ring, nothing where every rank holds every kv head (PaliGemma's
    one) or the latent (MLA) or where there is no global layer
    (RWKV-6)."""
    from repro_torch.models.transformer import build_groups
    base = dataclasses.replace(smoke_config(arch), **_moe_own(arch))
    cells = {}
    for seqcache in (False, True):
        cfg = dataclasses.replace(base, decode_seq_shard=seqcache)
        cells[seqcache] = dryrun.dryrun_cell(
            arch, "smoke_prefill", False, False, cfg=cfg,
            shape=SHAPES["smoke_prefill"], mesh_shape=(2, 2))
    cell = cells[True]
    assert cell["gathered_leaves"] == []
    assert cell["collective_bytes"] == cells[False]["collective_bytes"]
    assert cell["collective_bytes_raw"] == cells[False][
        "collective_bytes_raw"]
    assert cells[False]["collective_bytes_handoff"] == {"total": 0}
    kinds = [k for g in build_groups(base) for k in g.kinds for _ in
             range(g.n)]
    split_kv = base.n_kv_heads % 2 == 0
    want = {"all-to-all": split_kv * sum(k[0] in ("gqa_g", "shared_gqa")
                                         for k in kinds),
            "all-gather": split_kv * sum(k[0] == "gqa_l" for k in kinds)}
    got = cell["collective_bytes_handoff"]
    assert {k for k in got if k != "total"} == {k for k, n in want.items()
                                                if n}, got


@pytest.mark.parametrize("arch", ["deepseek-v2-236b", "deepseek-v3-671b"])
def test_mla_decode_cell_traces_under_seqcache(arch):
    """DeepSeek-V2's and V3's smoke decode cells under ``seqcache`` on
    (2, 2): the latent cache's sequence over ``model``, every latent
    column a rank; one ``pmax`` an MLA layer (the merge), no leaf
    gathered."""
    cfg = dataclasses.replace(smoke_config(arch), decode_seq_shard=True,
                              **_moe_own(arch))
    cell = dryrun.dryrun_cell(arch, "smoke_decode", False, False, cfg=cfg,
                              shape=SHAPES["smoke_decode"],
                              mesh_shape=(2, 2))
    assert cell["gathered_leaves"] == []
    assert cell["collective_calls"]["pmax"] == cfg.n_layers
    assert cell["collective_bytes_handoff"] == {"total": 0}


@pytest.mark.parametrize("arch", ["gemma2-9b", "gemma3-27b", "zamba2-1.2b",
                                  "rwkv6-3b"])
def test_smoke_long_500k_cell_traces(arch):
    """``long_500k``'s layout at the smoke widths on (data=4, model=2):
    batch 1, the global layers' sequence over ``data`` (RWKV-6 has no
    global layer: its states are the whole cache)."""
    cell = dryrun.dryrun_cell(arch, "long", False, False,
                              cfg=smoke_config(arch), shape=LONG,
                              mesh_shape=_mesh_ranks.DRYRUN_MESH)
    assert cell["gathered_leaves"] == []
    calls = cell["collective_calls"]
    assert (calls.get("pmax", 0) > 0) == (arch != "rwkv6-3b")
    assert cell["memory"]["argument_bytes"] > 0


@pytest.mark.parametrize("multi_pod", [False, True], ids=["sp", "mp"])
def test_no_leaf_is_gathered_whole_on_the_production_mesh(multi_pod):
    from repro_torch.configs import ARCHS, get_config
    from repro_torch.models import Model
    shape = (2, 16, 16) if multi_pod else (16, 16)
    mesh = comm.RecordingMesh(shape, ("pod", "data", "model")[-len(shape):])
    for arch in ARCHS:
        if arch == "dlrm":
            continue
        model = Model(get_config(arch), device="meta", mesh=mesh)
        assert model.gathered_leaves() == [], arch
