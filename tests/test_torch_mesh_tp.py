"""The model axis in the port against the reference's GSPMD: the smoke
TinyLlama's ZeRO-1 step on (data=2, model=2), with and without
``seq_parallel``, whole batch and microbatches of 2, 3 steps.  The
reference jit-s the step on 4 forced host devices in a subprocess
(``tests/_mesh_reference.py lm_tp_comm``: losses, norms, the final tree,
``hlo_comm.summarize`` and ``hlo_counter.totals`` of the compiled step);
the port runs on 4 CPU ranks over ``gloo`` (``tests/_mesh_ranks.py``),
its dense layers tensor-parallel over ``model``.

* losses and norms rtol 1e-4, parameters within 2 lr a step
  (``test_tinyllama_zero1_step_matches_reference``'s tolerances);
* each rank's dot FLOPs (``FlopCounterMode``) within 10% of the
  reference's per-device ``hlo_counter`` FLOPs (gathering every weight,
  as the port did before its layers split over ``model``, gives about
  2x); the bytes by collective kind printed beside the reference's;
* no all-gather over ``model`` of a weight: the dry run's recording of
  the same step (``repro_torch.launch.dryrun``) shows the model axis's
  all-gathers are activations, and only under ``seq_parallel``, which
  shows reduce-scatters over ``model`` and computes the same function."""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import _mesh_ranks
from repro_torch.launch import mesh as lmesh

ROOT = Path(__file__).resolve().parents[1]
JOIN_S = 240
CPU4 = ["cpu"] * 4      # CPU ranks, asked for by name
LR = _mesh_ranks.TCFG["learning_rate"]
CASES = [(sp, mb) for sp in (False, True) for mb in (None, 2)]
IDS = [f"{'seq_parallel' if sp else 'plain'}-mb{mb}" for sp, mb in CASES]
TP_NAMES = ("wq", "wk", "wv", "wo", "w1", "w3", "w2", "embed", "lm_head")


def run_reference(out: Path, *names):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, str(ROOT / "tests" /
                                            "_mesh_reference.py"), str(out),
                        *names], capture_output=True, text=True, env=env,
                       timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("mesh_ref")
    run_reference(out, "lm_tp_comm")
    return out / "lm_tp_comm.npz"


def tp_cases_rank(rank, npz):
    return {case: _mesh_ranks.lm_rank(rank, npz, case[1], case[0])
            for case in CASES}


@pytest.fixture(scope="module")
def port(ref):
    return lmesh.launch(tp_cases_rank, 4, devices=CPU4, args=(str(ref),),
                        join_s=JOIN_S)


def _name(sp, mb) -> str:
    return f"sp{int(sp)}.mb{mb}"


@pytest.mark.parametrize("sp,mb", CASES, ids=IDS)
def test_tp_step_matches_reference(ref, port, sp, mb):
    d = np.load(ref)
    name = _name(sp, mb)
    for r in port:
        got = r[(sp, mb)]
        np.testing.assert_allclose(got["losses"], d[f"{name}.losses"],
                                   rtol=1e-4)
        np.testing.assert_allclose(got["norms"], d[f"{name}.norms"],
                                   rtol=1e-4)
    for leaf, got in port[0][(sp, mb)]["params"].items():
        np.testing.assert_allclose(got, d[f"{name}.p.{leaf}"], rtol=0,
                                   atol=2 * LR * 3, err_msg=leaf)


def _bytes_by_kind(counters) -> dict:
    from repro_torch.common.comm import HLO_KINDS
    out: dict = {}
    for kind, c in counters.items():
        if c["calls"]:
            hlo = HLO_KINDS[kind]
            out[hlo] = out.get(hlo, 0) + c["bytes"]
    return out


@pytest.mark.parametrize("sp,mb", CASES, ids=IDS)
def test_tp_flops_per_rank_match_reference(ref, port, sp, mb):
    d = np.load(ref)
    want = json.loads(str(d[f"{_name(sp, mb)}.comm"]))
    ref_flops = want["totals"]["flops"]
    for rank, r in enumerate(port):
        got = r[(sp, mb)]
        print(f"rank {rank} flops {got['flops']} (reference {ref_flops}); "
              f"bytes {_bytes_by_kind(got['counters'][0])} (reference "
              f"{want['totals']['coll']})")
        assert abs(got["flops"] / ref_flops - 1) <= 0.10, (
            rank, got["flops"], ref_flops)


def _recorded(rank: int, seq_parallel: bool, microbatch):
    """The dry run's recording of rank ``rank``'s step on meta."""
    import torch

    from repro_torch.common import comm
    from repro_torch.configs import smoke_config
    from repro_torch.configs.base import ShapeConfig, TrainConfig
    from repro_torch.launch import dryrun
    from repro_torch.models import Model
    cfg = dataclasses.replace(smoke_config("tinyllama-1.1b"),
                              seq_parallel=seq_parallel)
    mesh = comm.RecordingMesh((2, 2), ("data", "model"), rank)
    model = Model(cfg, device="meta", mesh=mesh)
    shape = ShapeConfig("t", seq_len=_mesh_ranks.LM_SEQ,
                        global_batch=_mesh_ranks.LM_BATCH, kind="train")
    cell = dryrun.trace_step(model, shape, mesh, gradspec=True,
                             tcfg=TrainConfig(microbatch=microbatch,
                                              **_mesh_ranks.TCFG))
    comm.reset_counters()
    cell["run"]()
    assert torch.device("meta") == model.device
    return model, mesh.records, comm.counters()


@pytest.mark.parametrize("sp", [False, True], ids=["plain", "seq_parallel"])
def test_no_all_gather_of_a_dense_weight_over_model(sp):
    for rank in range(4):
        model, records, _ = _recorded(rank, sp, None)
        assert not [p for p in model.gathered_leaves()
                    if p.split(".")[-1] in TP_NAMES]
        over_model = [r for r in records if "model" in r.axes
                      and r.kind == "all_gather"]
        if not sp:
            assert not over_model, over_model
            continue
        cfg = model.cfg
        # (rows a rank, the sequence's slice, d_model) in bf16
        act = (_mesh_ranks.LM_BATCH // 2) * (_mesh_ranks.LM_SEQ // 2) * \
            cfg.d_model * 2
        assert over_model and all(r.bytes == act for r in over_model), \
            over_model
        assert any(r.kind == "psum_scatter" and r.axes == ("model",)
                   for r in records)


def test_seq_parallel_computes_the_same_function(port):
    for r in port:
        for mb in (None, 2):
            np.testing.assert_allclose(r[(True, mb)]["losses"],
                                       r[(False, mb)]["losses"], rtol=1e-5)
            np.testing.assert_allclose(r[(True, mb)]["norms"],
                                       r[(False, mb)]["norms"], rtol=1e-5)
