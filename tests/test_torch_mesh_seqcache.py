"""A decode cache split along the sequence in the port against the
reference's GSPMD: the smoke Gemma-2 (softcap; ring and global layers) and
Zamba2 (the shared block's cache) on (data=4, model=2), under
``cache_shard="seq"`` (batch 1, the sequence over ``data``: blocks of 64)
and ``decode_seq_shard`` (batch 4, the sequence over ``model``: blocks of
128), from one seeded cache of 256 positions, 8 steps from position 124.
Both layouts cross a block boundary at 128, and the last blocks hold no
position yet (a rank at local length 0).  The reference jit-s
``decode_step`` on 8 forced host devices in a subprocess
(``tests/_mesh_reference.py seq_cache``); the port runs on 8 CPU ranks over
``gloo`` (``tests/_mesh_ranks.py seq_cache_rank``), each rank attending over
its block and the ranks merging their (output, log-sum-exp) pairs.

Tolerance: the logits within a relative L2 of 1e-2 of the reference's mesh
run and of its one-device run over the whole cache.  The reference
normalises p by the global sum and rounds it to bf16 before the p.V
product, whose partial sums over the split GSPMD adds in bf16: its own
mesh run is 0.12-0.79% from its one-device run on these caches.  The port
keeps each rank's p and output in float32 and merges them exactly: 0.14-
0.59% from the one-device run (measured when this test was written).  A
lost or doubled block moves the logits by tens of percents."""
import dataclasses
import json

import numpy as np
import pytest

import _mesh_ranks
from _mesh_ranks import SEQ_CACHE, SEQ_CACHE_ARCHS, SEQ_LAYOUTS
from repro_torch.launch import mesh as lmesh
from test_torch_mesh_tp import _bytes_by_kind, run_reference

JOIN_S = 240
CPU8 = ["cpu"] * 8
CASES = [(a, lay) for a in SEQ_CACHE_ARCHS for lay in SEQ_LAYOUTS]
IDS = [f"{a}-{lay}" for a, lay in CASES]
TOL = 1e-2


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("seq_ref")
    run_reference(out, "seq_cache")
    return out / "seq_cache.npz"


@pytest.fixture(scope="module")
def port(ref):
    return lmesh.launch(_mesh_ranks.seq_cache_rank, 8, devices=CPU8,
                        args=(str(ref),), join_s=JOIN_S)


def _rel(got, want) -> float:
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


@pytest.mark.parametrize("arch,lay", CASES, ids=IDS)
def test_seq_split_decode_matches_reference(ref, port, arch, lay):
    d = np.load(ref)
    name = f"{arch}.{lay}"
    for r in port:
        lo, hi = r[name]["rows"]
        got = r[name]["logits"]
        assert np.isfinite(got).all()
        for key in ("logits", "single"):
            rel = _rel(got, d[f"{name}.{key}"][:, lo:hi])
            assert rel <= TOL, (name, key, lo, rel)


@pytest.mark.parametrize("lay", list(SEQ_LAYOUTS))
def test_the_steps_cross_a_block_boundary_with_an_empty_rank(port, lay):
    axes = port[0][f"{SEQ_CACHE_ARCHS[0]}.{lay}"]["seq"]
    sizes = dict(zip(("data", "model"), SEQ_CACHE["mesh"]))
    block = SEQ_CACHE["S"] // int(np.prod([sizes[a] for a in axes]))
    first, last = SEQ_CACHE["pos0"], SEQ_CACHE["pos0"] + SEQ_CACHE["steps"] - 1
    assert first // block != last // block
    assert SEQ_CACHE["S"] - block > first     # the last block starts empty


def _recorded(arch, lay, rank):
    """The dry run's recording of rank ``rank``'s decode step on meta."""
    import torch

    from repro_torch.common import comm
    from repro_torch.configs import smoke_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun
    from repro_torch.models import Model
    B, kind, seq_model = SEQ_LAYOUTS[lay]
    cfg = dataclasses.replace(smoke_config(arch), decode_seq_shard=seq_model)
    mesh = comm.RecordingMesh(SEQ_CACHE["mesh"], ("data", "model"), rank)
    model = Model(cfg, device="meta", mesh=mesh)
    model.compute_dtype = torch.float32
    shape = ShapeConfig("seq_cache", seq_len=SEQ_CACHE["S"], global_batch=B,
                        kind="decode", cache_shard=kind)
    comm.reset_counters()
    dryrun.trace_step(model, shape, mesh)["run"]()
    return comm.counters()


@pytest.mark.parametrize("arch,lay", CASES, ids=IDS)
def test_collectives_equal_the_dry_runs_recording(ref, port, arch, lay):
    d = np.load(ref)
    name = f"{arch}.{lay}"
    want = json.loads(str(d[f"{name}.comm"]))["totals"]["coll"]
    for rank in (0, 7):
        got = port[rank][name]["counters"]
        print(f"{name} rank {rank}: bytes {_bytes_by_kind(got)} "
              f"(reference {want})")
        rec = _recorded(arch, lay, rank)
        assert {k: (v["calls"], v["bytes"]) for k, v in got.items()} == \
            {k: (v["calls"], v["bytes"]) for k, v in rec.items()}
        # one pmax a global layer's merge (the shared block's applications)
        assert got["pmax"]["calls"] >= 1


@pytest.fixture(scope="module")
def probed():
    return lmesh.launch(_mesh_ranks.split_probe_rank, 4, devices=["cpu"] * 4,
                        join_s=JOIN_S)


@pytest.mark.parametrize("fault", _mesh_ranks.SPLIT_PROBE_FAULTS)
def test_split_probe_holds_the_merge_and_sees_the_second_block(probed,
                                                               fault):
    """``chip_smoke.SplitProbe`` (``mesh_long``'s tight check on the card)
    on 4 CPU ranks: on a sound step every rank's pair, merge and write
    hold within its limits (the owner of the position is the second data
    rank, at local length 4); with the second block's pair dropped from
    the merge every rank's merge check fails (by orders of magnitude: on
    the card that block is ~1e-5 of the softmax's weight, and the
    logits' limit cannot see it)."""
    for rank, r in enumerate(probed):
        p = r[fault]
        assert p["blocks"] == 2 and p["written"] and p["untouched"]
        assert p["owner"] == (rank >= 2)
        assert p["local_length"] == (4 if rank >= 2 else 128)
        assert max(p["pair_ratio"], p["lse_ratio"]) <= 1.0
        if fault == "sound":
            assert p["ok"] and p["merge_ratio"] <= 1.0, p
            assert p["unsplit_ratio"] <= 1.0, p
        else:
            assert not p["ok"] and p["merge_ratio"] > 100.0, p
