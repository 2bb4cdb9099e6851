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
lost or doubled block moves the logits by tens of percents.

The same run (``tests/_mesh_reference.py seq_cache seq_serve``, one
subprocess; ``_mesh_ranks.seq_serve_rank``) also holds:

* the smoke DeepSeek-V2 under ``decode_seq_shard``: its latent cache
  split along the sequence over ``model`` (every latent column a rank),
  ``seq_cache``'s 8 steps across the boundary at 128 with model rank 1
  empty at first, against the reference's mesh run and its one device
  at ``TOL`` (1.1e-6-1.2e-5 when written);
* a prefill into the split cache, then decode (``SEQ_PREFILL``: prompts
  of 60 tokens ending inside the first block of 64, 8 steps across it,
  the later blocks empty) for the smoke Gemma-2 (its rings wrap),
  Zamba2 and DeepSeek-V2 in both layouts: the port's split run within
  ``SPLIT_TOL`` (1e-5, float32) of its own run over an unsplit cache on
  the same mesh (a run in one process writes a bf16 cache from other
  float32 roundings: a flipped last bit there moves the steps by
  5e-5-7e-3; over the unsplit cache on the mesh the GQA families' split
  runs were bit-equal, DeepSeek-V2's 6e-7-9e-7 off when written), and
  within ``TOL`` of the reference's ordinary prefill and decode on one
  device (0.32-0.38% Gemma-2, 0.17-0.21% Zamba2, 3.6e-6-6.9e-5
  DeepSeek-V2 when written); each rank's
  block holding exactly the prompt's positions inside it; the hand-off's
  collectives (one all-to-all a global layer over ``model``, an
  all-gather a ring; none over ``data``) equal to the dry run's
  recording of the same prefill, outside its ``collective_bytes``."""
import dataclasses
import json

import numpy as np
import pytest

import _mesh_ranks
from _mesh_ranks import (SEQ_CACHE, SEQ_CACHE_ARCHS, SEQ_LAYOUTS,
                         SEQ_PREFILL, SEQ_PREFILL_ARCHS)
from repro_torch.launch import mesh as lmesh
from test_torch_mesh_tp import _bytes_by_kind, run_reference

JOIN_S = 240
CPU8 = ["cpu"] * 8
CASES = [(a, lay) for a in SEQ_CACHE_ARCHS for lay in SEQ_LAYOUTS]
IDS = [f"{a}-{lay}" for a, lay in CASES]
PREFILL_CASES = [(a, lay) for a in SEQ_PREFILL_ARCHS for lay in SEQ_LAYOUTS]
PREFILL_IDS = [f"{a}-{lay}" for a, lay in PREFILL_CASES]
TOL = 1e-2
SPLIT_TOL = 1e-5


@pytest.fixture(scope="module")
def ref_dir(tmp_path_factory):
    out = tmp_path_factory.mktemp("seq_ref")
    run_reference(out, "seq_cache", "seq_serve")
    return out


@pytest.fixture(scope="module")
def ref(ref_dir):
    return ref_dir / "seq_cache.npz"


@pytest.fixture(scope="module")
def served(ref_dir):
    return lmesh.launch(_mesh_ranks.seq_serve_rank, 8, devices=CPU8,
                        args=(str(ref_dir / "seq_cache.npz"),
                              str(ref_dir / "seq_serve.npz")),
                        join_s=JOIN_S)


@pytest.fixture(scope="module")
def port(served):
    return [r["cache"] for r in served]


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


def test_deepseek_split_latent_decode_matches_reference(ref_dir, served):
    d = np.load(ref_dir / "seq_serve.npz")
    name = "deepseek-v2-236b.seqshard"
    for r in served:
        m = r["deepseek"]
        lo, hi = m["rows"]
        assert m["seq"] == ("model",) and np.isfinite(m["logits"]).all()
        for key in ("logits", "single"):
            rel = _rel(m["logits"], d[f"{name}.{key}"][:, lo:hi])
            assert rel <= TOL, (key, lo, rel)
        # the merge of each MLA layer: a pmax and a psum over model
        assert m["counters"]["pmax"]["calls"] == 3


@pytest.mark.parametrize("arch,lay", PREFILL_CASES, ids=PREFILL_IDS)
def test_prefill_into_a_split_cache_then_decode(ref_dir, served, arch,
                                                lay):
    """Every rank's logits (the prefill's last, then each step's) within
    ``SPLIT_TOL`` of the same rows' run over an unsplit cache on the same
    mesh (the same tensor-parallel prefill, so the same bf16 cache; its
    global layers' p kept in float32 as the split path keeps it), and
    within ``TOL`` of the reference's ordinary prefill and decode; each
    rank's block holds the prompt's positions inside it and nothing past
    them."""
    want = np.load(ref_dir / "seq_serve.npz")[f"{arch}.ref"]
    S_r = 64
    for r in served:
        m = r["prefill"][f"{arch}.{lay}"]
        u = r["unsplit"][f"{arch}.{lay}"]
        lo, hi = m["rows"]
        assert u["rows"] == m["rows"] and u["seq"] == ()
        assert np.isfinite(m["logits"]).all()
        split = _rel(m["logits"], u["logits"])
        rel = _rel(m["logits"], want[:, lo:hi])
        print(f"{arch} {lay} rows {lo}:{hi} block {m['index']}: unsplit "
              f"{split:.2e}, reference {rel:.2e}")
        assert split <= SPLIT_TOL, (lo, m["index"], split)
        assert rel <= TOL, (lo, m["index"], rel)
        live = min(max(SEQ_PREFILL["P"] - m["index"] * S_r, 0), S_r)
        assert m["held"] and set(m["held"]) == {live}, (m["index"],
                                                        m["held"])


@pytest.mark.parametrize("lay", list(SEQ_LAYOUTS))
def test_the_prefill_cases_cross_a_block_boundary_with_empty_blocks(served,
                                                                    lay):
    m = served[0]["prefill"][f"{SEQ_PREFILL_ARCHS[0]}.{lay}"]
    sizes = dict(zip(("data", "model"), SEQ_CACHE["mesh"]))
    n = int(np.prod([sizes[a] for a in m["seq"]]))
    S_r = SEQ_PREFILL["max_len"][lay] // n
    P_len = SEQ_PREFILL["P"]
    assert S_r == 64 and P_len < S_r < P_len + SEQ_PREFILL["steps"]
    # blocks that stay empty after the prefill (the last at least)
    assert n >= 2 and {r["prefill"][f"{SEQ_PREFILL_ARCHS[0]}.{lay}"][
        "held"][0] for r in served} == {P_len, 0}


def _recorded_prefill(arch, lay, rank):
    """The dry run's recording of rank ``rank``'s ``SEQ_PREFILL`` prefill
    on meta: (records of the step, records of the hand-off)."""
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
    shape = ShapeConfig("seq_prefill", seq_len=SEQ_PREFILL["P"],
                        global_batch=B, kind="prefill", cache_shard=kind)
    dryrun.trace_step(model, shape, mesh,
                      max_len=SEQ_PREFILL["max_len"][lay])["run"]()

    def by_kind(records):
        out = {}
        for r in records:
            c = out.setdefault(r.kind, [0, 0])
            c[0] += 1
            c[1] += r.bytes
        return {k: tuple(v) for k, v in out.items()}
    return (by_kind(dryrun.step_records(mesh.records)),
            by_kind(dryrun.step_records(mesh.records, "handoff")))


@pytest.mark.parametrize("arch,lay", PREFILL_CASES, ids=PREFILL_IDS)
def test_prefill_handoff_equals_the_dry_runs_recording(served, arch, lay):
    """The live prefill's collectives on ranks 0 and 7, its hand-off
    apart, equal the dry run's recording of the same prefill: over
    ``model`` one all-to-all a global layer whose kv heads split there
    (Gemma-2's 2 kv heads, Zamba2's 4) and one all-gather a ring; over
    ``data`` and for MLA's latent (whole on every rank) none."""
    from repro_torch.models.transformer import build_groups
    from repro_torch.configs import smoke_config
    cfg = smoke_config(arch)
    n_global = sum(g.n * sum(k[0] in ("gqa_g", "shared_gqa")
                             for k in g.kinds) for g in build_groups(cfg))
    n_ring = sum(g.n * sum(k[0] == "gqa_l" for k in g.kinds)
                 for g in build_groups(cfg))
    for rank in (0, 7):
        c = served[rank]["prefill"][f"{arch}.{lay}"]["counters"]

        def live(cs):
            return {k: (v["calls"], v["bytes"]) for k, v in cs.items()
                    if v["calls"]}
        hand = live(c["handoff"])
        rest = {k: (v[0] - hand.get(k, (0, 0))[0],
                    v[1] - hand.get(k, (0, 0))[1])
                for k, v in live(c["all"]).items()}
        rest = {k: v for k, v in rest.items() if v[0]}
        step, handoff = _recorded_prefill(arch, lay, rank)
        assert (rest, hand) == (step, handoff), rank
        want = ({"all_to_all": n_global, "all_gather": n_ring}
                if lay == "seqshard" else {})
        assert {k: v[0] for k, v in hand.items()} == {
            k: v for k, v in want.items() if v}, hand
