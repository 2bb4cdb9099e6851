"""The model axis of the other families in the port against the reference's
GSPMD: the smoke Zamba2 (Mamba-2 and the shared block), RWKV-6 (and a
one-head variant whose 32 columns a rank cut through the head, as
RWKV-6-3B's 40 heads do on 16 ranks) and Whisper (the encoder's attention
and MLP) on (data=2, model=2): a ZeRO-1 step, 3 steps, with and without
``seq_parallel``.  The reference jit-s the step on 4 forced host devices
in a subprocess (``tests/_mesh_reference.py families_tp:...``); the port
runs on 4 CPU ranks over ``gloo`` (``tests/_mesh_ranks.py family_rank``),
every leaf the reference's GSPMD keeps sharded over ``model`` read as this
rank's block.  (DeepSeek-V2's MLA, MoE and latent cache:
``test_torch_mesh_families_moe.py``.)

``test_torch_mesh_tp.py``'s tolerances: losses rtol 1e-4, norms rtol
1e-4, parameters within 2 lr a step; each rank's dot FLOPs within 10% of
the reference's per-device ``hlo_counter`` FLOPs, bytes by collective
kind printed beside the reference's.  One departure, for Zamba2's norms
after the first update: the first update's sign-like AdamW step
amplifies float32 rounding through the Mamba-2 stack, and the
reference's own one-device run is 1.24e-4 from its mesh run at step 3
(the port's one-process run 1.52e-4, its mesh run 2.15e-4, measured when
this test was written); those norms are held at rtol 3e-4, step 1's at
1e-4.  No leaf of these families is gathered whole (``gathered_leaves``
empty); serving on the mesh (prefill and 6 decode steps, the caches'
blocks: Mamba-2's conv channels, RWKV-6's heads) equals one process:
the prefill's logits within 1e-5, the decode steps' within 1e-5 where no
layer reads a bf16 KV cache (RWKV-6) and within 1e-2 where one does
(Zamba2's shared block, Whisper's decoder): there the attention's output
is bf16, the cache's dtype, as the reference's, and the two ranks' bf16
partial products with ``wo`` are each rounded before their ``psum``
where one process rounds the whole product once (0.05-0.18% on these
steps; the reference's mesh decode rounds the same way)."""
import json

import numpy as np
import pytest

import _mesh_ranks
from repro_torch.launch import mesh as lmesh
from test_torch_mesh_tp import _bytes_by_kind, run_reference

JOIN_S = 300
CPU4 = ["cpu"] * 4
LR = _mesh_ranks.TCFG["learning_rate"]
FAMS = ("zamba2", "rwkv6", "rwkv6_h1", "whisper")
CASES = [(f, sp) for f in FAMS for sp in (False, True)]
IDS = [f"{f}-{'seq_parallel' if sp else 'plain'}" for f, sp in CASES]
# the norms after step 1 that AdamW's amplified rounding moves (above)
LATER_NORM_RTOL = {"zamba2": 3e-4}


def _ref_npz(out, fams) -> str:
    run_reference(out, "families_tp:" + ",".join(fams))
    return str(out / ("families_tp_" + "_".join(fams) + ".npz"))


def families_rank(rank, npz, fams, serve=True):
    out = {"steps": {(f, sp): _mesh_ranks.family_rank(rank, npz, f, sp)
                     for f in fams for sp in (False, True)}}
    if serve:
        out["serve"] = {f: _mesh_ranks.family_serve_rank(rank, npz, f)
                        for f in fams}
    return out


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return _ref_npz(tmp_path_factory.mktemp("families_ref"), FAMS)


@pytest.fixture(scope="module")
def port(ref):
    return lmesh.launch(families_rank, 4, devices=CPU4, args=(ref, FAMS),
                        join_s=JOIN_S)


def check_step(d, port, fam, sp):
    name = f"{fam}.sp{int(sp)}"
    later = LATER_NORM_RTOL.get(fam, 1e-4)
    for r in port:
        got = r["steps"][(fam, sp)]
        np.testing.assert_allclose(got["losses"], d[f"{name}.losses"],
                                   rtol=1e-4)
        np.testing.assert_allclose(got["norms"][:1], d[f"{name}.norms"][:1],
                                   rtol=1e-4)
        np.testing.assert_allclose(got["norms"][1:], d[f"{name}.norms"][1:],
                                   rtol=later)
    for leaf, got in port[0]["steps"][(fam, sp)]["params"].items():
        np.testing.assert_allclose(got, d[f"{name}.p.{leaf}"], rtol=0,
                                   atol=2 * LR * 3, err_msg=leaf)


def check_flops(d, port, fam, sp):
    want = json.loads(str(d[f"{fam}.sp{int(sp)}.comm"]))
    ref_flops = want["totals"]["flops"]
    for rank, r in enumerate(port):
        got = r["steps"][(fam, sp)]
        print(f"{fam} sp={sp} rank {rank} flops {got['flops']} (reference "
              f"{ref_flops}); bytes {_bytes_by_kind(got['counters'][0])} "
              f"(reference {want['totals']['coll']})")
        assert abs(got["flops"] / ref_flops - 1) <= 0.10, (
            rank, got["flops"], ref_flops)
        assert got["gathered_leaves"] == []


@pytest.mark.parametrize("fam,sp", CASES, ids=IDS)
def test_family_step_matches_reference(ref, port, fam, sp):
    check_step(np.load(ref), port, fam, sp)


@pytest.mark.parametrize("fam,sp", CASES, ids=IDS)
def test_family_flops_per_rank_match_reference(ref, port, fam, sp):
    check_flops(np.load(ref), port, fam, sp)


@pytest.mark.parametrize("fam", FAMS)
def test_family_serving_on_the_mesh_equals_one_process(port, fam):
    bf16_cache = fam in ("zamba2", "whisper")
    for r in port:
        rel = r["serve"][fam]["rel"]
        assert rel[0] <= 1e-5, (fam, rel)
        assert max(rel[1:]) <= (1e-2 if bf16_cache else 1e-5), (fam, rel)
    s = port[0]["serve"][fam]
    if fam.startswith("zamba2"):      # the conv state: this rank's channels
        assert any(m[-1] * 2 == o[-1] for m, o in zip(s["mesh_cache"],
                                                      s["one_cache"]))
    if fam == "rwkv6":                # the WKV state: this rank's heads
        assert any(len(m) == 5 and m[2] * 2 == o[2]
                   for m, o in zip(s["mesh_cache"], s["one_cache"]))
