"""The model axis of DeepSeek-V2 in the port against the reference's GSPMD
(``test_torch_mesh_families.py``'s checks and tolerances): the smoke
config's ZeRO-1 step on (data=2, model=2) under both MoE mesh bodies
(``ep_a2a``, ``tp``), with and without ``seq_parallel``, MLA on this
rank's heads and latent columns and the shared experts tensor-parallel;
and its decode (``tests/_mesh_reference.py mla_decode``): a prefill of 4
rows of 24 tokens into a cache whose latent ``c`` splits over ``model``,
then 8 decode steps, float32 activations.  The decode's logits within a
relative L2 of 1e-4 of the reference's mesh run (the capacity drops of
the ``tp`` body make its one-device run, the dense path, another
function)."""
import numpy as np
import pytest

import _mesh_ranks
from repro_torch.launch import mesh as lmesh
from test_torch_mesh_families import (CPU4, JOIN_S, _ref_npz, check_flops,
                                      check_step, families_rank)
from test_torch_mesh_tp import run_reference

FAMS = ("deepseek_ep", "deepseek_tp")
CASES = [(f, sp) for f in FAMS for sp in (False, True)]
IDS = [f"{f}-{'seq_parallel' if sp else 'plain'}" for f, sp in CASES]


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("families_moe_ref")
    npz = _ref_npz(out, FAMS)
    run_reference(out, "mla_decode")
    return npz, str(out / "mla_decode.npz")


def moe_rank(rank, npz, mla_npz):
    out = families_rank(rank, npz, FAMS, serve=False)
    # serving against one process on the dense MoE path: the mesh bodies
    # drop slots at their capacity, one process computes every expert
    out["serve"] = _mesh_ranks.family_serve_rank(
        rank, npz, "deepseek_tp", over={"moe_impl": "dense"})
    out["mla"] = _mesh_ranks.mla_decode_rank(rank, mla_npz)
    return out


@pytest.fixture(scope="module")
def port(ref):
    return lmesh.launch(moe_rank, 4, devices=CPU4, args=ref, join_s=JOIN_S)


@pytest.mark.parametrize("fam,sp", CASES, ids=IDS)
def test_deepseek_step_matches_reference(ref, port, fam, sp):
    check_step(np.load(ref[0]), port, fam, sp)


@pytest.mark.parametrize("fam,sp", CASES, ids=IDS)
def test_deepseek_flops_per_rank_match_reference(ref, port, fam, sp):
    check_flops(np.load(ref[0]), port, fam, sp)


def test_deepseek_serving_on_the_mesh_equals_one_process(port):
    """MLA over the split latent cache and the shared experts, with the
    dense MoE path (every expert for every token, on gathered experts):
    the latent cache is bf16, but MLA reads it into float32 products, so
    no bf16 partial sum: 1e-5."""
    for r in port:
        rel = r["serve"]["rel"]
        assert max(rel) <= 1e-5, rel


def test_mla_decode_with_the_latent_split_matches_reference(ref, port):
    d = np.load(ref[1])
    r_kv = 24                                  # the smoke kv_lora_rank
    for r in port:
        m = r["mla"]
        lo, hi = m["rows"]
        assert m["c_shape"][-1] * 2 == r_kv    # this rank's latent columns
        assert m["gathered"] == []
        want = d["mesh.prefill"][lo:hi]
        assert np.linalg.norm(m["prefill"] - want) <= 1e-4 * np.linalg.norm(
            want)
        for i, got in enumerate(m["logits"]):
            want = d["mesh.logits"][i, lo:hi]
            rel = np.linalg.norm(got - want) / np.linalg.norm(want)
            assert rel <= 1e-4, (lo, i, rel)
