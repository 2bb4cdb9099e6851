"""The mesh train step in the port against the reference's step ``jit``-ed
with the meshes' ``in_shardings`` on 4 forced host devices (a subprocess,
``tests/_mesh_reference.py``), the port on 4 CPU ranks over ``gloo``
(``tests/_mesh_ranks.py``):

* the smoke DLRM, 3 AdamW steps, ZeRO-1: on (data=4) with the tables over
  ``data`` (the bags to the rows' owners by ``all_to_all``; the gradients
  reduce-scattered to ZeRO-1's layout) and on (data=2, model=2) with the
  default rules (the bags all-gathered over ``model``; ``psum``);
  losses, gradient norms and final trees at ``tests/test_torch_dlrm_train
  .py``'s tolerances (rtol 2e-2 + atol 2e-3 of a leaf's scale; norms rtol
  5e-2): bf16 activations;
* the smoke TinyLlama's ZeRO-1 step on (data=2, model=2), float32
  activations, whole batch and microbatches of 2: losses and norms rtol
  1e-4, parameters within 2 lr a step (``tests/test_torch_train.py``);
* the same TinyLlama step with a seeded ``loss_mask`` (rows kept in
  unequal shares, ``_mesh_ranks.lm_loss_mask``): each rank's share is
  its rows' masked sum over the whole (micro)batch's count, so the
  shares add to the reference's global masked mean; the same
  tolerances;
* the smoke DLRM step's collectives beside the reference's compiled
  step's (``scripts/hlo_collectives.py`` on its HLO): both move float32
  (no bf16 gradient, as ``DLRM.comm_profile``'s analytic profile
  assumes); the reference's GSPMD moves no all-to-all (it all-gathers
  the tables whole, widened to float32), the port the paper's
  all-to-all of the bags;
* the sharded global norm equal to the unsharded one, and ZeRO-1's
  moments one block a rank."""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import _mesh_ranks
from repro_torch.launch import mesh as lmesh

ROOT = Path(__file__).resolve().parents[1]
RTOL, ATOL = 2e-2, 2e-3
JOIN_S = 150
CPU4 = ["cpu"] * 4      # CPU ranks, asked for by name
LR = _mesh_ranks.TCFG["learning_rate"]


def run_reference(out: Path, *names):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, str(ROOT / "tests" /
                                            "_mesh_reference.py"), str(out),
                        *names], capture_output=True, text=True, env=env,
                       timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]


@pytest.fixture(scope="module")
def ref_dir(tmp_path_factory):
    out = tmp_path_factory.mktemp("mesh_ref")
    run_reference(out, "dlrm_train", "lm_train", "lm_masked")
    return out


def _close(a, b, what, atol_abs=0.0):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    scale = float(np.abs(a).max())
    err = float(np.abs(a - b).max())
    assert err <= ATOL * max(scale, 1.0) + RTOL * scale + atol_abs, (
        what, err, scale)


def dlrm_cases_rank(rank, npz):
    return {case: _mesh_ranks.dlrm_rank(rank, npz, case, case == "data4")
            for case in _mesh_ranks.DLRM_CASES}


@pytest.fixture(scope="module")
def dlrm_res(ref_dir):
    return lmesh.launch(dlrm_cases_rank, 4, devices=CPU4,
                        args=(str(ref_dir / "dlrm_train.npz"),),
                        join_s=JOIN_S)


def test_dlrm_mesh_steps_match_reference(ref_dir, dlrm_res):
    d = np.load(ref_dir / "dlrm_train.npz")
    res = dlrm_res
    for case in _mesh_ranks.DLRM_CASES:
        r0 = res[0][case]
        for r in res:        # every rank reads the same metrics
            assert r[case]["losses"] == r0["losses"], case
            assert r[case]["norms"] == r0["norms"], case
        np.testing.assert_allclose(r0["losses"], d[f"{case}.losses"],
                                   rtol=RTOL, atol=ATOL, err_msg=case)
        np.testing.assert_allclose(r0["norms"], d[f"{case}.norms"],
                                   rtol=5e-2, err_msg=case)
        for name, got in r0["params"].items():
            # Adam's first steps are sign-like: a gradient near 0 may take
            # the other +-lr (tests/test_torch_train.py)
            _close(d[f"{case}.p.{name}"], got, (case, name),
                   atol_abs=2 * LR * 3)
            for r in res[1:]:
                np.testing.assert_array_equal(r[case]["params"][name], got)
        c = r0["counters"][0]
        if case == "data4":
            # the bags to the rows' owners and back: one all-to-all each way
            assert c["all_to_all"]["calls"] == 2
            assert c["psum_scatter"]["calls"] > 0      # ZeRO-1's layout
        else:
            assert c["all_to_all"]["calls"] == 0
            assert c["all_gather"]["calls"] > 0       # the bags over model
        assert r0["specs"]["tables"].axes(0) == (
            ("data",) if case == "data4" else ("model",))


def test_dlrm_collectives_beside_the_references_compiled_step(ref_dir,
                                                              dlrm_res):
    """Open item 1 of the port's roadmap, settled by the reference's HLO:
    the compiled step moves only float32 (the port's gradients are
    float32 too: ``comm_profile``'s bf16 gradients and ``DLRMCommSpec``'s
    4 MiB all-to-all are the paper's analytic profile at the paper's
    batch, not what the reference compiles), and no all-to-all: on
    (data=4) with the tables over ``data`` GSPMD all-gathers the whole
    tables, widened to float32; the port exchanges the rows' bags with
    their tables' owners (one all-to-all each way, bf16) and
    reduce-scatters the MLP's float32 gradient."""
    import json

    from repro_torch.configs import smoke_config
    from repro_torch.models.dlrm import param_shapes
    d = np.load(ref_dir / "dlrm_train.npz")
    cfg = smoke_config("dlrm")
    shapes = param_shapes(cfg)
    for case in _mesh_ranks.DLRM_CASES:
        ops = json.loads(str(d[f"{case}.collectives"]))
        port = {k: (v["calls"], v["bytes"]) for k, v in
                dlrm_res[0][case]["counters"][0].items() if v["calls"]}
        ref = {}
        for kind, shape, nbytes, _ in ops:
            c = ref.setdefault((kind, shape.split("[")[0]), [0, 0])
            c[0] += 1
            c[1] += nbytes
        print(f"{case}: reference {ref}; port {port}")
        assert ops and all(not s.startswith("bf16") for _, s, _, _ in ops)
        assert all(k != "all-to-all" for k, _, _, _ in ops)
    ops = json.loads(str(d["data4.collectives"]))
    tables = "f32[{}]".format(",".join(map(str, shapes["tables"][0])))
    assert any(k == "all-gather" and s.startswith(tables)
               for k, s, _, _ in ops), tables
    port = dlrm_res[0]["data4"]["counters"][0]
    rows = _mesh_ranks.DLRM_BATCH // 4
    T, D = shapes["tables"][0][0], cfg.emb_dim
    assert port["all_to_all"]["calls"] == 2
    assert port["all_to_all"]["bytes"] == 2 * rows * T * D * 2   # bf16
    mlp = [np.prod(v[0]) for part in ("bot", "top")
           for v in shapes[part].values() if np.prod(v[0]) % 4 == 0]
    assert port["psum_scatter"]["bytes"] == 4 * sum(mlp)         # float32


def lm_cases_rank(rank, npz):
    return {mb: _mesh_ranks.lm_rank(rank, npz, mb) for mb in (None, 2)}


def lm_masked_rank(rank, npz):
    return {mb: _mesh_ranks.lm_rank(rank, npz, mb, masked=True)
            for mb in (None, 2)}


def test_tinyllama_masked_step_matches_reference(ref_dir):
    d = np.load(ref_dir / "lm_masked.npz")
    res = lmesh.launch(lm_masked_rank, 4, devices=CPU4,
                       args=(str(ref_dir / "lm_masked.npz"),),
                       join_s=JOIN_S)
    plain = np.load(ref_dir / "lm_train.npz")
    for mb in (None, 2):
        r0 = res[0][mb]
        for r in res:
            assert r[mb]["losses"] == r0["losses"], mb
        np.testing.assert_allclose(r0["losses"], d[f"mb{mb}.losses"],
                                   rtol=1e-4)
        np.testing.assert_allclose(r0["norms"], d[f"mb{mb}.norms"],
                                   rtol=1e-4)
        # the mask moves the loss (it is not the unmasked step's)
        assert abs(r0["losses"][0] / plain[f"mb{mb}.losses"][0] - 1) > 1e-3
        for name, got in r0["params"].items():
            np.testing.assert_allclose(got, d[f"mb{mb}.p.{name}"], rtol=0,
                                       atol=2 * LR * 3, err_msg=name)


def test_tinyllama_zero1_step_matches_reference(ref_dir):
    d = np.load(ref_dir / "lm_train.npz")
    res = lmesh.launch(lm_cases_rank, 4, devices=CPU4,
                       args=(str(ref_dir / "lm_train.npz"),),
                       join_s=JOIN_S)
    for mb in (None, 2):
        r0 = res[0][mb]
        np.testing.assert_allclose(r0["losses"], d[f"mb{mb}.losses"],
                                   rtol=1e-4)
        np.testing.assert_allclose(r0["norms"], d[f"mb{mb}.norms"],
                                   rtol=1e-4)
        for name, got in r0["params"].items():
            np.testing.assert_allclose(got, d[f"mb{mb}.p.{name}"], rtol=0,
                                       atol=2 * LR * 3, err_msg=name)


def norm_rank(rank):
    """The sharded global norm of a tree laid out under ZeRO-1 specs
    against the unsharded one, and the moments' block shapes."""
    torch.set_num_threads(1)
    from repro_torch.common.sharding import P
    from repro_torch.train.optimizer import (global_norm,
                                             sharded_global_norm, zero1_spec)
    mesh = lmesh.make_mesh((2, 2), ("data", "model"))
    g = torch.Generator().manual_seed(0)
    whole = {"a": torch.randn(8, 6, generator=g),
             "b": torch.randn(5, generator=g),
             "c": torch.randn(4, 4, generator=g)}
    specs = {"a": P("data", "model"), "b": P(), "c": P(None, "model")}
    z = {k: zero1_spec(s, tuple(whole[k].shape), mesh)
         for k, s in specs.items()}
    blocks = _mesh_ranks.blocks(whole, z, mesh)
    return (float(sharded_global_norm(blocks, z, mesh)),
            float(global_norm(whole)), {k: tuple(v.shape)
                                        for k, v in blocks.items()},
            {k: tuple(v) for k, v in z.items()})


def test_sharded_global_norm_counts_each_block_once():
    res = lmesh.launch(norm_rank, 4, devices=CPU4, join_s=JOIN_S)
    for got, want, shapes, z in res:
        np.testing.assert_allclose(got, want, rtol=1e-6)
        assert z == {"a": ("data", "model"), "b": (), "c": ("data", "model")}
        assert shapes == {"a": (4, 3), "b": (5,), "c": (2, 2)}
