"""MoE's mesh bodies in the port against the reference's ``shard_map``:
``ep_a2a`` on (data=4, model=1) and (data=2, model=2) and ``tp`` on
(data=2, model=2), the DeepSeek-V2 smoke config (E = 8, top-2) at its own
capacity factor, so slots drop; float32, rtol 1e-5.  The reference runs
in a subprocess on 4 forced host devices (``tests/_mesh_reference.py``),
the port on 4 CPU ranks over ``gloo`` (``tests/_mesh_ranks.py``).  Then a
DeepSeek-V2 smoke ``Model`` over a mesh: its prefill on each rank's rows,
with the experts' blocks, against the same model in one process (no
drops at a high capacity factor)."""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import _mesh_ranks
from repro_torch.common import sharding as S
from repro_torch.configs import smoke_config
from repro_torch.launch import mesh as lmesh

ROOT = Path(__file__).resolve().parents[1]
JOIN_S = 120
CPU4 = ["cpu"] * 4      # CPU ranks, asked for by name


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
    run_reference(out, "moe")
    return out


def test_mesh_bodies_match_reference_drops_included(ref_dir):
    d = np.load(ref_dir / "moe.npz")
    res = lmesh.launch(_mesh_ranks.moe_rank, 4, devices=CPU4,
                       args=(str(ref_dir / "moe.npz"),), join_s=JOIN_S)
    for case in ("ep_a2a_4x1", "ep_a2a_2x2", "tp_2x2"):
        want = d[case]
        n_data = int(case.split("_")[-1].split("x")[0])
        rows = want.shape[0] // n_data
        scale = float(np.abs(want).max())
        for r in res:
            y, dropped, di = r[case]
            np.testing.assert_allclose(y, want[di * rows:(di + 1) * rows],
                                       rtol=1e-5, atol=1e-5 * scale,
                                       err_msg=case)
        # the router leans on the first experts: capacity drops happen
        assert sum(r[case][1] for r in res) > 0, case


def model_rank(rank, impl, shape):
    """DeepSeek-V2 smoke prefill over a mesh: this rank's rows' logits
    with the parameters' blocks, capacity 8 (no drops)."""
    torch.set_num_threads(1)
    from repro_torch.common.pytree import flatten_with_paths, unflatten_like
    from repro_torch.models import Model
    from repro_torch.models import moe as MOE
    cfg = dataclasses.replace(smoke_config("deepseek-v2-236b"),
                              moe_impl=impl, capacity_factor=8.0)
    mesh = lmesh.make_mesh(shape, ("data", "model"))
    model = Model(cfg, device="cpu", mesh=mesh)
    model.compute_dtype = torch.float32
    whole = Model(cfg, device="cpu").init(torch.Generator().manual_seed(3))
    specs = model.param_specs()
    mine = unflatten_like(whole, [
        S.local_shard(x, sp, mesh).clone() for (_, x), (_, sp) in zip(
            flatten_with_paths(whole), S.flatten_specs(specs))])
    toks = np.random.default_rng(1).integers(0, cfg.vocab, (4, 12),
                                             dtype=np.int32)
    rows = S.local_shard(torch.from_numpy(toks),
                         model.batch_pspecs(_shape())["tokens"], mesh)
    with MOE.count_dropped() as dropped:
        logits, _ = model.prefill(mine, {"tokens": rows.numpy()})
    single = Model(cfg, device="cpu")
    single.compute_dtype = torch.float32
    want, _ = single.prefill(whole, {"tokens": rows.numpy()})
    return logits.numpy(), want.numpy(), int(dropped)


def _shape():
    from repro_torch.configs.base import ShapeConfig
    return ShapeConfig("t", seq_len=12, global_batch=4, kind="prefill")


@pytest.mark.parametrize("impl,shape", [("ep_a2a", (4, 1)),
                                        ("ep_a2a", (2, 2)), ("tp", (2, 2))])
def test_model_over_a_mesh_equals_one_process(impl, shape):
    res = lmesh.launch(model_rank, 4, devices=CPU4, args=(impl, shape),
                       join_s=JOIN_S)
    for got, want, dropped in res:
        assert dropped == 0
        np.testing.assert_allclose(got, want, rtol=1e-4,
                                   atol=1e-5 * float(np.abs(want).max()))


def test_an_abstract_mesh_refuses_the_mesh_bodies():
    from repro_torch.models import moe as MOE
    cfg = dataclasses.replace(smoke_config("deepseek-v2-236b"),
                              moe_impl="ep_a2a")
    mesh = S.abstract_mesh((2, 2), ("data", "model"))
    p = {"router": torch.zeros(cfg.d_model, cfg.n_experts)}
    with pytest.raises(ValueError, match="live mesh"):
        MOE.moe_apply(p, torch.zeros(4, cfg.d_model), cfg, mesh)
    # no "model" axis: the reference's dense path
    assert not MOE.uses_mesh(cfg, S.abstract_mesh((4,), ("data",)))
    assert MOE.moe_param_overrides(cfg) == {"expert": ("data",)}
