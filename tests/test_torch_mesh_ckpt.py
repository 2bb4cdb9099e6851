"""GPipe and the elastic checkpoint in the port against the reference
(``tests/_mesh_reference.py`` in a subprocess on 4 forced host devices;
the port on CPU ranks over ``gloo``, ``tests/_mesh_ranks.py``):

* ``gpipe`` over (stage=4) equal to the reference's and to the
  sequential stack (``tests/test_pipeline.py``'s case), its ring's
  ``ppermute`` traffic counted;
* a checkpoint saved on (data=4) restored onto (data=2, model=2) and into
  one process bit for bit; the reference's checkpoint with specs
  restored onto a port mesh, and the port's onto a reference mesh, bit
  for bit; ``reshard`` from whole arrays and from another mesh's blocks;
* ``TrainRunner`` with a mesh step: a failure at step 3 restarts from the
  mesh's checkpoint, and the run equals an uninterrupted one."""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import _mesh_ranks
from repro_torch.checkpoint import restore
from repro_torch.common.pytree import flatten_with_paths
from repro_torch.common.sharding import abstract_mesh, shard_slices
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
    run_reference(out, "gpipe", "ckpt_write")
    return out


def test_gpipe_matches_reference_and_sequential(ref_dir):
    d = np.load(ref_dir / "gpipe.npz")
    res = lmesh.launch(_mesh_ranks.gpipe_rank, 4, devices=CPU4,
                       args=(str(ref_dir / "gpipe.npz"),), join_s=JOIN_S)
    seq = torch.from_numpy(d["x"])
    for s in range(4):
        seq = torch.tanh(seq @ torch.from_numpy(d["w"][s]))
    n_ticks = 8 + 4 - 1
    for y, counters in res:
        np.testing.assert_allclose(y, d["y"], rtol=1e-5, atol=1e-6)
        np.testing.assert_array_equal(y, seq.numpy())
        # one hop a tick around the ring, then the masked psum
        assert counters["ppermute"]["calls"] == n_ticks
        assert counters["ppermute"]["sent"] == n_ticks * 2 * 16 * 4
        assert counters["psum"]["calls"] == 1


def test_checkpoints_cross_meshes_and_packages(ref_dir):
    out = ref_dir
    res = lmesh.launch(_mesh_ranks.ckpt_rank, 4, devices=CPU4,
                       args=(str(out),),
                       join_s=JOIN_S)
    whole = np.load(out / "ckpt_write.npz")
    for r in res:
        assert r["meta"] == {"next_step": 5}
        assert r["ref_meta"] == {"next_step": 7}
        for name, want in r["want"].items():
            np.testing.assert_array_equal(r["restored"][name], want, name)
            np.testing.assert_array_equal(r["reshard_whole"][name], want)
            np.testing.assert_array_equal(r["reshard_blocks"][name], want)
        assert r["dtypes"]["0.tables"] == "torch.bfloat16"
        assert r["dtypes"]["1.count"] == "torch.int32"
        # the reference's checkpoint: this rank's blocks under the port's
        # (data=2, model=2) specs, bit for bit
        mesh = abstract_mesh((2, 2), ("data", "model"))
        rank = 2 * r["index22"]["data"] + r["index22"]["model"]
        _, specs = _mesh_ranks.dlrm_state(mesh, None)
        from repro_torch.common.sharding import flatten_specs
        spec_of = dict(flatten_specs(specs))
        for name, got in r["ref_restored"].items():
            want = whole[name][shard_slices(whole[name].shape, spec_of[name],
                                            mesh, rank)]
            np.testing.assert_array_equal(got, want, name)
    # the port's checkpoint (written on (data=4)) into one process
    manifest = json.loads((out / "port_ckpt" / "step_00000005" /
                           "manifest.json").read_text())
    assert manifest["leaves"]["0.tables"]["pspec"] == ["data"]
    assert manifest["leaves"]["1.mu.bot.w0"]["pspec"] == ["data", None]
    (tree, opt), meta = restore(str(out / "port_ckpt"), 5,
                                _mesh_ranks.dlrm_state(
                                    abstract_mesh((4,), ("data",)),
                                    {"expert": ("data",)})[0])
    whole_port, _ = _mesh_ranks.dlrm_state(abstract_mesh((4,), ("data",)),
                                           {"expert": ("data",)})
    for (n, a), (_, b) in zip(flatten_with_paths((tree, opt)),
                              flatten_with_paths(whole_port)):
        assert a.dtype == b.dtype and torch.equal(a, b), n
    # and onto the reference's (data=2, model=2) mesh
    run_reference(out, "ckpt_read")
    got = np.load(out / "ckpt_read.npz")
    assert int(got["next_step"]) == 5
    for n, b in flatten_with_paths(whole_port):
        np.testing.assert_array_equal(got[n], b.float().numpy(), n)
    assert tuple(got["shape.0.tables"]) == (2, 100, 8)


def runner_pair_rank(rank, root):
    return {name: _mesh_ranks.runner_rank(rank, f"{root}/{name}", fail)
            for name, fail in (("whole", -1), ("failed", 3))}


def test_train_runner_restarts_on_the_mesh(tmp_path):
    res = lmesh.launch(runner_pair_rank, 2, devices=["cpu"] * 2,
                       args=(str(tmp_path),),
                       join_s=JOIN_S)
    for r in res:
        whole, failed = r["whole"], r["failed"]
        assert whole["restarts"] == 0 and failed["restarts"] == 1
        # the failed run re-ran step 2 from the step-2 checkpoint
        assert failed["losses"][:2] == whole["losses"][:2]
        assert failed["losses"][-2:] == whole["losses"][-2:]
        for n, a in whole["params"].items():
            np.testing.assert_array_equal(failed["params"][n], a, n)
    steps = sorted(p.name for p in (tmp_path / "failed").iterdir())
    assert steps == ["step_00000002", "step_00000004"]
