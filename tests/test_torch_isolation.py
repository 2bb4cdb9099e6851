"""The port stands alone: no module of ``src/repro_torch`` (its
``core/autotune.py``, ``learn/train.py``, ``core/campaign.py``,
``core/predict.py``, ``launch/run_campaign.py``, ``common/sharding.py``,
``models/{mla,moe,ssm,rwkv}.py`` and the Gemma-2, Gemma-3, Phi-4-mini,
DeepSeek-V2/V3, Zamba2, RWKV-6, PaliGemma and Whisper configs and
TinyLlama's int8 KV cache included, each run below: a batch over a mesh,
each config's prefill and decode, the VLM's and the encoder-decoder's
loss; the training path, ``models/flash.py``, ``train/``,
``checkpoint/``, ``ft/``, ``data/pipeline.py``'s ``lm_batch`` and
``Prefetcher`` and ``launch/train.py``, run below too: a train step of a
flash-enabled TinyLlama and of the DLRM, a checkpoint and its restore,
``launch.train`` with a failure injected; the mesh modules,
``common/sharding.py``'s logical half, ``common/comm.py``,
``launch/mesh.py``, ``configs/shapes.py`` and ``train/pipeline.py``, run
below too: specs on an abstract mesh, and two CPU ranks over ``gloo``
taking a mesh step of the smoke DLRM and a pipeline; ``core/hlo_counter.py``,
``common/cache.py`` and ``launch/dryrun.py``, a smoke cell traced on
``meta`` under a recording mesh, and the model axis of the other
families: a smoke Zamba2 decode cell over a cache split along the
sequence (the log-sum-exp merge, Mamba-2 tensor-parallel) and a smoke
RWKV-6 and DeepSeek-V2 train cell under ``seq_parallel``; nor
``chip_smoke.py``, ``scripts/profile_step.py``,
``scripts/time_flash_decode.py``, ``scripts/time_grad.py`` or
``scripts/hlo_collectives.py``) imports jax
or the JAX package, it
imports and runs with jax unavailable, and it never runs on the CPU unless
asked to."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.core import (EngineConfig, Simulator, SweepRunner,
                              get_policy, incast, simulate, single_switch)

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "scripts" / "profile_step.py",
    ROOT / "scripts" / "time_flash_decode.py",
    ROOT / "scripts" / "time_grad.py", ROOT / "scripts" / "hlo_collectives.py"]


def _imported_roots(path: Path) -> set:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_port_imports_neither_jax_nor_reference(path):
    bad = _imported_roots(path) & {"jax", "jaxlib", "repro", "flax", "optax"}
    assert not bad, f"{path} imports {sorted(bad)}"


def test_port_runs_with_jax_unavailable():
    code = (
        "import dataclasses, sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "import repro_torch\n"
        "import repro_torch.learn\n"
        "import repro_torch.learn.train, repro_torch.core.autotune\n"
        "import repro_torch.core.campaign, repro_torch.core.predict\n"
        "import repro_torch.launch.run_campaign\n"
        "from repro_torch.core import *\n"
        "topo = single_switch(4)\n"
        "sched = incast(topo, [1, 2, 3], 0, 2e5)\n"
        "r = simulate(topo, sched, get_policy('dcqcn'),\n"
        "             EngineConfig(dt=1e-6, max_steps=400, max_extends=0,\n"
        "                          queue_stride=0), device='cpu')\n"
        "assert r.finished, r\n"
        "r = simulate(topo, sched, get_policy('mlp'),\n"
        "             EngineConfig(dt=1e-6, max_steps=400, max_extends=0,\n"
        "                          queue_stride=0), device='cpu',\n"
        "             fault_spec=FaultSpec.lossy_roce(1e-3, 'gbn'))\n"
        "assert r.finished and r.lost.sum() > 0, r\n"
        "from repro_torch.common.sharding import grid_mesh\n"
        "runner = SweepRunner(EngineConfig(dt=1e-6, max_steps=400,\n"
        "                     max_extends=0, queue_stride=0), device='cpu',\n"
        "                     mesh=grid_mesh(2, devices=['cpu', 'cpu']))\n"
        "b = runner.run_batch(topo, sched, 'dcqcn',\n"
        "                     {'rai_frac': [0.01, 0.05, 0.2]})\n"
        "assert b.finished.all() and b.meta['mesh_devices'] == 2, b\n"
        "import numpy as np, torch\n"
        "from repro_torch.configs import smoke_model\n"
        "for arch in ('gemma2-9b', 'gemma3-27b', 'phi4-mini-3.8b',\n"
        "             'deepseek-v2-236b', 'deepseek-v3-671b', 'zamba2-1.2b',\n"
        "             'rwkv6-3b', 'tinyllama-1.1b/int8', 'paligemma-3b',\n"
        "             'whisper-base'):\n"
        "    m = smoke_model(arch.split('/')[0], device='cpu')\n"
        "    if arch.endswith('/int8'):\n"
        "        import dataclasses\n"
        "        from repro_torch.models import Model\n"
        "        m = Model(dataclasses.replace(m.cfg, kv_quant_int8=True),\n"
        "                  device='cpu')\n"
        "    p = m.init(torch.Generator().manual_seed(0))\n"
        "    toks = np.arange(80, dtype=np.int32).reshape(2, 40) % 256\n"
        "    b = {'tokens': toks}\n"
        "    if m.cfg.vlm_prefix_len:\n"
        "        b['img'] = np.ones((2, m.cfg.vlm_prefix_len, m.cfg.d_model))\n"
        "    if m.cfg.enc_dec:\n"
        "        b['frames'] = np.ones((2, 40, m.cfg.d_model))\n"
        "        assert bool(torch.isfinite(m.loss(p, b))), arch\n"
        "    lg, c = m.prefill(p, b, max_len=44 + m.cfg.vlm_prefix_len)\n"
        "    lg, c = m.decode_step(p, c, toks[:, :1])\n"
        "    assert bool(torch.isfinite(lg).all()), arch\n"
        "import dataclasses, tempfile\n"
        "import repro_torch.train.train_step as ts, repro_torch.launch.train\n"
        "from repro_torch.configs.base import TrainConfig\n"
        "from repro_torch.data import Prefetcher, dlrm_batch, lm_batch\n"
        "from repro_torch.checkpoint import restore, save\n"
        "from repro_torch.models import Model\n"
        "m = smoke_model('tinyllama-1.1b', device='cpu')\n"
        "m = Model(dataclasses.replace(m.cfg, flash_attention=True,\n"
        "          block_q=512, block_k=512, n_layers=1), device='cpu')\n"
        "d = smoke_model('dlrm', device='cpu')\n"
        "pf = Prefetcher(lambda s: lm_batch(0, s, 1, 2048, 256))\n"
        "for model, b in ((m, next(pf)), (d, dlrm_batch(0, 0, 8, d.cfg))):\n"
        "    tc = TrainConfig(microbatch=None)\n"
        "    p, o = ts.init_train_state(model, torch.Generator(), tc)\n"
        "    p, o, met = ts.make_train_step(model, tc)(p, o, b)\n"
        "    assert bool(torch.isfinite(met['loss'])), met\n"
        "    with tempfile.TemporaryDirectory() as tmp:\n"
        "        save(tmp, 1, (p, o))\n"
        "        restore(tmp, 1, (p, o))\n"
        "pf.close()\n"
        "with tempfile.TemporaryDirectory() as tmp:\n"
        "    repro_torch.launch.train.main(['--device', 'cpu', '--smoke',\n"
        "        '--steps', '4', '--ckpt-every', '2', '--fail-at', '3',\n"
        "        '--ckpt-dir', tmp, '--seq', '16'])\n"
        "import repro_torch.core.hlo_counter as hc, repro_torch.common.cache\n"
        "from repro_torch.configs import smoke_config\n"
        "from repro_torch.configs.base import ShapeConfig\n"
        "from repro_torch.launch import dryrun\n"
        "cell = dryrun.dryrun_cell('tinyllama-1.1b', 't', False, False,\n"
        "    cfg=smoke_config('tinyllama-1.1b'), mesh_shape=(2, 2),\n"
        "    shape=ShapeConfig('t', seq_len=32, global_batch=4,\n"
        "                      kind='train'))\n"
        "assert cell['flops'] > 0 and cell['collective_bytes']['total'] > 0\n"
        "cell = dryrun.dryrun_cell('zamba2-1.2b', 'long', False, False,\n"
        "    cfg=smoke_config('zamba2-1.2b'), mesh_shape=(2, 2),\n"
        "    shape=ShapeConfig('long', seq_len=64, global_batch=1,\n"
        "                      kind='decode', cache_shard='seq'))\n"
        "assert cell['collective_calls']['pmax'] > 0, cell\n"
        "for a, o in (('rwkv6-3b', {}), ('deepseek-v2-236b',\n"
        "                                {'moe_impl': 'tp'})):\n"
        "    cell = dryrun.dryrun_cell(a, 't', False, False,\n"
        "        cfg=dataclasses.replace(smoke_config(a), seq_parallel=True,\n"
        "                                **o), mesh_shape=(2, 2),\n"
        "        shape=ShapeConfig('t', seq_len=32, global_batch=4,\n"
        "                          kind='train'))\n"
        "    assert cell['gathered_leaves'] == [], cell\n"
        "assert hc.totals('ENTRY %m (x: f32[2]) -> f32[2] {\\n'\n"
        "                 '  ROOT %x = f32[2]{0} parameter(0)\\n}').flops == 0\n"
        "assert 'jax' not in {m.split('.')[0] for m in sys.modules\n"
        "                     if sys.modules[m] is not None}\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


MESH_SCRIPT = """
import sys
sys.modules["jax"] = None
sys.modules["repro"] = None
sys.path.insert(0, {tests!r})
import torch
import repro_torch.common.comm, repro_torch.train.pipeline
from repro_torch.common import sharding as S
from repro_torch.configs import get_config, shapes
from repro_torch.configs.base import SINGLE_POD
from repro_torch.launch import mesh as lm
from repro_torch.models import Model


def rank(r):
    import _mesh_ranks
    from repro_torch.train.pipeline import gpipe
    assert sys.modules["jax"] is None
    loss, norm = _mesh_ranks.dlrm_two_rank_step(r)
    mesh = lm.make_mesh((2,), ("stage",))
    w = torch.full((1, 3, 3), 0.5 * (r + 1))
    y = gpipe(lambda wi, h: h @ wi, w, torch.ones(4, 1, 3), mesh)
    return loss, norm, float(y.sum())


if __name__ == "__main__":
    m = lm.make_production_mesh()
    assert not m.is_live
    model = Model(get_config("tinyllama-1.1b"), device="cpu",
                  mesh=S.abstract_mesh(SINGLE_POD.shape, SINGLE_POD.axes))
    specs = model.param_specs()
    assert specs["embed"] == S.P("model"), specs["embed"]
    assert model.batch_pspecs(shapes.TRAIN_4K)["tokens"] == S.P("data")
    out = lm.launch(rank, 2, devices=["cpu"] * 2, join_s=90)
    assert out[0] == out[1], out
    loss, norm, y = out[0]
    assert loss == loss and norm > 0 and y == 4 * 3 * 0.5 * 3 * 3, out
    assert "jax" not in {{k.split(".")[0] for k in sys.modules
                          if sys.modules[k] is not None}}
    print("ok")
"""


def test_mesh_modules_run_with_jax_unavailable(tmp_path):
    script = tmp_path / "mesh_isolated.py"
    script.write_text(MESH_SCRIPT.format(tests=str(ROOT / "tests")))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, str(script)], capture_output=True,
                         text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().endswith("ok")


PACKAGE_FILES = sorted(p for p in (ROOT / "src" / "repro_torch").rglob("*")
                       if p.is_file() and p.suffix in (".py", ".cu", ".cuh",
                                                       ".json"))


@pytest.mark.parametrize("path", PACKAGE_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PACKAGE_FILES])
def test_port_names_no_path_of_the_reference(path):
    """The package reads nothing under ``src/repro/``: no file of it
    names such a path (the learned policy's weights are its own copy)."""
    text = path.read_text()
    for bad in ("src/repro/", '"repro"', "'repro'"):
        assert bad not in text, (path, bad)


def test_learned_weights_are_the_port_s_own_copy():
    from repro_torch.learn import net
    weights = Path(net._WEIGHTS_PATH).resolve()
    assert weights.parent == ROOT / "src" / "repro_torch" / "learn"
    assert weights.is_file()


def _tiny():
    topo = single_switch(4)
    return topo, incast(topo, [1, 2, 3], 0, 2e5)


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default device is valid")
    topo, sched = _tiny()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Simulator(topo, sched, get_policy("pfc"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        simulate(topo, sched, get_policy("pfc"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        SweepRunner()
    from repro_torch.configs import smoke_model
    from repro_torch.launch import train
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        smoke_model("tinyllama-1.1b")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train.main(["--smoke", "--arch", "dlrm", "--steps", "1"])


def test_cuda_step_impl_on_cpu_raises():
    topo, sched = _tiny()
    with pytest.raises(ValueError, match="needs a CUDA device"):
        Simulator(topo, sched, get_policy("dcqcn"),
                  EngineConfig(step_impl="cuda"), device="cpu")
    with pytest.raises(ValueError, match="step_impl"):
        Simulator(topo, sched, get_policy("dcqcn"),
                  EngineConfig(step_impl="pallas"), device="cpu")
    sim = Simulator(topo, sched, get_policy("dcqcn"), EngineConfig(),
                    device="cpu")
    assert sim.step_impl == "torch"
