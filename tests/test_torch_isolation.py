"""The port stands alone: no module of ``src/repro_torch`` (its
``core/autotune.py``, ``learn/train.py``, ``core/campaign.py``,
``core/predict.py``, ``launch/run_campaign.py``, ``common/sharding.py``
and the Gemma-2, Gemma-3 and Phi-4-mini configs included, each run
below: a batch over a mesh, each config's prefill and decode; nor
``chip_smoke.py``, ``scripts/profile_step.py``,
``scripts/time_flash_decode.py`` or ``scripts/time_grad.py``) imports jax
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
    ROOT / "scripts" / "time_grad.py"]


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
        "import sys\n"
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
        "for arch in ('gemma2-9b', 'gemma3-27b', 'phi4-mini-3.8b'):\n"
        "    m = smoke_model(arch, device='cpu')\n"
        "    p = m.init(torch.Generator().manual_seed(0))\n"
        "    toks = np.arange(80, dtype=np.int32).reshape(2, 40) % 256\n"
        "    lg, c = m.prefill(p, {'tokens': toks}, max_len=44)\n"
        "    lg, c = m.decode_step(p, c, toks[:, :1])\n"
        "    assert bool(torch.isfinite(lg).all()), arch\n"
        "assert 'jax' not in {m.split('.')[0] for m in sys.modules\n"
        "                     if sys.modules[m] is not None}\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
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
