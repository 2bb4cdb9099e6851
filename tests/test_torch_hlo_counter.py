"""The port's copy of ``core/hlo_counter.py`` against the reference's:
both ``totals()`` on ``tests/test_hlo_tools.py``'s HLO cases (a scanned
matmul, nested scans, a batched dot, the collectives' text) and on the
compiled ZeRO-1 step of the smoke TinyLlama on (data=2, model=2), with
and without ``seq_parallel`` and microbatches (``tests/_mesh_reference.py
lm_tp_comm``): every field equal."""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax import lax

from repro.core import hlo_counter as ref
from repro_torch.core import hlo_counter as port

ROOT = Path(__file__).resolve().parents[1]


def _compile_text(f, *specs):
    return jax.jit(f).lower(*specs).compile().as_text()


def _scan_matmul():
    def f(x, w, w2):
        def body(c, _):
            return c @ w, None
        y, _ = lax.scan(body, x, None, length=5)
        return y @ w2
    return _compile_text(f, jax.ShapeDtypeStruct((128, 256), jnp.float32),
                         jax.ShapeDtypeStruct((256, 256), jnp.float32),
                         jax.ShapeDtypeStruct((256, 512), jnp.float32))


def _nested_scan():
    def f(x, w):
        def outer(c, _):
            def inner(c2, _):
                return c2 @ w, None
            c2, _ = lax.scan(inner, c, None, length=3)
            return c2, None
        y, _ = lax.scan(outer, x, None, length=4)
        return y
    return _compile_text(f, jax.ShapeDtypeStruct((64, 64), jnp.float32),
                         jax.ShapeDtypeStruct((64, 64), jnp.float32))


def _batched_dot():
    return _compile_text(lambda x, w: jnp.einsum("bij,bjk->bik", x, w),
                         jax.ShapeDtypeStruct((8, 32, 64), jnp.float32),
                         jax.ShapeDtypeStruct((8, 64, 16), jnp.float32))


def _collectives():
    """``test_extract_parses_collectives``'s ops, in an entry computation
    (``totals`` reads computations)."""
    return """ENTRY %main (x: f32[1024,512], y: bf16[4,128], z: f32[32]) -> f32[32] {
  %x = f32[1024,512]{1,0} parameter(0)
  %y = bf16[4,128]{1,0} parameter(1)
  %z = f32[32]{0} parameter(2)
  %ar = f32[1024,512]{1,0} all-reduce(%x), replica_groups={{0,1,2,3}}, to_apply=%add
  %ag.1 = bf16[64,128]{1,0} all-gather(%y), replica_groups=[16,16], dimensions={0}
  ROOT %a2a = f32[32]{0} all-to-all(%z), replica_groups={{0,1},{2,3}}
}
"""


def _same(text: str) -> port.Totals:
    want, got = ref.totals(text), port.totals(text)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    return got


@pytest.mark.parametrize("case", [_scan_matmul, _nested_scan, _batched_dot,
                                  _collectives],
                         ids=["scan_matmul", "nested_scan", "batched_dot",
                              "collectives"])
def test_totals_equal_on_the_hlo_tools_cases(case):
    got = _same(case())
    if case is _scan_matmul:
        assert got.flops == 5 * 2 * 128 * 256 * 256 + 2 * 128 * 512 * 256
    if case is _collectives:
        assert got.coll == {"all-reduce": 1024 * 512 * 4,
                            "all-gather": 4 * 128 * 2, "all-to-all": 32 * 4,
                            "total": 1024 * 512 * 4 + 4 * 128 * 2 + 32 * 4}


@pytest.fixture(scope="module")
def step_hlo(tmp_path_factory):
    out = tmp_path_factory.mktemp("mesh_ref")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, str(ROOT / "tests" /
                                            "_mesh_reference.py"), str(out),
                        "lm_tp_comm"], capture_output=True, text=True,
                       env=env, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    d = np.load(out / "lm_tp_comm.npz")
    return {k[:-len(".hlo")]: str(d[k]) for k in d.files
            if k.endswith(".hlo")}


@pytest.mark.parametrize("name", ["sp0.mbNone", "sp0.mb2", "sp1.mbNone",
                                  "sp1.mb2"])
def test_totals_equal_on_the_compiled_mesh_step(step_hlo, name):
    got = _same(step_hlo[name])
    assert got.flops > 0 and got.coll["total"] > 0
