"""The port's logical-axis sharding against the reference's, spec for spec:
``MeshRules`` (every case of ``tests/test_sharding.py`` and a property
over meshes, axes, shapes and overrides), every ported architecture's
``param_specs``, ZeRO-1 ``opt_state_specs`` and ``batch_pspecs`` at
``SINGLE_POD`` and ``MULTI_POD`` on the reference's ``AbstractMesh``,
the DLRM's, ``zero1_spec`` (``tests/test_optimizer_data.py``'s cases),
``configs/shapes.py`` and the mesh configs; and each rank's block of an
array (``shard_slices``) against ``NamedSharding.devices_indices_map`` of
the reference on 4 forced host devices (a subprocess)."""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
from jax.sharding import AbstractMesh, PartitionSpec as RP

from repro.common.pytree import flatten_with_paths as ref_flatten
from repro.common.sharding import MeshRules as RMeshRules
from repro.configs import get_config as r_get_config
from repro.configs import shapes as rshapes
from repro.configs.base import MULTI_POD as R_MULTI_POD
from repro.configs.base import SINGLE_POD as R_SINGLE_POD
from repro.models.dlrm import DLRM as RDLRM
from repro.models.model_api import Model as RModel
from repro.train.optimizer import opt_state_specs as r_opt_state_specs
from repro.train.optimizer import zero1_spec as r_zero1_spec
from repro_torch.common import sharding as S
from repro_torch.common.pytree import ParamDef, specs_of
from repro_torch.configs import ARCHS, get_config
from repro_torch.configs import shapes as pshapes
from repro_torch.configs.base import MULTI_POD, SINGLE_POD, MeshConfig
from repro_torch.launch import mesh as lmesh
from repro_torch.models import dlrm as pdlrm
from repro_torch.models.model_api import Model
from repro_torch.train.optimizer import opt_state_specs, zero1_spec

from _hyp import given, settings, st

ROOT = Path(__file__).resolve().parents[1]


def _ref_mesh(sizes, names):
    try:
        return AbstractMesh(sizes, names)
    except TypeError:   # jax<=0.4.x signature
        return AbstractMesh(tuple(zip(names, sizes)))


def conv(spec) -> tuple:
    """A reference PartitionSpec as a tuple of entries."""
    return tuple(spec)


def ref_flat_specs(tree) -> dict:
    return {n: conv(s) for n, s in ref_flatten(
        tree, is_leaf=lambda x: isinstance(x, RP))}


def port_flat_specs(tree) -> dict:
    return {n: tuple(s) for n, s in S.flatten_specs(tree)}


MESH = ((16, 16), ("data", "model"))
MESH3 = ((2, 16, 16), ("pod", "data", "model"))

# tests/test_sharding.py:25-66: (mesh, overrides, axes, shape)
RULE_CASES = [
    (MESH, None, ("vocab", "embed"), (32000, 2048)),
    (MESH, None, ("embed", "mlp"), (2048, 5632)),
    (MESH, None, ("batch", None), (256, 4096)),
    (MESH3, None, ("batch", None), (256, 4096)),
    (MESH, None, ("embed", "kv_heads", None), (2048, 4, 64)),
    (MESH, None, ("embed", "heads", None), (2048, 32, 64)),
    (MESH, None, ("vocab", "embed"), (51865, 512)),
    (MESH3, None, ("batch", None), (1, 1)),
    (MESH, {"seq": ("model",)}, ("heads", "seq"), (32, 4096)),
    (MESH, {"expert": ("data",)}, ("expert", "embed", "mlp"),
     (256, 64, 2048)),
]


@pytest.mark.parametrize("mesh,overrides,axes,shape", RULE_CASES)
def test_rules_match_reference(mesh, overrides, axes, shape):
    want = RMeshRules.create(_ref_mesh(*mesh), overrides).pspec(axes, shape)
    rules = S.MeshRules.create(S.abstract_mesh(*mesh), overrides)
    got = rules.pspec(axes, shape)
    assert isinstance(got, S.PartitionSpec)
    assert tuple(got) == conv(want)
    assert rules == S.MeshRules(*(getattr(RMeshRules.create(
        _ref_mesh(*mesh), overrides), f.name) for f in dataclasses.fields(
            RMeshRules)))
    assert tuple(S.logical_to_pspec(axes, S.abstract_mesh(*mesh),
                                    overrides)) == \
        conv(RMeshRules.create(_ref_mesh(*mesh), overrides).pspec(axes))


def test_fsdp_rules_and_defaults_are_the_reference_s():
    from repro.common import sharding as rsh
    assert S.DEFAULT_RULES == rsh.DEFAULT_RULES
    assert S.FSDP_RULES == rsh.FSDP_RULES
    r = S.MeshRules.create(S.abstract_mesh(*MESH), S.FSDP_RULES)
    want = RMeshRules.create(_ref_mesh(*MESH), rsh.FSDP_RULES)
    assert tuple(r.pspec(("embed", "mlp"), (2048, 5632))) == \
        conv(want.pspec(("embed", "mlp"), (2048, 5632)))


_LOGICAL = sorted(S.DEFAULT_RULES) + [None]
_AXES = ("pod", "data", "model", "stage")


@settings(max_examples=60, deadline=None)
@given(st.data())
def test_pspec_property_matches_reference(data):
    names = data.draw(st.lists(st.sampled_from(_AXES), min_size=1,
                               max_size=3, unique=True))
    sizes = [data.draw(st.sampled_from([1, 2, 3, 4, 16])) for _ in names]
    nd = data.draw(st.integers(1, 4))
    axes = tuple(data.draw(st.sampled_from(_LOGICAL)) for _ in range(nd))
    shape = tuple(data.draw(st.sampled_from([1, 2, 3, 4, 6, 8, 12, 16, 48,
                                             256])) for _ in range(nd))
    overrides = {}
    for k in data.draw(st.lists(st.sampled_from(sorted(S.DEFAULT_RULES)),
                                max_size=3, unique=True)):
        overrides[k] = tuple(data.draw(st.lists(st.sampled_from(_AXES),
                                                max_size=2, unique=True)))
    want = RMeshRules.create(_ref_mesh(tuple(sizes), tuple(names)),
                             overrides)
    got = S.MeshRules.create(S.abstract_mesh(sizes, names), overrides)
    assert tuple(got.pspec(axes, shape)) == conv(want.pspec(axes, shape))
    assert tuple(got.pspec(axes)) == conv(want.pspec(axes))


# ---------------------------------------------------------------------------
# every ported architecture, both production meshes
# ---------------------------------------------------------------------------

MESHES = {"single_pod": (SINGLE_POD, R_SINGLE_POD),
          "multi_pod": (MULTI_POD, R_MULTI_POD)}


def test_mesh_configs_and_shapes_are_the_reference_s():
    for port, ref in MESHES.values():
        assert (port.shape, port.axes, port.n_devices) == \
            (ref.shape, ref.axes, ref.n_devices)
    assert MeshConfig((2, 3), ("a", "b")).n_devices == 6
    assert {k: dataclasses.asdict(v) for k, v in pshapes.ALL_SHAPES.items()} \
        == {k: dataclasses.asdict(v) for k, v in rshapes.ALL_SHAPES.items()}
    assert pshapes.LONG_OK == rshapes.LONG_OK
    for arch in ARCHS:
        assert [s.name for s in pshapes.shapes_for(arch)] == \
            [s.name for s in rshapes.shapes_for(arch)]
        for shp in pshapes.ALL_SHAPES:
            assert pshapes.skip_reason(arch, shp) == \
                rshapes.skip_reason(arch, shp)


def test_production_mesh_is_abstract_without_a_process_group():
    for multi, (cfg, _) in ((False, MESHES["single_pod"]),
                            (True, MESHES["multi_pod"])):
        m = lmesh.make_production_mesh(multi_pod=multi)
        assert not m.is_live and m.rank is None
        assert tuple(m.shape.values()) == cfg.shape
        assert m.axis_names == cfg.axes
    m = lmesh.make_mesh((4, 2), ("data", "model"))
    assert m.size == 8 and not m.is_live
    with pytest.raises(ValueError, match="abstract mesh"):
        m.coords()


def _port_model(arch, mesh):
    return Model(get_config(arch), device="cpu", mesh=mesh)


@pytest.mark.parametrize("which", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_arch_specs_match_reference(arch, which):
    port_cfg, ref_cfg = MESHES[which]
    pmesh = S.abstract_mesh(port_cfg.shape, port_cfg.axes)
    rmesh = _ref_mesh(ref_cfg.shape, ref_cfg.axes)
    model = _port_model(arch, pmesh)
    r_model = RModel(r_get_config(arch), mesh=rmesh)
    specs = model.param_specs()
    r_specs = r_model.param_specs()
    assert port_flat_specs(specs) == ref_flat_specs(r_specs)
    assert port_flat_specs(opt_state_specs(
        specs, model.param_defs(), pmesh, zero1=True)) == ref_flat_specs(
            r_opt_state_specs(r_specs, r_model.param_defs(), rmesh,
                              zero1=True))
    assert model.rules() == S.MeshRules(*(getattr(r_model.rules(), f.name)
                                          for f in dataclasses.fields(
                                              RMeshRules)))
    for shape in pshapes.shapes_for(arch):
        r_shape = rshapes.ALL_SHAPES[shape.name]
        assert port_flat_specs(model.batch_pspecs(shape)) == \
            ref_flat_specs(r_model.batch_pspecs(r_shape)), shape.name
        ins = model.input_specs(shape)
        r_ins = r_model.input_specs(r_shape)
        assert ins["tokens"].shape == r_ins["tokens"].shape
        assert str(ins["tokens"].dtype).split(".")[-1] == \
            str(r_ins["tokens"].dtype)


@pytest.mark.parametrize("which", sorted(MESHES))
@pytest.mark.parametrize("overrides", [None, {"expert": ("data",)}])
def test_dlrm_specs_match_reference(which, overrides):
    port_cfg, ref_cfg = MESHES[which]
    pmesh = S.abstract_mesh(port_cfg.shape, port_cfg.axes)
    rmesh = _ref_mesh(ref_cfg.shape, ref_cfg.axes)
    r_model = RDLRM(r_get_config("dlrm"), mesh=rmesh)
    r_rules = RMeshRules.create(rmesh, overrides)
    rules = S.MeshRules.create(pmesh, overrides)
    cfg = get_config("dlrm")
    specs = pdlrm.param_specs(cfg, rules)
    r_specs = r_model.param_specs(r_rules)
    assert port_flat_specs(specs) == ref_flat_specs(r_specs)
    assert port_flat_specs(opt_state_specs(
        specs, pdlrm.param_defs(cfg), pmesh, zero1=True,
        keep_master=False)) == ref_flat_specs(r_opt_state_specs(
            r_specs, r_model.param_defs(), rmesh, zero1=True,
            keep_master=False))
    assert port_flat_specs(pdlrm.batch_pspecs(rules)) == \
        ref_flat_specs(r_model.batch_pspecs(r_rules))
    ins = pdlrm.input_specs(cfg, 256)
    for k, v in r_model.input_specs(256).items():
        assert ins[k][0] == v.shape and \
            str(ins[k][1]).split(".")[-1] == str(v.dtype)


def test_unported_configs_keep_their_error():
    """The VLM's and the encoder-decoder's extra inputs (``img``,
    ``frames``; these configs raised here before they were ported, the
    name is kept): shapes, dtypes and specs of every input at every shape
    cell, under both meshes, as the reference's."""
    for arch in ("paligemma-3b", "whisper-base"):
        for port_cfg, ref_cfg in MESHES.values():
            pmesh = S.abstract_mesh(port_cfg.shape, port_cfg.axes)
            rmesh = _ref_mesh(ref_cfg.shape, ref_cfg.axes)
            model = _port_model(arch, pmesh)
            r_model = RModel(r_get_config(arch), mesh=rmesh)
            extra = "img" if model.cfg.vlm_prefix_len else "frames"
            seen = 0
            for shape in pshapes.shapes_for(arch):
                r_shape = rshapes.ALL_SHAPES[shape.name]
                ins = model.input_specs(shape)
                r_ins = r_model.input_specs(r_shape)
                assert sorted(ins) == sorted(r_ins), shape.name
                for name in ("tokens", extra):
                    if name not in r_ins:
                        continue
                    seen += name == extra
                    assert ins[name].shape == r_ins[name].shape
                    assert str(ins[name].dtype).split(".")[-1] == \
                        str(r_ins[name].dtype)
                assert port_flat_specs(model.batch_pspecs(shape)) == \
                    ref_flat_specs(r_model.batch_pspecs(r_shape))
            assert seen, arch


# ---------------------------------------------------------------------------
# ZeRO-1 (tests/test_optimizer_data.py:61-75) and specs_of
# ---------------------------------------------------------------------------

class _FakeMesh:
    axis_names = ("data", "model")
    shape = {"data": 16, "model": 16}


@pytest.mark.parametrize("spec,shape", [((None, "model"), (4096, 1024)),
                                        ((None,), (7,)),
                                        (("data", None), (64, 64)),
                                        ((), (8, 64)), ((), (32,)),
                                        (("model",), (16, 48))])
def test_zero1_spec_matches_reference(spec, shape):
    want = r_zero1_spec(RP(*spec), shape, _FakeMesh())
    got = zero1_spec(S.P(*spec), shape, _FakeMesh())
    assert tuple(got) == conv(want)
    assert zero1_spec(S.P(*spec), shape, None) == S.P(*spec)


def test_specs_of_keeps_the_tree():
    rules = S.MeshRules.create(S.abstract_mesh(*MESH))
    defs = {"a": [ParamDef((32000, 64), ("vocab", "embed"))], "b": 3}
    out = specs_of(defs, rules)
    assert out == {"a": [S.P("model")], "b": 3}
    assert S.flatten_specs(out) == [("a.0", S.P("model"))]
    assert repr(S.P("data", None)) == "P('data', None)"


def test_named_sharding_and_shard_tree():
    m = S.abstract_mesh((2, 4), ("data", "model"))
    tree = S.shard_tree({"w": S.P(None, "model"), "b": [S.P()]}, m)
    assert tree["w"] == S.named_sharding(m, S.P(None, "model"))
    assert tree["w"].shard_shape((6, 8)) == (6, 2)
    assert tree["b"][0].shard_shape((3,)) == (3,)
    with pytest.raises(ValueError, match="does not divide"):
        S.shard_shape((6, 6), S.P(None, "model"), m)


# ---------------------------------------------------------------------------
# a rank's block against the reference's devices_indices_map
# ---------------------------------------------------------------------------

BLOCK_CASES = [((4,), ("data",), ("data",), (8, 3)),
               ((2, 2), ("data", "model"), ("data", "model"), (4, 6)),
               ((2, 2), ("data", "model"), ("model",), (6, 5)),
               ((2, 2), ("data", "model"), (None, ("data", "model")), (3, 8)),
               ((2, 2), ("data", "model"), (("data", "model"),), (8,)),
               ((1, 2, 2), ("pod", "data", "model"),
                (("pod", "data"), None, "model"), (4, 3, 2)),
               ((4,), ("stage",), (), (5,))]


def test_blocks_match_reference_devices_indices_map(tmp_path):
    script = textwrap.dedent(f"""
        import os, json
        os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
        import jax
        from jax.sharding import NamedSharding, PartitionSpec as P, AxisType
        out = []
        for sizes, names, spec, shape in {BLOCK_CASES!r}:
            mesh = jax.make_mesh(sizes, names,
                                 axis_types=(AxisType.Auto,) * len(names))
            spec = P(*[tuple(e) if isinstance(e, list) else e for e in spec])
            m = NamedSharding(mesh, spec).devices_indices_map(tuple(shape))
            out.append([[[s.start or 0, s.stop if s.stop is not None else n]
                         for s, n in zip(m[d], shape)]
                        for d in mesh.devices.flat])
        print(json.dumps(out))
    """)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-c", script], capture_output=True,
                       text=True, env=env, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    want = json.loads(r.stdout.strip().splitlines()[-1])
    for (sizes, names, spec, shape), ref in zip(BLOCK_CASES, want):
        mesh = S.abstract_mesh(sizes, names)
        for pos, ref_block in enumerate(ref):
            got = S.shard_slices(shape, S.P(*spec), mesh, rank=pos)
            assert [[s.start, s.stop] for s in got] == ref_block, (
                sizes, spec, pos)
        # every element lies in exactly (replicas) blocks
        hits = np.zeros(shape, int)
        for pos in range(mesh.size):
            hits[S.shard_slices(shape, S.P(*spec), mesh, rank=pos)] += 1
        assert (hits == mesh.size // int(np.prod(
            [mesh.axis_size(S.P(*spec).axes(i)) if S.P(*spec).axes(i) else 1
             for i in range(len(shape))]))).all()
