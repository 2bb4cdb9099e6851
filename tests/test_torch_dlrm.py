"""The port's DLRM (``repro_torch.models.dlrm``, on the CPU) against the
reference's (``repro.models.dlrm``).

Weights come from the reference's ``init`` and cross by
``repro_torch.convert.dlrm_params_from_numpy``; batches from both
packages' ``dlrm_batch`` (identical arrays).  Both of the reference's
embedding paths (jnp, and Pallas in interpret mode) are compared.

Tolerances: the pooled bags must be equal to the bit (same float32 sums in
the same order, one rounding to bf16).  Logits: rtol 2e-2, atol 2e-3, the
slack of bf16 activations through the MLPs (on the CPU they come out
equal).
"""
import dataclasses
import math
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as r_get_config
from repro.configs import smoke_config as r_smoke_config
from repro.data.pipeline import dlrm_batch as r_dlrm_batch
from repro.models.dlrm import DLRM as RDLRM
from repro_torch import configs, convert
from repro_torch.common import init as init_mod
from repro_torch.data import dlrm_batch
from repro_torch.models import DLRM, DLRMConfig, comm_profile
from repro_torch.models import dlrm as dlrm_mod

ROOT = Path(__file__).resolve().parents[1]
LOGIT_RTOL, LOGIT_ATOL = 2e-2, 2e-3

@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The op path is thousands of small ops: one intra-op thread is
    faster than many, and does not fight the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# the smoke config, and a narrow one at Table II's pooling and width
NARROW = dict(n_dense=64, n_tables=8, emb_dim=64, pooling=60,
              rows_per_table=1000, bot_mlp=(64, 64), top_mlp=(64, 64))


def _configs(name):
    r_cfg = r_smoke_config("dlrm")
    if name == "narrow":
        r_cfg = dataclasses.replace(r_cfg, **NARROW)
    fields = {f.name: getattr(r_cfg, f.name)
              for f in dataclasses.fields(r_cfg)
              if f.name != "use_pallas_embedding"}
    return r_cfg, DLRMConfig(**fields)


def _port_cfg_fields(cfg):
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
            if f.name not in ("use_pallas_embedding", "embedding_impl")}


def _bits(x):
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy()
    return np.asarray(x).view(np.int16)


@pytest.fixture(scope="module", params=["smoke", "narrow"])
def pair(request):
    r_cfg, p_cfg = _configs(request.param)
    params = RDLRM(r_cfg).init(jax.random.PRNGKey(3))
    tree = jax.tree.map(np.asarray, params)
    model = DLRM(p_cfg, device="cpu",
                 params=convert.dlrm_params_from_numpy(tree, "cpu"))
    batch = r_dlrm_batch(5, 2, 16, r_cfg)
    return r_cfg, params, model, batch


@pytest.mark.parametrize("pallas", [False, True], ids=["jnp", "pallas"])
def test_forward_matches_reference(pair, pallas):
    r_cfg, params, model, batch = pair
    ref = RDLRM(dataclasses.replace(r_cfg, use_pallas_embedding=pallas))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    pooled_r = ref._embed_bags(params["tables"], jb["sparse_idx"])
    logits_r = np.asarray(jax.jit(ref.forward)(params, jb)
                          .astype(jnp.float32))
    pooled = model.embed_bags(torch.as_tensor(batch["sparse_idx"]))
    logits = model(batch)
    assert pooled.dtype == torch.bfloat16 and logits.dtype == torch.bfloat16
    np.testing.assert_array_equal(_bits(pooled), _bits(pooled_r))
    assert logits.shape == logits_r.shape
    np.testing.assert_allclose(logits.float().numpy(), logits_r,
                               rtol=LOGIT_RTOL, atol=LOGIT_ATOL)


def test_loss_matches_reference(pair):
    r_cfg, params, model, batch = pair
    want = float(RDLRM(r_cfg).loss(params, {k: jnp.asarray(v)
                                             for k, v in batch.items()}))
    got = float(model.loss(batch))
    np.testing.assert_allclose(got, want, rtol=LOGIT_RTOL, atol=LOGIT_ATOL)


def test_params_cross_bit_for_bit(pair):
    r_cfg, params, model, _ = pair
    np.testing.assert_array_equal(_bits(model.tables.detach()),
                                  _bits(params["tables"]))
    for part in ("bot", "top"):
        got = getattr(model, part)
        assert set(got) == set(params[part])
        for k, v in params[part].items():
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(v))
            assert not got[k].requires_grad


@pytest.mark.parametrize("flag", [True, False])
def test_forward_reduces_bf16_products_in_float32(pair, monkeypatch, flag):
    """The MLPs' bf16 products run with cuBLAS's bf16 reduction off, as
    the reference's dots reduce in float32, whatever the caller set; the
    caller's flag is back after the forward."""
    _, _, model, batch = pair
    matmul = torch.backends.cuda.matmul
    seen = []
    apply = dlrm_mod._mlp_apply

    def spy(*a):
        seen.append(matmul.allow_bf16_reduced_precision_reduction)
        return apply(*a)

    monkeypatch.setattr(dlrm_mod, "_mlp_apply", spy)
    saved = matmul.allow_bf16_reduced_precision_reduction
    matmul.allow_bf16_reduced_precision_reduction = flag
    try:
        model(batch)
        assert seen == [False, False]
        assert matmul.allow_bf16_reduced_precision_reduction is flag
    finally:
        matmul.allow_bf16_reduced_precision_reduction = saved


def test_convert_rejects_other_dtypes():
    with pytest.raises(TypeError, match="float64"):
        convert.dlrm_params_from_numpy({"w": np.zeros(3)}, "cpu")


@pytest.mark.parametrize("name", ["smoke", "table2"])
def test_comm_profile_equal(name):
    r_cfg = r_smoke_config("dlrm") if name == "smoke" \
        else r_get_config("dlrm")
    want = RDLRM(r_cfg).comm_profile()
    p_cfg = DLRMConfig(**_port_cfg_fields(r_cfg))
    assert comm_profile(p_cfg) == want
    if name == "table2":
        # 58,557,505 MLP parameters in bf16
        assert want["allreduce_bytes"] == 2 * 58_557_505


@pytest.mark.parametrize("seed,step,B", [(0, 0, 1), (0, 7, 64), (123, 4, 9)])
@pytest.mark.parametrize("cfg_name", ["smoke", "table2"])
def test_dlrm_batch_identical(seed, step, B, cfg_name):
    r_cfg = (r_smoke_config("dlrm") if cfg_name == "smoke"
             else r_get_config("dlrm"))
    want = r_dlrm_batch(seed, step, B, r_cfg)
    got = dlrm_batch(seed, step, B, DLRMConfig(**_port_cfg_fields(r_cfg)))
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])


def test_registry_matches_reference():
    for get, r_get in ((configs.get_config, r_get_config),
                       (configs.smoke_config, r_smoke_config)):
        assert _port_cfg_fields(get("dlrm")) == _port_cfg_fields(r_get("dlrm"))
    # every architecture of the reference is there (the VLM and
    # encoder-decoder ones once raised here)
    assert configs.get_config("paligemma-3b").vlm_prefix_len == 256
    assert configs.smoke_model("whisper-base", device="cpu").cfg.enc_dec
    with pytest.raises(KeyError, match="unknown arch"):
        configs.get_config("whisper-large")
    m = configs.smoke_model("dlrm", device="cpu", seed=1)
    assert m.embedding_impl == "torch"
    assert m(dlrm_batch(0, 0, 4, m.cfg)).shape == (4,)


def test_models_are_built_on_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        configs.smoke_model("dlrm")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DLRM(configs.smoke_config("dlrm"))


def test_embedding_impl_dispatch():
    cfg = configs.smoke_config("dlrm")
    with pytest.raises(ValueError, match="needs a CUDA device"):
        DLRM(dataclasses.replace(cfg, embedding_impl="cuda"), device="cpu")
    with pytest.raises(ValueError, match="embedding_impl"):
        DLRM(dataclasses.replace(cfg, embedding_impl="pallas"),
             device="cpu")
    m = DLRM(dataclasses.replace(cfg, embedding_impl="torch"), device="cpu")
    assert m.embedding_impl == "torch"


def test_init_rules():
    """The reference's rules (normal 0.02, lecun-scaled, zeros), drawn
    from the explicit generator: the same seed gives the same weights."""
    cfg = dataclasses.replace(configs.smoke_config("dlrm"),
                              rows_per_table=4000, n_dense=400)
    a = DLRM(cfg, device="cpu", seed=7)
    b = DLRM(cfg, device="cpu", seed=7)
    c = DLRM(cfg, device="cpu", seed=8)
    for (k, x), y, z in zip(a.state_dict().items(), b.state_dict().values(),
                            c.state_dict().values()):
        assert torch.equal(x, y), k
        if k.split(".")[-1].startswith("b"):
            assert not x.any(), k
        else:
            assert not torch.equal(x, z), k
    np.testing.assert_allclose(float(a.tables.float().std()), 0.02,
                               rtol=0.02)
    # lecun: std 1/sqrt(fan_in = shape[-2])
    np.testing.assert_allclose(float(a.bot["w0"].std()), 400 ** -0.5,
                               rtol=0.05)
    assert init_mod.init_scale("scaled", (7,)) == 1 / math.sqrt(7)
    assert init_mod.init_scale("normal", (3, 4)) == 0.02
    assert init_mod.init_scale("zeros", (3, 4)) == 0.0
    with pytest.raises(ValueError, match="unknown init"):
        init_mod.init_scale("uniform", (3, 4))


def test_tables_fill_in_place_one_table_at_a_time():
    """A stack is drawn slice by slice into the tensor itself."""
    x = torch.empty((3, 50, 4), dtype=torch.bfloat16)
    ptr = x.data_ptr()
    gen = torch.Generator().manual_seed(0)
    out = init_mod.fill_(x, "normal", gen)
    assert out.data_ptr() == ptr and out.dtype == torch.bfloat16
    gen = torch.Generator().manual_seed(0)
    want = [torch.randn((50, 4), generator=gen).mul_(0.02)
            .to(torch.bfloat16) for _ in range(3)]
    assert torch.equal(x, torch.stack(want))


def test_dlrm_runs_with_jax_unavailable():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "from repro_torch.configs import smoke_model\n"
        "from repro_torch.data import dlrm_batch\n"
        "m = smoke_model('dlrm', device='cpu')\n"
        "out = m(dlrm_batch(0, 0, 8, m.cfg))\n"
        "assert out.shape == (8,), out.shape\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")
