"""``repro_torch.core.arith`` reproduces the reference's compiled CPU
arithmetic bit for bit: Cephes ``exp``, contracted multiply-adds, and the
association order of the plans' gather-and-sum reductions.  These pin the
orders that keep the port's whole runs equal to the reference's."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.engine import _reduce as r_reduce
from repro.core.engine import _reduce_plan as r_plan
from repro_torch.core import engine as peng
from repro_torch.core.arith import expf, fma, ftz, rdiv


def test_expf_is_the_reference_exp():
    rng = np.random.default_rng(0)
    x = np.concatenate([-rng.exponential(0.01, 200000),
                        rng.uniform(-90, 90, 200000),
                        [np.nan, np.inf, -np.inf, 0.0, -87.5, 88.5]])
    x = x.astype(np.float32)
    want = np.asarray(jax.jit(jnp.exp)(x))
    got = expf(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, want)


def test_fma_is_the_contracted_multiply_add():
    rng = np.random.default_rng(1)
    a, b, c = (rng.uniform(-1e6, 1e6, 100000).astype(np.float32)
               for _ in range(3))
    want = np.asarray(jax.jit(lambda a, b, c: c - a * b)(a, b, c))
    got = fma(-torch.from_numpy(a), torch.from_numpy(b),
              torch.from_numpy(c)).numpy()
    np.testing.assert_array_equal(got, want)
    tiny = torch.tensor([1e-39, -1e-40, 2e-38, 0.0], dtype=torch.float32)
    assert ftz(tiny).tolist() == [0.0, 0.0, pytest.approx(2e-38), 0.0]
    x = torch.from_numpy(rng.uniform(1e-3, 10, 1000).astype(np.float32))
    np.testing.assert_array_equal(rdiv(0.95, x).numpy(),
                                  np.float32(0.95) / x.numpy())


# (n_in, n_out, max fan-in): "gather" plans of width 4..64 and "gather2"
# plans whose second level is 4..128 wide
PLANS = [(150, 100, 4), (400, 100, 10), (900, 37, 3), (2000, 61, 30),
         (3000, 500, 400), (20000, 641, 700), (20000, 300, 1900),
         (60000, 50, 1500), (60000, 50, 5000)]


@pytest.mark.parametrize("n_in,n_out,fan", PLANS,
                         ids=[f"{a}-{b}-{c}" for a, b, c in PLANS])
def test_plan_reductions_match_reference_bitwise(n_in, n_out, fan):
    rng = np.random.default_rng(fan)
    ids = rng.integers(0, n_out, n_in)
    ids[:fan] = 0                         # one hot segment
    drop = rng.random(n_in) < 0.1
    r_arrs, strat = r_plan(ids, n_in, n_out, drop=drop)
    p_arrs, p_strat = peng._reduce_plan(ids, n_in, n_out, drop=drop)
    assert p_strat == strat
    vals = (rng.uniform(0, 1e6, n_in) * (rng.random(n_in) < 0.7)).astype(
        np.float32)
    want = np.asarray(jax.jit(lambda v, a: r_reduce(strat, a, v))(
        jnp.asarray(vals), r_arrs))
    got = peng._reduce(strat, peng._plan_tensors(p_arrs, "cpu"),
                       torch.from_numpy(vals)).numpy()
    np.testing.assert_array_equal(got, want)
