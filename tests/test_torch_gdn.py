"""Port parity: GDN (K1's plain path) and lower_bound against the JAX package.

The same numpy inputs go through the JAX function and the port's CPU path.
Tolerance rtol 1e-4, atol 1e-5: both are fp32, with sums in another order.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iclr_17_compression_tpu.ops.pallas.gdn_kernel import gdn_pallas
from iclr_17_compression_tpu_torch.ops import gdn as tgdn
from iclr_17_compression_tpu_torch.ops import math as tmath
from iclr_17_compression_tpu_torch.ops.kernels import gdn_kernel

# the JAX package's ops/__init__ re-exports functions named like its
# submodules, so reach the modules themselves
jgdn = importlib.import_module("iclr_17_compression_tpu.ops.gdn")
jmath = importlib.import_module("iclr_17_compression_tpu.ops.math")

RTOL, ATOL = 1e-4, 1e-5


def _params(rng, ch):
    # reparameterized values, a few below the bounds so lower_bound bites
    beta = np.abs(rng.standard_normal(ch)).astype(np.float32) * 0.5 + 0.3
    gamma = np.abs(rng.standard_normal((ch, ch))).astype(np.float32) * 0.05
    gamma[0, :4] = 0.0
    return beta, gamma


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("ch", [32, 128])
def test_gdn_matches_jax(inverse, ch):
    rng = np.random.default_rng(10 + ch)
    beta, gamma = _params(rng, ch)
    x = rng.standard_normal((2, 4, 8, ch)).astype(np.float32)
    jp = jgdn.GDNParams(jnp.asarray(beta), jnp.asarray(gamma))
    ref_xla = np.asarray(jgdn.gdn_xla(jnp.asarray(x), jp, inverse=inverse))
    ref_pallas = np.asarray(gdn_pallas(jnp.asarray(x), jp, inverse=inverse, interpret=True))
    tp = tgdn.GDNParams(torch.from_numpy(beta), torch.from_numpy(gamma))
    before = gdn_kernel.gdn_fused.launches
    out = tgdn.gdn(torch.from_numpy(x), tp, inverse=inverse).numpy()
    plain = tgdn.gdn_plain(torch.from_numpy(x), tp, inverse=inverse).numpy()
    assert gdn_kernel.gdn_fused.launches == before  # a CPU tensor takes the plain path
    np.testing.assert_allclose(out, ref_xla, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(out, ref_pallas, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(plain, ref_xla, rtol=RTOL, atol=ATOL)


def test_gdn_reparam_and_init_match_jax():
    rng = np.random.default_rng(3)
    beta, gamma = _params(rng, 16)
    jb, jg = jgdn.gdn_reparam(jgdn.GDNParams(jnp.asarray(beta), jnp.asarray(gamma)))
    tb, tg = tgdn.gdn_reparam(tgdn.GDNParams(torch.from_numpy(beta), torch.from_numpy(gamma)))
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), rtol=1e-6, atol=1e-12)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-6, atol=1e-12)
    ji, ti = jgdn.gdn_param_init(16), tgdn.gdn_param_init(16)
    np.testing.assert_allclose(ti.beta.numpy(), np.asarray(ji.beta), rtol=1e-7)
    np.testing.assert_allclose(ti.gamma.numpy(), np.asarray(ji.gamma), rtol=1e-7)
    for name in ("REPARAM_OFFSET", "PEDESTAL", "BETA_BOUND", "GAMMA_BOUND"):
        assert getattr(tgdn, name) == getattr(jgdn, name)


def test_lower_bound_gradient_matches_jax_vjp():
    rng = np.random.default_rng(4)
    bound = 0.25
    x = rng.uniform(-0.5, 1.0, 64).astype(np.float32)
    x[:4] = bound  # at the bound: passes
    g = rng.standard_normal(64).astype(np.float32)
    y_j, vjp = jax.vjp(lambda v: jmath.lower_bound(v, bound), jnp.asarray(x))
    (gx_j,) = vjp(jnp.asarray(g))
    xt = torch.from_numpy(x).requires_grad_(True)
    y_t = tmath.lower_bound(xt, bound)
    y_t.backward(torch.from_numpy(g))
    np.testing.assert_array_equal(y_t.detach().numpy(), np.asarray(y_j))
    np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(gx_j))
    # the gate is exercised both ways: blocked (below bound, g >= 0) and open
    below = x < bound
    assert np.any(below & (g >= 0)) and np.any(below & (g < 0))


def test_gdn_gradient_through_reparam_matches_jax():
    """The plain path stays differentiable (the training slice relies on it)."""
    rng = np.random.default_rng(5)
    beta, gamma = _params(rng, 8)
    x = rng.standard_normal((1, 2, 4, 8)).astype(np.float32)

    def loss_j(x_, b_, g_):
        return jnp.sum(jgdn.gdn_xla(x_, jgdn.GDNParams(b_, g_)) ** 2)

    gx_j, gb_j, gg_j = jax.grad(loss_j, argnums=(0, 1, 2))(
        jnp.asarray(x), jnp.asarray(beta), jnp.asarray(gamma))
    xt, bt, gt = (torch.from_numpy(a).requires_grad_(True) for a in (x, beta, gamma))
    torch.sum(tgdn.gdn(xt, tgdn.GDNParams(bt, gt)) ** 2).backward()
    for t, j in ((xt, gx_j), (bt, gb_j), (gt, gg_j)):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(j), rtol=RTOL, atol=ATOL)


def test_kernel_wrapper_refuses_unsupported_tensors():
    """A non-CPU, non-CUDA tensor never falls back to the plain path."""
    x = torch.zeros((2, 32), device="meta")
    with pytest.raises((ValueError, RuntimeError)):
        gdn_kernel.gdn_fused(x, torch.zeros((32, 32), device="meta"),
                             torch.zeros(32, device="meta"))
