"""Port parity of the training-time ops: the quantizers, the K1 and K2
autograd Functions and MS-SSIM, with their gradients, against the JAX
package on the same numpy inputs.

The kernels' Functions run on the CPU here with their plain forward and the
very backward the card runs (a plain recompute, as the JAX package's
``_gdn_fused_bwd`` and ``_conv_gdn_bwd``); the JAX side differentiates
``gdn_pallas`` and ``conv_gdn`` with the Pallas kernels in interpret mode.
Tolerances: rtol 1e-4 and, for gradients, an atol of 1e-5 of each tensor's
largest gradient (fp32 on both sides, sums in another order); 1e-4 for the
gradient of MS-SSIM, whose variances E[x²] − μ² cancel in fp32.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iclr_17_compression_tpu.ops.pallas import conv_gdn_kernel as jk2
from iclr_17_compression_tpu.ops.pallas.gdn_kernel import gdn_pallas
from iclr_17_compression_tpu_torch.ops import gdn as tgdn
from iclr_17_compression_tpu_torch.ops import metrics as tmetrics
from iclr_17_compression_tpu_torch.ops import quant as tquant
from iclr_17_compression_tpu_torch.ops.kernels import conv_gdn_kernel as tk2
from iclr_17_compression_tpu_torch.ops.kernels import gdn_kernel as tk1

jgdn = importlib.import_module("iclr_17_compression_tpu.ops.gdn")
jquant = importlib.import_module("iclr_17_compression_tpu.ops.quant")
jmetrics = importlib.import_module("iclr_17_compression_tpu.ops.metrics")

RTOL = 1e-4
GRAD_ATOL = 1e-5  # of the tensor's largest |gradient|
MSSSIM_GRAD_ATOL = 1e-4


def _close_grad(got, want, what="", atol=GRAD_ATOL):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=atol * max(float(np.abs(want).max()), 1e-30),
                               err_msg=what)


def _leaf(a):
    return torch.from_numpy(np.array(a)).requires_grad_(True)


def _gdn_params(rng, ch):
    """Stored (reparameterized) GDN parameters with some entries below the
    lower bounds, so that the lower_bound gate is exercised."""
    beta = np.abs(rng.standard_normal(ch)).astype(np.float32) * 0.5 + 0.3
    gamma = np.abs(rng.standard_normal((ch, ch))).astype(np.float32) * 0.05
    beta[:2] = 1e-4  # below BETA_BOUND (~1e-3)
    gamma[0, :4] = 0.0  # below GAMMA_BOUND (2**-18)
    return beta, gamma


# ---- quantizers


def test_training_quantizers_match_jax_with_gradients():
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((2, 4, 6, 8)) * 40).astype(np.float32)
    x.reshape(-1)[:8] = np.array([0.5, 1.5, -2.5, 0.49, 0.51, 200.0, -200.0, 0.0], np.float32)
    g = rng.standard_normal(x.shape).astype(np.float32)
    for tfn, jfn in ((tquant.round_ste, jquant.round_ste),
                     (tquant.quantize_coarse_ste, jquant.quantize_coarse_ste),
                     (tquant.binarize_ste, jquant.binarize_ste)):
        inp = x / 40 + 0.5 if tfn is tquant.binarize_ste else x
        yj, vjp = jax.vjp(jfn, jnp.asarray(inp))
        (gj,) = vjp(jnp.asarray(g))
        xt = _leaf(inp)
        yt = tfn(xt)
        yt.backward(torch.from_numpy(g))
        np.testing.assert_array_equal(yt.detach().numpy(), np.asarray(yj))
        np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(gj))
        np.testing.assert_array_equal(xt.grad.numpy(), g)  # straight through


def test_uniform_noise_is_uniform_seeded_and_straight_through():
    x = _leaf(np.linspace(-3, 3, 4000, dtype=np.float32).reshape(2, 2000))
    y = tquant.add_uniform_noise(x, torch.Generator().manual_seed(3), 0.5)
    again = tquant.add_uniform_noise(x, torch.Generator().manual_seed(3), 0.5)
    noise = (y - x).detach().numpy()
    assert torch.equal(y, again)
    assert noise.min() >= -0.5 and noise.max() < 0.5
    assert abs(noise.mean()) < 0.02 and abs(noise.var() - 1 / 12) < 0.01
    y.sum().backward()
    np.testing.assert_array_equal(x.grad.numpy(), np.ones(x.shape, np.float32))
    # JAX's counterpart is x + U(-h, h) with the same straight-through gradient
    gj = jax.grad(lambda v: jnp.sum(jquant.add_uniform_noise(v, jax.random.PRNGKey(0), 0.5)))(
        jnp.zeros((3,)))
    np.testing.assert_array_equal(np.asarray(gj), np.ones(3, np.float32))


# ---- K1 and K2 autograd Functions


@pytest.mark.parametrize("inverse", [False, True])
def test_gdn_function_gradients_match_jax_pallas(inverse):
    rng = np.random.default_rng(20 + inverse)
    ch = 32
    beta, gamma = _gdn_params(rng, ch)
    x = rng.standard_normal((2, 4, 8, ch)).astype(np.float32)
    g = rng.standard_normal(x.shape).astype(np.float32)

    def loss_j(x_, b_, g_):
        y = gdn_pallas(x_, jgdn.GDNParams(b_, g_), inverse=inverse, interpret=True)
        return jnp.sum(y * jnp.asarray(g))

    grads_j = jax.grad(loss_j, argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(beta),
                                                 jnp.asarray(gamma))
    xt, bt, gt = _leaf(x), _leaf(beta), _leaf(gamma)
    y = tgdn.gdn(xt, tgdn.GDNParams(bt, gt), inverse=inverse)
    assert type(y.grad_fn).__name__ == "_GDNBackward"  # the kernel's Function, on the CPU
    torch.sum(y * torch.from_numpy(g)).backward()
    for t, j, what in zip((xt, bt, gt), grads_j, ("x", "beta", "gamma")):
        _close_grad(t.grad.numpy(), j, what)
    # the gate: a parameter below its bound gets a gradient only where it
    # would push the value back up
    assert np.all((bt.grad.numpy()[:2] <= 0) | (np.asarray(grads_j[1])[:2] == 0))


STAGES = {  # x shape, kernel, stride/padding, gdn
    "conv1_9x9_s4_gdn": ((2, 16, 32, 3), 9, 4, True),
    "conv2_5x5_s2_gdn": ((2, 8, 16, 32), 5, 2, True),
    "conv3_5x5_s2": ((2, 8, 8, 32), 5, 2, False),
}


@pytest.mark.parametrize("stage", sorted(STAGES))
def test_conv_gdn_function_gradients_match_jax_pallas(stage):
    shape, k, s, gdn_on = STAGES[stage]
    cout = 32
    rng = np.random.default_rng(sorted(STAGES).index(stage) + 30)
    x = rng.standard_normal(shape).astype(np.float32) * 0.5
    w = (rng.standard_normal((k, k, shape[-1], cout)) / np.sqrt(k * k * shape[-1])).astype(
        np.float32)
    b = rng.standard_normal(cout).astype(np.float32) * 0.01 if gdn_on else None
    beta, gamma = _gdn_params(rng, cout)
    out_shape = (shape[0], shape[1] // s, shape[2] // s, cout)
    g = rng.standard_normal(out_shape).astype(np.float32)

    def loss_j(x_, w_, b_, beta_, gamma_):
        p = jgdn.GDNParams(beta_, gamma_) if gdn_on else None
        y = jk2.conv_gdn(x_, w_, b_, p, s, s, False, True)
        return jnp.sum(y * jnp.asarray(g))

    args = [jnp.asarray(a) for a in (x, w)] + [None if b is None else jnp.asarray(b),
                                               jnp.asarray(beta), jnp.asarray(gamma)]
    nums = (0, 1, 2, 3, 4) if gdn_on else (0, 1)
    grads_j = jax.grad(loss_j, argnums=nums)(*args)

    xt, wt, bt, betat, gammat = (None if a is None else _leaf(a) for a in (x, w, b, beta, gamma))
    if gdn_on:
        beff, geff = tgdn.gdn_reparam(tgdn.GDNParams(betat, gammat))
        gamma_t, beff = geff.t().contiguous(), beff
    else:
        gamma_t = beff = None
    before = tk2.conv_gdn.launches
    y = tk2.conv_gdn(xt, wt, bt, gamma_t, beff, s, s)
    assert tk2.conv_gdn.launches == before  # the plain forward on the CPU
    assert type(y.grad_fn).__name__ == "_ConvGDNBackward"
    torch.sum(y * torch.from_numpy(g)).backward()
    leaves = (xt, wt, bt, betat, gammat)[: len(nums)]
    for t, j, what in zip(leaves, grads_j, ("x", "w", "b", "beta", "gamma")):
        _close_grad(t.grad.numpy(), j, f"{stage} d{what}")


def test_analysis17_fused_gradients_match_jax():
    """The whole fused encoder: the gradient reaches the OIHW conv weights
    through the HWIO permute and the stored GDN parameters through reparam."""
    from iclr_17_compression_tpu.models.balle17 import Analysis17 as JAnalysis17
    from iclr_17_compression_tpu_torch.models.balle17 import Analysis17
    from iclr_17_compression_tpu_torch.ops.conv import oihw_to_hwio

    n = 32
    rng = np.random.default_rng(9)
    x = rng.uniform(0, 1, (2, 32, 32, 3)).astype(np.float32)
    model = Analysis17(n)
    for m in model.modules():
        if m is not model:
            m.init_(torch.Generator().manual_seed(1))
    enc = {name: {"weight": oihw_to_hwio(conv.weight.detach().numpy()).copy()}
           for name, conv in (("conv1", model.conv1), ("conv2", model.conv2),
                              ("conv3", model.conv3))}
    for i in (1, 2):
        enc[f"conv{i}"]["bias"] = getattr(model, f"conv{i}").bias.detach().numpy().copy()
        gd = getattr(model, f"gdn{i}")
        enc[f"gdn{i}"] = {"beta": gd.beta.detach().numpy().copy(),
                          "gamma": gd.gamma.detach().numpy().copy()}
    g = rng.standard_normal((2, 2, 2, n)).astype(np.float32)
    gj = jax.grad(lambda p: jnp.sum(jk2.analysis17_fused(p, jnp.asarray(x), interpret=True)
                                    * jnp.asarray(g)))(jax.tree_util.tree_map(jnp.asarray, enc))
    out = tk2.analysis17_fused(model, torch.from_numpy(x))
    torch.sum(out * torch.from_numpy(g)).backward()
    for i in (1, 2, 3):
        conv = getattr(model, f"conv{i}")
        _close_grad(oihw_to_hwio(conv.weight.grad.numpy()), gj[f"conv{i}"]["weight"], f"conv{i}")
        if i < 3:
            _close_grad(conv.bias.grad.numpy(), gj[f"conv{i}"]["bias"], f"conv{i} bias")
            gd = getattr(model, f"gdn{i}")
            _close_grad(gd.beta.grad.numpy(), gj[f"gdn{i}"]["beta"], f"gdn{i} beta")
            _close_grad(gd.gamma.grad.numpy(), gj[f"gdn{i}"]["gamma"], f"gdn{i} gamma")
    JAnalysis17(n)  # the module the JAX function mirrors exists under that name


# ---- SSIM and MS-SSIM


def _pair(rng, hw, anti=False):
    a = rng.uniform(0, 1, (2, hw, hw, 3)).astype(np.float32)
    if anti:
        return a, (1.0 - a).astype(np.float32)
    b = np.clip(a + 0.1 * rng.standard_normal(a.shape), 0, 1).astype(np.float32)
    return a, b


@pytest.mark.parametrize("hw,win", [(176, 11), (64, 7)])
def test_ssim_and_ms_ssim_values_match_jax(hw, win):
    a, b = _pair(np.random.default_rng(hw), hw)
    ja, jb, ta, tb = jnp.asarray(a), jnp.asarray(b), torch.from_numpy(a), torch.from_numpy(b)
    s_j, cs_j = jmetrics.ssim(ja, jb, win_size=win, full=True)
    s_t, cs_t = tmetrics.ssim(ta, tb, win_size=win, full=True)
    np.testing.assert_allclose(float(s_t), float(s_j), rtol=RTOL)
    np.testing.assert_allclose(float(cs_t), float(cs_j), rtol=RTOL)
    np.testing.assert_allclose(float(tmetrics.ssim(ta, tb, win_size=win)), float(s_j), rtol=RTOL)
    ms_j = float(jmetrics.ms_ssim(ja, jb, win_size=win))
    ms_t = tmetrics.ms_ssim(ta, tb, win_size=win)
    np.testing.assert_allclose(float(ms_t), ms_j, rtol=RTOL)
    np.testing.assert_allclose(float(tmetrics.ms_ssim_db(ms_t)),
                               float(jmetrics.ms_ssim_db(jnp.float32(ms_j))), rtol=RTOL)


@pytest.mark.parametrize("hw,win,anti", [(176, 11, False), (64, 7, False), (64, 7, True)])
def test_ms_ssim_loss_gradient_matches_jax(hw, win, anti):
    """The gradient of 1 - MS-SSIM (the msssim distortion); an anti-correlated
    pair drives cs below 0, where the clamped power must give a finite,
    zero gradient rather than NaN."""
    a, b = _pair(np.random.default_rng(hw + 1), hw, anti)
    gj = np.asarray(jax.grad(lambda v: 1.0 - jmetrics.ms_ssim(v, jnp.asarray(b), win_size=win))(
        jnp.asarray(a)))
    at = _leaf(a)
    (1.0 - tmetrics.ms_ssim(at, torch.from_numpy(b), win_size=win)).backward()
    assert np.isfinite(at.grad.numpy()).all()
    _close_grad(at.grad.numpy(), gj, atol=MSSSIM_GRAD_ATOL)
    if anti:
        with torch.no_grad():
            assert float(tmetrics.ms_ssim(at, torch.from_numpy(b), win_size=win)) == 0.0
