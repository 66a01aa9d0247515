"""Port parity: blocked image I/O (space-to-depth at the data layer) and the
space-to-depth conv lowering, against the JAX package.

The same numpy-seeded inputs go through the JAX functions and the port's.
The layout functions are pure reshapes and pads, so they are held bit-equal.
The blocked graph against the strided one, and the port's Ballé-17
``io_block=4`` model against JAX's, are held at the JAX blocked-I/O test's
own bounds: recon and latent rtol 1e-5 / atol 1e-5, mse and bpp rtol 1e-5
(fp32 on both sides, sums in another order); one train step: rd_loss rtol
1e-5, the canonical conv1 and deconv3 weights after the Adam update rtol
1e-4 / atol 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iclr_17_compression_tpu.models.balle17 import Balle17Compressor as JBalle17
from iclr_17_compression_tpu.ops import conv as jconv
from iclr_17_compression_tpu.train.state import create_train_state as jcreate_train_state
from iclr_17_compression_tpu.train.state import make_balle17_train_step as jmake_step
from iclr_17_compression_tpu_torch.models.balle17 import Analysis17, Balle17Compressor
from iclr_17_compression_tpu_torch.nn.layers import TorchConv, TorchConvTranspose
from iclr_17_compression_tpu_torch.ops import conv as tconv
from iclr_17_compression_tpu_torch.ops.kernels import conv_gdn_kernel as tk2
from iclr_17_compression_tpu_torch.train.state import create_train_state, make_balle17_train_step
from iclr_17_compression_tpu_torch.train.weights import params_from_jax, params_to_jax

RTOL, ATOL = 1e-5, 1e-5
W_RTOL, W_ATOL = 1e-4, 1e-6


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("layout", ["numpy", "torch"])
def test_space_to_depth_matches_jax_and_round_trips(layout):
    x = np.random.default_rng(0).standard_normal((2, 16, 24, 3)).astype(np.float32)
    ref = np.asarray(jconv.space_to_depth(jnp.asarray(x), 4))
    xb = tconv.space_to_depth(x if layout == "numpy" else _t(x), 4)
    xb = np.asarray(xb) if layout == "numpy" else xb.numpy()
    assert xb.shape == (2, 4, 6, 48)
    np.testing.assert_array_equal(xb, ref)
    back = tconv.depth_to_space(xb if layout == "numpy" else _t(xb), 4)
    np.testing.assert_array_equal(np.asarray(back), x)
    np.testing.assert_array_equal(np.asarray(back),
                                  np.asarray(jconv.depth_to_space(jnp.asarray(ref), 4)))


@pytest.mark.parametrize("which", ["conv", "deconv"])
def test_block_weights_bit_equal_jax(which):
    rng = np.random.default_rng(1)
    cin, cout = (3, 8) if which == "conv" else (8, 3)
    w = rng.standard_normal((9, 9, cin, cout)).astype(np.float32)
    jfn = jconv.block_conv_weight if which == "conv" else jconv.block_deconv_weight
    tfn = tconv.block_conv_weight if which == "conv" else tconv.block_deconv_weight
    ref = np.asarray(jfn(jnp.asarray(w), 4))
    got = tfn(_t(w), 4).numpy()
    assert got.shape == ref.shape == ((3, 3, 48, 8) if which == "conv" else (3, 3, 8, 48))
    np.testing.assert_array_equal(got, ref)
    with pytest.raises(ValueError):
        tfn(_t(w[:5, :5]), 4)


@pytest.mark.parametrize("which", ["conv", "deconv"])
def test_blocked_convs_match_strided(which):
    """The port's blocked conv (deconv) equals its strided one and the JAX
    blocked one, through the ``TorchConv(input_block)`` /
    ``TorchConvTranspose(output_block)`` modules, whose parameters keep the
    canonical shapes."""
    rng = np.random.default_rng(2)
    if which == "conv":
        x = rng.standard_normal((2, 32, 48, 3)).astype(np.float32)
        w = rng.standard_normal((9, 9, 3, 8)).astype(np.float32)
        b = rng.standard_normal(8).astype(np.float32)
        jref = np.asarray(jconv.conv2d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                                       stride=4, padding=4))
        strided = TorchConv(3, 8, 9, stride=4, padding=4)
        blocked = TorchConv(3, 8, 9, stride=4, padding=4, input_block=4)
        weight = tconv.hwio_to_oihw(w)
        xin, xbin = _t(x), _t(jconv.space_to_depth(x, 4))
    else:
        x = rng.standard_normal((2, 8, 12, 8)).astype(np.float32)
        w = rng.standard_normal((9, 9, 8, 3)).astype(np.float32)
        b = rng.standard_normal(3).astype(np.float32)
        jref = np.asarray(jconv.conv_transpose2d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                                                 stride=4, padding=4, output_padding=3))
        strided = TorchConvTranspose(8, 3, 9, stride=4, padding=4, output_padding=3)
        blocked = TorchConvTranspose(8, 3, 9, stride=4, padding=4, output_padding=3,
                                     output_block=4)
        weight = tconv.deconv_hwio_to_torch(w)
        xin = xbin = _t(x)
    for mod in (strided, blocked):
        mod.load_state_dict({"weight": _t(weight), "bias": _t(b)})
    assert blocked.state_dict()["weight"].shape == strided.state_dict()["weight"].shape
    with torch.no_grad():
        ref = strided(xin).numpy()
        got = blocked(xbin).numpy()
    if which == "deconv":
        got = tconv.depth_to_space(got, 4)
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, jref, rtol=RTOL, atol=ATOL)


def test_blocked_modules_refuse_other_shapes():
    with pytest.raises(ValueError):
        TorchConv(3, 8, 5, stride=2, padding=2, input_block=4)
    with pytest.raises(ValueError):
        TorchConvTranspose(8, 3, 9, stride=4, padding=4, output_padding=0, output_block=4)


def _jax_model_and_params(n, x, **kw):
    model = JBalle17(out_channel_n=n, **kw)
    key = jax.random.PRNGKey(0)
    params = model.init({"params": key, "quant": key}, jnp.asarray(x), train=False)
    return model, params


def test_balle17_io_block_forward_matches_jax():
    """The port's ``Balle17Compressor(io_block=4)`` against JAX's on the same
    params and blocked images, and against the port's unblocked graph."""
    x = np.random.default_rng(3).uniform(0.0, 1.0, (2, 64, 64, 3)).astype(np.float32)
    xb = np.asarray(jconv.space_to_depth(x, 4))
    jmodel, jparams = _jax_model_and_params(8, xb, io_block=4)
    jout = jmodel.apply(jparams, jnp.asarray(xb), train=False)
    model = Balle17Compressor(8, io_block=4)
    model.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                                 jparams["params"])))
    plain = Balle17Compressor(8)
    plain.load_state_dict(model.state_dict())
    with torch.no_grad():
        out = model(_t(xb))
        ref = plain(_t(x))
    for key in ("recon", "latent"):
        np.testing.assert_allclose(out[key].numpy(), np.asarray(jout[key]), rtol=RTOL,
                                   atol=ATOL, err_msg=key)
    for key in ("mse", "bpp"):
        np.testing.assert_allclose(float(out[key]), float(jout[key]), rtol=RTOL, err_msg=key)
    np.testing.assert_array_equal(out["latent"].numpy(), ref["latent"].numpy())
    np.testing.assert_allclose(tconv.depth_to_space(out["recon"], 4).numpy(),
                               ref["recon"].numpy(), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(float(out["bpp"]), float(ref["bpp"]), rtol=RTOL)


def test_balle17_io_block_train_step_matches_jax():
    """One train step of the blocked graph against JAX's
    ``make_balle17_train_step`` on the blocked graph (quant ``ste``, which
    draws no noise, so both sides see the same latent): the gradient reaches
    the canonical (N, 3, 9, 9) conv1 weight through ``block_conv_weight``,
    and the deconv3 weight through ``block_deconv_weight``."""
    x = np.random.default_rng(4).uniform(0.0, 1.0, (2, 64, 64, 3)).astype(np.float32)
    xb = np.asarray(jconv.space_to_depth(x, 4))
    jmodel = JBalle17(out_channel_n=8, quant="ste", io_block=4)
    key = jax.random.PRNGKey(7)
    jstate = jcreate_train_state(jmodel, key, (jnp.asarray(xb),), lr=1e-3)
    model = Balle17Compressor(8, quant="ste", io_block=4)
    model.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, jstate.params)))
    jstate, jmetrics = jax.jit(jmake_step(1024.0))(jstate, jnp.asarray(xb), key)
    state = create_train_state(model, lr=1e-3)
    metrics = make_balle17_train_step(1024.0)(state, _t(xb), None)

    np.testing.assert_allclose(float(metrics["rd_loss"]), float(jmetrics["rd_loss"]), rtol=RTOL)
    assert model.Encoder.conv1.weight.shape == (8, 3, 9, 9)
    got = params_to_jax(model.state_dict())
    for part, layer in (("encoder", "conv1"), ("decoder", "deconv3")):
        np.testing.assert_allclose(got[part][layer]["weight"],
                                   np.asarray(jstate.params[part][layer]["weight"]),
                                   rtol=W_RTOL, atol=W_ATOL, err_msg=layer)


def test_blocked_conv1_through_k2_function_reaches_canonical_weight():
    """``analysis17_fused`` on a blocked encoder (conv1 as a 3×3 stride-1
    ``conv_gdn`` over 48 channels, the K2 call on the card) equals the
    module's forward, and its gradient reaches the canonical OIHW conv1
    weight and the GDN parameters as the plain graph's does."""
    rng = np.random.default_rng(5)
    enc = Analysis17(8, input_block=4)
    gen = torch.Generator().manual_seed(3)
    for m in enc.modules():
        if hasattr(m, "init_") and m is not enc:
            m.init_(gen)
    xb = _t(jconv.space_to_depth(rng.uniform(0, 1, (1, 32, 48, 3)).astype(np.float32), 4))
    g = _t(rng.standard_normal((1, 2, 3, 8)).astype(np.float32))
    grads = []
    for fused in (False, True):
        enc.zero_grad()
        y = tk2.analysis17_fused(enc, xb) if fused else enc(xb)
        (y * g).sum().backward()
        grads.append((y.detach(), enc.conv1.weight.grad.clone(), enc.gdn1.gamma.grad.clone()))
    for (a, b) in zip(*grads):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-4, atol=1e-6)
    assert grads[1][1].shape == (8, 3, 9, 9) and float(grads[1][1].abs().max()) > 0


@pytest.mark.parametrize("shape", [((1, 32, 48, 3), 9, 4, 4), ((2, 18, 22, 4), 5, 2, 2),
                                   ((1, 17, 21, 3), 3, 2, 1)])
def test_conv_s2d_matches_jax(shape, monkeypatch):
    """``conv2d`` under ``ICLR17C_S2D=1`` runs a small-Cin strided conv as
    ``conv_s2d``, equal to the JAX ``_conv_s2d`` and to the direct conv."""
    (n, h, w, cin), k, s, p = shape
    rng = np.random.default_rng(6)
    x = rng.standard_normal((n, h, w, cin)).astype(np.float32)
    wt = rng.standard_normal((k, k, cin, 8)).astype(np.float32) / k
    b = rng.standard_normal(8).astype(np.float32)
    jref = np.asarray(jconv._conv_s2d(jnp.asarray(x), jnp.asarray(wt), (s, s), (p, p),
                                      jax.lax.Precision.HIGHEST)) + b
    direct = tconv.conv2d(_t(x), _t(tconv.hwio_to_oihw(wt)), _t(b), stride=s, padding=p)
    calls = []
    real = tconv.conv_s2d
    monkeypatch.setattr(tconv, "conv_s2d", lambda *a: calls.append(1) or real(*a))
    monkeypatch.setenv("ICLR17C_S2D", "1")
    got = tconv.conv2d(_t(x), _t(tconv.hwio_to_oihw(wt)), _t(b), stride=s, padding=p)
    assert calls == [1]
    np.testing.assert_allclose(got.numpy(), jref, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got.numpy(), direct.numpy(), rtol=RTOL, atol=ATOL)
