"""Port parity: the Ballé-17 eval forward (the slice as a whole) against the
JAX model, at N=16 with random weights and at N=128 with the archived lam2048
weights, on 64×64 images.

Tolerances: latents may differ where round() meets an encoder output within
float error of k+0.5, at most 0.1% of elements and by 1; given the same
latent the decoder agrees to atol 1e-4 and the rate to rtol 1e-4 (fp32 on
both sides, sums in another order).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iclr_17_compression_tpu.models.balle17 import Balle17Compressor as JBalle17
from iclr_17_compression_tpu.models.balle17 import Synthesis17 as JSynthesis17
from iclr_17_compression_tpu.models.cheng2020 import _bit_estimator_params
from iclr_17_compression_tpu.ops.entropy import estimate_bits as jestimate_bits
from iclr_17_compression_tpu_torch.models.balle17 import Balle17Compressor
from iclr_17_compression_tpu_torch.ops.entropy import estimate_bits
from iclr_17_compression_tpu_torch.train.weights import params_from_jax, read_checkpoint

CKPT = os.path.join(os.path.dirname(__file__), "..", "results", "ckpts",
                    "lam2048_iter_19000.ckpt")
LATENT_FLIP_FRAC = 1e-3
DECODER_ATOL = 1e-4
RATE_RTOL = 1e-4


def _image(seed, h=64, w=64):
    """Smooth colour waves plus mild texture, in [0, 1]."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.full((h, w, 3), 0.5, np.float32)
    for _ in range(4):
        f = rng.uniform(-3, 3, 2) / np.array([h, w])
        img += rng.uniform(0.05, 0.15, 3).astype(np.float32) * np.cos(
            2 * np.pi * (f[0] * yy + f[1] * xx) + rng.uniform(0, 6))[..., None]
    img += 0.03 * rng.standard_normal((h, w, 3)).astype(np.float32)
    return np.clip(img, 0, 1)[None]


def _port_model(tree):
    n = np.shape(tree["encoder"]["conv1"]["weight"])[-1]
    model = Balle17Compressor(n)
    model.load_state_dict(params_from_jax(tree), strict=True)
    return model.eval()


def _check_forward(tree, x):
    n = np.shape(tree["encoder"]["conv1"]["weight"])[-1]
    jparams = {"params": jax.tree_util.tree_map(jnp.asarray, tree)}
    jout = JBalle17(out_channel_n=n).apply(jparams, jnp.asarray(x), train=False)
    model = _port_model(tree)
    with torch.no_grad():
        out = model(torch.from_numpy(x))
        lat = out["latent"]
        flips = np.abs(lat.numpy() - np.asarray(jout["latent"]))
        assert flips.max() <= 1 and (flips > 0).mean() <= LATENT_FLIP_FRAC

        # decoder and rate given the same latent
        jrecon = np.asarray(JSynthesis17(n).apply(
            {"params": jparams["params"]["decoder"]}, jnp.asarray(lat.numpy())))
        recon = model.Decoder(lat)
        np.testing.assert_allclose(recon.numpy(), jrecon, rtol=0, atol=DECODER_ATOL)
        jbits, _ = jestimate_bits(jnp.asarray(lat.numpy()),
                                  _bit_estimator_params(jparams, "bit_estimator"))
        bits, _ = estimate_bits(lat, model.bitEstimator.params())
        np.testing.assert_allclose(float(bits), float(jbits), rtol=RATE_RTOL)

        # the forward's outputs are those of its parts
        np.testing.assert_array_equal(out["recon"].numpy(), torch.clamp(recon, 0, 1).numpy())
        assert float(out["bpp"]) == pytest.approx(float(bits) / (x.shape[1] * x.shape[2]),
                                                  rel=1e-6)
        np.testing.assert_allclose(float(out["mse"]),
                                   float(torch.mean((recon - torch.from_numpy(x)) ** 2)),
                                   rtol=1e-6)
    if (flips == 0).all():
        np.testing.assert_allclose(out["recon"].numpy(), np.asarray(jout["recon"]),
                                   rtol=0, atol=DECODER_ATOL)
        np.testing.assert_allclose(float(out["bpp"]), float(jout["bpp"]), rtol=RATE_RTOL)
        np.testing.assert_allclose(float(out["mse"]), float(jout["mse"]), rtol=1e-4)
    return out


def test_balle17_eval_n16_random_weights():
    x = _image(0)
    variables = JBalle17(out_channel_n=16).init(
        {"params": jax.random.PRNGKey(0), "quant": jax.random.PRNGKey(1)},
        jnp.asarray(x), train=False)
    tree = jax.tree_util.tree_map(np.array, variables["params"])
    _check_forward(tree, x)


def test_balle17_eval_n128_lam2048_weights():
    out = _check_forward(read_checkpoint(CKPT), _image(1))
    assert out["latent"].shape == (1, 4, 4, 128)
    assert np.isfinite(out["recon"].numpy()).all()
