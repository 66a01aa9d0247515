"""Port parity of the DSC split train step against the JAX package's
``shard_train_step`` and the port's one-device step: the ``tiny`` preset
(the flagship's topology at n = 16; batch 8, 64×128 pairs) on 4×2 and 2×1
with its MSE loss, and on 4×2 with the flagship's MS-SSIM loss, whose
one-device tolerance is witnessed against the exact (fp64) step.
Harness and stated tolerances: ``test_torch_mesh_train.py``.
"""

import jax
import numpy as np
import pytest
import torch

from iclr_17_compression_tpu.models.dsc import DSCStereoModel as JDSC
from iclr_17_compression_tpu.train import state as jstate
from iclr_17_compression_tpu_torch.parallel import make_mesh
from iclr_17_compression_tpu_torch.train.mesh_step import shard_train_step
from iclr_17_compression_tpu_torch.train.state import create_train_state, make_dsc_train_step
from iclr_17_compression_tpu_torch.train.weights import dsc_params_to_jax
from test_torch_dsc_train import _jax_cfg, _jtree
from test_torch_dsc_train import _model as dsc_model
from test_torch_hyperprior import image
from test_torch_mesh_train import (B, H, LR, MSSSIM_ONE_DEVICE_TOL, W, _check_split,
                                   _fp64_grads, _hold_against_one_device,
                                   _hold_within_fp32_error, _jax_noise, _jax_split_step,
                                   _one_device, _run)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the test workers do not oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _pairs(seed, b=B, h=H, w=W):
    """Smooth stereo-like pairs: (im1, im2), each (b, h, w, 3)."""
    im1 = np.stack([image(seed + i, h, w) for i in range(b)])
    rng = np.random.default_rng(seed)
    im2 = np.clip(np.roll(im1, 4, axis=2) + 0.03 * rng.standard_normal(im1.shape), 0, 1)
    return im1, im2.astype(np.float32)


@pytest.mark.parametrize("n_data,n_tile,loss", [
    pytest.param(4, 2, None, id="4-2"), pytest.param(2, 1, None, id="2-1"),
    pytest.param(4, 2, "msssim", id="4-2-msssim")])
def test_dsc_split_step_matches_jax(n_data, n_tile, loss, monkeypatch):
    model = dsc_model("tiny", loss=loss)
    cfg, jcfg = model.config, _jax_cfg(model)
    jparams, jmodel = _jtree(model), JDSC(jcfg)
    im1, im2 = _pairs(20)
    key = jax.random.PRNGKey(101)
    draws = _jax_noise(jmodel, jparams, key, _dsc_draws(cfg), split=3)
    jax_ref = _jax_split_step(jmodel, jparams, jstate.make_dsc_train_step(), n_data, n_tile,
                              [im1, im2], key)
    _check_split(model, make_dsc_train_step, n_data, n_tile, [im1, im2], draws, jax_ref,
                 lambda sd: dsc_params_to_jax(sd, cfg), monkeypatch, n_batch_args=2,
                 msssim=cfg.loss == "msssim")


def _dsc_draws(cfg):
    code = (B, H // cfg.code_div, W // cfg.code_div, cfg.code_channels)
    z = (B, H // cfg.latent_div, W // cfg.latent_div, cfg.n)
    return [(code, cfg.coarse_noise), (z, cfg.fine_noise), (z, cfg.fine_noise)]


def test_dsc_msssim_split_step_matches_one_device(monkeypatch):
    """The flagship's loss (MS-SSIM of the recon, and of the base branch's
    im2 recon) pooled from per-level sums over a 4×2 mesh, against the
    one-device step at two steps, and at step 1 both against the exact
    (fp64) step (``_hold_within_fp32_error``), on other pairs and noise
    than the JAX case's."""
    model = dsc_model("tiny", loss="msssim")
    im1, im2 = _pairs(21)
    rng = np.random.default_rng(3)
    draws = [rng.uniform(-h, h, s).astype(np.float32) for s, h in _dsc_draws(model.config)]
    exact = _fp64_grads(model, make_dsc_train_step, [im1, im2], draws, monkeypatch)
    state = create_train_state(model, lr=LR)
    split = shard_train_step(make_dsc_train_step(), make_mesh(4, 2, ["cpu"] * 8), 2)
    for i in (1, 2):
        want = _one_device(model, state, make_dsc_train_step, [im1, im2], draws, monkeypatch)
        got = _run(split, state, [im1, im2], draws, monkeypatch)
        _hold_against_one_device(got, want, i, MSSSIM_ONE_DEVICE_TOL)
        if i == 1:
            _hold_within_fp32_error(got[1], want[1], exact)
