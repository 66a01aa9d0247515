"""Port parity of the DSC split train step against the JAX package's
``shard_train_step`` and the port's one-device step: the ``tiny`` preset
(the flagship's topology at n = 16; batch 8, 64×128 pairs) on 4×2 and 2×1
with its MSE loss, and on 4×2 with the flagship's MS-SSIM loss, whose
one-device tolerance is witnessed against the exact (fp64) step; the
fusion presets with the bottleneck and patch-match attention and PAM at
n = 16 on 2×2, FIF refused.
Harness and stated tolerances: ``test_torch_mesh_train.py``.
"""

import dataclasses
import os
import subprocess
import sys

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
from test_torch_mesh_train import (B, H, LR, MSSSIM_ONE_DEVICE_TOL, TINY_TENSOR, W,
                                   _check_split, _flat, _fp64_grads, _hold_against_one_device,
                                   _hold_within_fp32_error, _jax_noise, _jax_split_step,
                                   _one_device, _run)
from test_torch_tiled import small_fusion


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


def _dsc_draws(cfg, b=B, h=H, w=W):
    code = (b, h // cfg.code_div, w // cfg.code_div, cfg.code_channels)
    z = (b, h // cfg.latent_div, w // cfg.latent_div, cfg.n)
    return [(code, cfg.coarse_noise), (z, cfg.fine_noise), (z, cfg.fine_noise)]


@pytest.mark.parametrize("preset", ["att_0031bpp", "bottleneck_att_1bpp", "pam_0031bpp"])
def test_fusion_presets_tiled_split_step_matches_jax(preset, monkeypatch, tmp_path):
    """The fusion presets over a 2×2 mesh, at n = 16 (``small_fusion``)
    with their own L1 loss: the bottleneck and patch-match attention and
    PAM run on each data row's gathered W-tiles at its tile-0 replica
    (``TileRun.whole``), against JAX's split step and the one-device step
    (PAM's key bias gradient, zero but for rounding, under the joint's
    ``TINY_TENSOR`` floor). The patch-match preset at 160×320 (batch 2;
    the others batch 8 at 64×128, as the tiny preset's cases): at 64×128
    its latent is
    smaller than one 9×9 patch, and XLA's partitioner aborts the process
    on JAX's 1×2 step there (ROADMAP Queue 3). On these pairs fp32 alone
    moves its one-device gradients up to 0.48 of a tensor's largest from
    the fp64 step (the port's; JAX's 3.7e-3): its gradients are held in
    fp64, the split step's against the one-device step's and against
    JAX's split step run in JAX's x64 mode (``_jax_fp64_grads``; 3.9e-6
    apart), its losses in fp32 against JAX's and the one-device step's."""
    model, jmodel, jparams, batches, key, draws = _fusion_case(preset)
    cfg = model.config
    jax_ref = _jax_split_step(jmodel, jparams, jstate.make_dsc_train_step(), 2, 2, batches, key)
    jax_fp64 = (_jax_fp64_grads(preset, jparams, batches, draws, tmp_path)
                if cfg.fusion_post == "patch_att" else None)
    _check_split(model, make_dsc_train_step, 2, 2, batches, draws, jax_ref,
                 lambda sd: dsc_params_to_jax(sd, cfg), monkeypatch, n_batch_args=2,
                 floor_share=TINY_TENSOR, tiled_sums=True, jax_fp64=jax_fp64)


def _fusion_case(preset):
    """A fusion preset's case: (model, JAX model, JAX params, [im1, im2],
    the step's key, JAX's noise draws)."""
    model = small_fusion(preset)[0].train()
    cfg = model.config
    jparams, jmodel = _jtree(model), JDSC(_jax_cfg_of(cfg))
    b, h, w = (2, 160, 320) if cfg.fusion_post == "patch_att" else (B, H, W)
    key = jax.random.PRNGKey(104)
    draws = _jax_noise(jmodel, jparams, key, _dsc_draws(cfg, b, h, w), split=3)
    return model, jmodel, jparams, list(_pairs(22, b, h, w)), key, draws


def _jax_fp64_grads(preset, jparams, batches, draws, tmp_path):
    """JAX's 2×2 split step of ``preset``'s case in fp64: run in a process
    of its own in JAX's x64 mode (``_jax_fp64_child``; this process keeps
    fp32), on the same parameters, pairs and noise. Its clamped
    gradients."""
    case, out = tmp_path / "case.npz", tmp_path / "grads.npz"
    np.savez(case, **{f"param:{k}": v for k, v in _flat(jparams).items()},
             **{f"batch:{i}": b for i, b in enumerate(batches)},
             **{f"draw:{i}": d for i, d in enumerate(draws)})
    tests = os.path.dirname(os.path.abspath(__file__))
    env = {**os.environ, "JAX_ENABLE_X64": "1", "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=8",
           "PYTHONPATH": os.pathsep.join([os.path.dirname(tests), tests])}
    subprocess.run([sys.executable, "-c", "import sys, test_torch_mesh_dsc as t; "
                    "t._jax_fp64_child(*sys.argv[1:])", preset, str(case), str(out)],
                   env=env, cwd=tests, check=True, timeout=600)
    return dict(np.load(out))


def _jax_fp64_child(preset, case, out):
    """``_jax_fp64_grads``'s process: JAX's split step in fp64, its noise
    handed to the model's ``add_uniform_noise`` in the model's order."""
    import jax.numpy as jnp
    from flax import traverse_util

    import iclr_17_compression_tpu.models.dsc as jdsc

    assert jax.config.jax_enable_x64
    data = np.load(case)
    params = traverse_util.unflatten_dict(
        {tuple(k[len("param:"):].split("/")): jnp.asarray(data[k], jnp.float64)
         for k in data.files if k.startswith("param:")})
    batches = [data[f"batch:{i}"].astype(np.float64) for i in range(2)]
    queue = [jnp.asarray(data[f"draw:{i}"], jnp.float64) for i in range(3)]
    jdsc.add_uniform_noise = lambda x, rng, half_width: x + queue.pop(0)
    jmodel = JDSC(_jax_cfg_of(small_fusion(preset)[0].config))
    _, grads, _ = _jax_split_step(jmodel, params, jstate.make_dsc_train_step(), 2, 2, batches,
                                  jax.random.PRNGKey(0))
    assert not queue
    np.savez(out, **grads)


def _jax_cfg_of(cfg):
    """The JAX package's config of the port's ``cfg`` (its preset at the
    port config's widths)."""
    from iclr_17_compression_tpu.models import DSC_PRESETS as JAX_PRESETS

    return dataclasses.replace(JAX_PRESETS[cfg.name], **{
        f: getattr(cfg, f) for f in ("n", "ga", "gs", "gz", "ga22", "gs22", "loss")})


def test_fif_split_step_is_refused():
    """FIF's batch statistics are the whole batch's: the split step refuses
    the preset as the training CLI does (ROADMAP Queue 3: the JAX trainer
    cannot train it)."""
    model = small_fusion("fif_0031bpp")[0]
    im1, im2 = _pairs(23, 4)
    split = shard_train_step(make_dsc_train_step(), make_mesh(1, 2, ["cpu"] * 2), 2)
    with pytest.raises(NotImplementedError, match="Queue 3"):
        split(create_train_state(model, lr=LR), im1, im2, None)


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
