"""Port parity of the Ballé-17 train step, its schedules, meters and config
against the JAX package.

The train step: N=32, batch 2, 64×64 crops, λ 8192, lr 1e-4, the port's
initial weights carried into the JAX model; for each quantizer and
distortion, three steps, each compared with the JAX loss (explicit ``rng``)
and ``_make_optimizer`` (clip 5 then Adam). The JAX noise of each step
(``jax.random.uniform`` of the step's key, as ``add_uniform_noise`` draws
it) is handed to the port. Tolerances, fp32 on both sides with sums in
another order: the loss to rtol 1e-4, the clamped gradients to 1e-4 of each
tensor's largest gradient (MS-SSIM's ratios carry the error further), the
parameters to 5% of one LR step where the gradient is decided. Adam's first
updates are about lr·sign(g), so an element whose gradient is near 0 (below
1e-3 of the tensor's largest, at any of the steps) may move by 2·lr between
the frameworks: those elements are held by their gradient only.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from iclr_17_compression_tpu.models.balle17 import Balle17Compressor as JBalle17
from iclr_17_compression_tpu.ops.metrics import ms_ssim as jms_ssim
from iclr_17_compression_tpu.train import config as jconfig
from iclr_17_compression_tpu.train import meters as jmeters
from iclr_17_compression_tpu.train import schedules as jschedules
from iclr_17_compression_tpu.train.state import _make_optimizer
from iclr_17_compression_tpu_torch.models.balle17 import Balle17Compressor
from iclr_17_compression_tpu_torch.ops import quant as tquant
from iclr_17_compression_tpu_torch.train import config as tconfig
from iclr_17_compression_tpu_torch.train import meters as tmeters
from iclr_17_compression_tpu_torch.train import schedules as tschedules
from iclr_17_compression_tpu_torch.train.state import create_train_state, make_balle17_train_step
from iclr_17_compression_tpu_torch.train.weights import params_to_jax

ROOT = os.path.join(os.path.dirname(__file__), "..")
N, HW, B, LAM, LR = 32, 64, 2, 8192.0, 1e-4
LOSS_RTOL = 1e-4
GRAD_TOL = 1e-4  # of the tensor's largest |gradient|
PARAM_ATOL = 0.05 * LR
DECIDED = 1e-3  # |g| above this fraction of the tensor's largest: a decided sign


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


@pytest.mark.parametrize("distortion", ["mse", "msssim"])
@pytest.mark.parametrize("quant", ["noise-round", "ste", "binarize"])
def test_train_steps_match_jax(quant, distortion, monkeypatch):
    rng = np.random.default_rng(["noise-round", "ste", "binarize"].index(quant))
    batches = [rng.uniform(0, 1, (B, HW, HW, 3)).astype(np.float32) for _ in range(3)]
    model = Balle17Compressor(N, quant).init_(torch.Generator().manual_seed(5))
    jparams = jax.tree_util.tree_map(jnp.asarray, params_to_jax(model.state_dict()))
    jmodel = JBalle17(out_channel_n=N, quant=quant)
    tx = _make_optimizer(LR)
    opt_state = tx.init(jparams)

    def jloss(params, batch, key):
        out = jmodel.apply({"params": params}, batch, train=True, rng=key)
        d = 1.0 - jms_ssim(out["recon"], batch, win_size=7) if distortion == "msssim" \
            else out["mse"]
        return LAM * d + out["bpp"], out

    grad_fn = jax.value_and_grad(jloss, has_aux=True)
    noises = []
    monkeypatch.setattr(tquant, "add_uniform_noise",
                        lambda x, generator, half_width: x + torch.from_numpy(noises.pop()))
    state = create_train_state(model, lr=LR)
    step = make_balle17_train_step(LAM, distortion)
    undecided = {}
    for i, batch in enumerate(batches):
        key = jax.random.PRNGKey(100 + i)
        if quant == "noise-round":
            noises.append(np.asarray(jax.random.uniform(
                key, (B, HW // 16, HW // 16, N), jnp.float32, -0.5, 0.5)))
        (loss_j, out_j), grads_j = grad_fn(jparams, jnp.asarray(batch), key)
        updates, opt_state = tx.update(grads_j, opt_state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        metrics = step(state, torch.from_numpy(batch), None)
        assert not noises and state.step == i + 1

        np.testing.assert_allclose(float(metrics["rd_loss"]), float(loss_j), rtol=LOSS_RTOL)
        np.testing.assert_allclose(float(metrics["bpp"]), float(out_j["bpp"]), rtol=LOSS_RTOL)
        np.testing.assert_allclose(float(metrics["mse"]), float(out_j["mse"]), rtol=LOSS_RTOL)
        np.testing.assert_allclose(float(metrics["psnr"]),
                                   10 * np.log10(1 / max(float(out_j["mse"]), 1e-10)),
                                   rtol=LOSS_RTOL)
        grads_t = _flat(params_to_jax({
            k: (p.grad if p.grad is not None else torch.zeros_like(p))
            for k, p in model.named_parameters()}))
        params_t = _flat(params_to_jax(model.state_dict()))
        params_j = _flat(jparams)
        for k, gj in _flat(grads_j).items():
            gj = np.clip(gj, -5.0, 5.0)  # the port's grads are clamped in place
            top = max(float(np.abs(gj).max()), 1e-30)
            np.testing.assert_allclose(grads_t[k], gj, rtol=0, atol=GRAD_TOL * top,
                                       err_msg=f"step {i + 1} d{k}")
            undecided[k] = undecided.get(k, False) | (np.abs(gj) <= DECIDED * top)
            decided = ~undecided[k]
            np.testing.assert_allclose(params_t[k][decided], params_j[k][decided], rtol=0,
                                       atol=PARAM_ATOL, err_msg=f"step {i + 1} {k}")
    # the comparison held most of every trained tensor by its value
    assert np.mean([np.mean(~u) for u in undecided.values()]) > 0.5


def test_train_step_rejects_a_bad_distortion():
    with pytest.raises(ValueError, match="mse"):
        make_balle17_train_step(LAM, "ms_ssim")


def test_train_step_msssim_window():
    from iclr_17_compression_tpu_torch.train.state import msssim_window

    assert msssim_window(torch.zeros(1, 176, 200, 3)) == 11
    assert msssim_window(torch.zeros(1, 175, 400, 3)) == 7


@pytest.mark.parametrize("warmup", [0, 5])
def test_step_decay_schedule_matches_jax(warmup):
    js = jschedules.step_decay_schedule(1e-4, 0.1, 20, warmup)
    ts = tschedules.step_decay_schedule(1e-4, 0.1, 20, warmup)
    for step in range(40):
        np.testing.assert_allclose(ts(step), float(js(step)), rtol=1e-6)


def test_plateau_and_meters_match_jax():
    rng = np.random.default_rng(1)
    metrics = list(np.cumsum(rng.standard_normal(60) * 0.1) + 5.0)
    jp = jschedules.ReduceLROnPlateau(patience=3, base_lr=1e-3)
    tp = tschedules.ReduceLROnPlateau(patience=3, base_lr=1e-3)
    assert [tp.step(m) for m in metrics] == [jp.step(m) for m in metrics]
    assert (tp.best, tp.bad_epochs) == (jp.best, jp.bad_epochs)
    for jm, tm in ((jmeters.AverageMeter(7), tmeters.AverageMeter(7)),
                   (jmeters.WeightedMeter("x"), tmeters.WeightedMeter("x"))):
        for m in metrics:
            jm.update(m)
            tm.update(m)
            assert (tm.avg, tm.max, tm.min) == (jm.avg, jm.max, jm.min)


def test_train_config_matches_jax():
    path = os.path.join(ROOT, "examples", "balle17.json")
    tcfg = tconfig.TrainConfig.from_json(path)
    jcfg = jconfig.TrainConfig.from_json(path)
    assert [f.name for f in dataclasses.fields(tcfg)] == [f.name for f in dataclasses.fields(jcfg)]
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert json.loads(tcfg.to_json()) == json.loads(jcfg.to_json())
    assert (tcfg.lr_base, tcfg.lr_decay, tcfg.lr_decay_interval) == (1e-4, 0.1, 2200000)
    assert tcfg.out_channel_n == 128 and tcfg.batch_size == 4 and tcfg.image_size == 256
