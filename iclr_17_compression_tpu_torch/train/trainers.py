"""The auxiliary trainers, and the epoch loop and LR helpers they share
with the DSC trainer.

Counterpart of ``iclr_17_compression_tpu/train/trainers.py``:

- ``set_lr``: the LR every later update uses. JAX injects the LR into the
  optimizer state (``_injectable_optimizer``) so that a host-side plateau
  controller can change it between jitted steps; here it replaces the
  ``TrainState``'s schedule by a constant.
- ``EpochTail``: the end of an epoch that both epoch loops share (mean
  epoch loss → plateau LR → best-loss and periodic full-state checkpoints,
  train_2StepsNet.py:201-256); ``_run_epochs``: the auxiliary trainers'
  epoch loop.
- ``_load_frozen``: a frozen model's weights from a JAX-layout params file
  or train state of its kind, or from the port's own train-state file.
- ``make_stereo_dataset``: the stereo training source of a config;
  ``_kitti``: that of the auxiliary trainers.
- The seven trainers, each with its step factory ``make_<trainer>_step``
  (``step(state, batch, generator)`` → metrics; one update in place):
  - ``two_steps``: a frozen Ballé-17 gives the latents of both eyes; a
    ``LatentCompressor`` learns z1 from (z1, z2), loss its latent MSE
    (train_twoSteps.py:100-135);
  - ``reg_stage``: a frozen 0.031-bpp DSC base and a trainable residual
    stage; loss 1 − MS-SSIM of (base recon + residual)
    (train_reg0.065model.py:100-145);
  - ``decoder_only``: a frozen Ballé-17 encoder, a fresh ``Synthesis17``
    trained on both eyes with one shared noise draw, loss the sum of the
    clipped MSEs (train_decoder_new.py:80-115);
  - ``att_exp``: ``PatchMatchAttention`` on the raw images, L1 of im1
    against att(im1, im2) (train_Att_EXP.py:100-140);
  - ``att_block``: a frozen ``temp_1bpp`` DSC model gives (z1, z2);
    ``PatchMatchAttention`` with q = z1, k = z2, v = im2 rebuilds im1, L1
    (train_only_att_block.py:118-147);
  - ``passr``: ``PASSRnet`` (×1) with its SR, smoothness, cycle and
    photometric losses (train_PASSRnet.py:110-140);
  - ``fif_enhance``: ``FinalEnhanceNet``'s residual over cat(recon, warped
    SI), L1 to the original (fast_image_filters/train_FIF_enhance.py:85-115).

The frozen models run without a gradient, in eval mode, with no parameter
requiring one. On the card, ``two_steps`` and ``decoder_only`` run the
frozen Ballé-17 encoder as three K2 launches an eye, ``decoder_only``'s
decoder two K1 launches an eye (forward and K1's autograd Function), and
``att_block``'s frozen base its eval forward (K2 at the DSC blocks, K3 on
its code); the other three run no kernel of the port.
"""

import logging
import os
from typing import Callable, Optional

import torch

from ..data.datasets import (FIFEnhanceDataset, StereoHoloPixDataset, StereoKittiDataset,
                             StereoPairDataset, StereoPassrDataset, batch_iterator)
from ..models.attention import PatchMatchAttention
from ..models.balle17 import Analysis17, Balle17Compressor, Synthesis17
from ..models.dsc import DSC_PRESETS, DSCStereoModel
from ..models.enhance import FinalEnhanceNet
from ..models.extra import LatentCompressor
from ..models.passr import PASSRnet, passr_losses
from ..nn.blocks import init_dsc_
from ..nn.layers import init_modules_
from ..ops import quant
from ..ops.metrics import ms_ssim
from ..utils.device import resolve_device
from .checkpoint import save_train_state, snapshot_train_state
from .config import TrainConfig
from .schedules import ReduceLROnPlateau
from .state import TrainState, apply_gradients, create_train_state, step_generator
from .weights import load_weights

logger = logging.getLogger("iclr17c_torch")


def set_lr(state: TrainState, lr: float) -> TrainState:
    """Every later update of ``state`` runs at ``lr``."""
    state.schedule = lambda step: lr
    return state


class EpochTail:
    """What the epoch loops do when an epoch ends: its mean loss into the
    plateau LR (``set_lr`` when that changes), ``best_train`` on an
    improvement and ``epoch_<n>`` every ``periodic_every`` epochs. With
    ``best_every`` > 1 the best waits, as a snapshot, for the next epoch
    divisible by ``best_every`` or for ``finish`` (the DSC loop's schedule,
    train_2StepsNet.py:201-220)."""

    def __init__(self, cfg: TrainConfig, save_dir: str, best_every: int = 1,
                 periodic_every: int = 10):
        self.save_dir, self.best_every, self.periodic_every = save_dir, best_every, periodic_every
        self.plateau = ReduceLROnPlateau(base_lr=cfg.lr_base, patience=cfg.plateau_patience)
        self.lr, self.best_loss, self._best = cfg.lr_base, float("inf"), None

    def restore(self, state: TrainState, meta: dict) -> None:
        """The LR and plateau state of a resumed run's sidecar."""
        self.lr = self.plateau.lr = float(meta.get("lr", self.lr))
        self.plateau.best = float(meta.get("plateau_best", float("inf")))
        self.plateau.bad_epochs = int(meta.get("plateau_bad", 0))
        set_lr(state, self.lr)

    def sidecar(self) -> dict:
        """What a resume needs of the LR and the plateau."""
        return {"lr": self.lr, "plateau_best": self.plateau.best,
                "plateau_bad": self.plateau.bad_epochs}

    def end_epoch(self, state: TrainState, epoch: int, epoch_loss: float) -> None:
        new_lr = self.plateau.step(epoch_loss)
        if new_lr != self.lr:
            self.lr = new_lr
            set_lr(state, new_lr)
        if epoch_loss < self.best_loss:
            self.best_loss = epoch_loss
            # a copy when the save waits: the live model trains on meanwhile
            # (JAX keeps its immutable arrays)
            self._best = (state if self.best_every == 1 else snapshot_train_state(state),
                          epoch, epoch_loss)
        if epoch % self.best_every == 0:
            self.finish()
        # the periodic checkpoints are written whether or not the epoch
        # improved, as the reference keeps both (train_2StepsNet.py:201-220)
        if epoch % self.periodic_every == 0:
            save_train_state(state, self.save_dir, f"epoch_{epoch}", epoch, epoch_loss)

    def finish(self) -> None:
        """Write a best that still waits."""
        if self._best is not None:
            save_train_state(self._best[0], self.save_dir, "best_train", *self._best[1:])
            self._best = None


def _run_epochs(cfg: TrainConfig, name: str, dataset, state: TrainState, step_fn: Callable,
                device: torch.device, save_every: int = 10) -> TrainState:
    """The reference's epoch loop: ``step_fn(state, batch, generator)`` on
    every batch, then ``EpochTail`` (``best_train`` on every improvement,
    ``epoch_<n>`` every ``save_every`` epochs); stops after ``tot_epoch``
    epochs or ``tot_step`` steps. Raises on a dataset smaller than a batch,
    which would give empty epochs to the end."""
    save_dir = os.path.join(cfg.save_root, name)
    os.makedirs(save_dir, exist_ok=True)
    tail = EpochTail(cfg, save_dir, periodic_every=save_every)
    global_step = 0
    for epoch in range(cfg.tot_epoch):
        epoch_loss, n_batches = 0.0, 0
        for batch in batch_iterator(dataset, cfg.batch_size, seed=cfg.seed, epoch=epoch):
            metrics = step_fn(state, batch, step_generator(cfg.seed, global_step, device))
            global_step += 1
            epoch_loss += float(metrics["loss"])
            n_batches += 1
            if global_step % cfg.print_freq == 0:
                logger.info("epoch %d step %d | %s", epoch, global_step,
                            " ".join(f"{k}={float(v):.5f}" for k, v in metrics.items()))
            if global_step >= cfg.tot_step:
                break
        if n_batches == 0:  # else the loop would spin to tot_epoch, saving as it goes
            raise ValueError(f"{len(dataset)} items give no batch of {cfg.batch_size}")
        epoch_loss /= n_batches
        tail.end_epoch(state, epoch, epoch_loss)
        logger.info("epoch %d done: loss=%.5f lr=%.2e", epoch, epoch_loss, tail.lr)
        if global_step >= cfg.tot_step:
            break
    return state


def _load_frozen(model: torch.nn.Module, pretrain: str) -> torch.nn.Module:
    """A frozen model: ``pretrain``'s weights when given (else its own
    init), in eval mode, with no parameter requiring a gradient.
    ``pretrain`` is a JAX params file or TrainState of the model's kind
    (bare params, or under "params"), or the port's own train-state file
    (``weights.load_weights``)."""
    if pretrain:
        load_weights(model, pretrain)
        logger.info("loaded frozen pretrain %s", pretrain)
    return model.eval().requires_grad_(False)


def make_stereo_dataset(cfg: TrainConfig, pairs_crop: Optional[int] = None):
    """The stereo training source of ``cfg.dataset``: kitti, holopix or
    pairs (cropped square to ``pairs_crop`` when given)."""
    if cfg.dataset == "kitti":
        return StereoKittiDataset(cfg.train_dir.split(","), train=True, seed=cfg.seed)
    if cfg.dataset == "holopix":
        return StereoHoloPixDataset(cfg.train_dir, random_crop=True, seed=cfg.seed)
    if cfg.dataset == "pairs":
        left, right = cfg.train_dir.split(",")
        kw = {"crop": (pairs_crop, pairs_crop)} if pairs_crop else {}
        return StereoPairDataset(left, right, seed=cfg.seed, **kw)
    raise ValueError(f"unknown stereo dataset {cfg.dataset!r}")


def _kitti(cfg: TrainConfig, multiple: int = 32):
    """The auxiliary trainers' stereo source, floored to ×``multiple``: the
    pairs cropped square at ``image_size`` (floored to ×``multiple``), else
    KITTI, whatever ``cfg.dataset`` says (the reference's auxiliary scripts
    read KITTI alone)."""
    if cfg.dataset == "pairs":
        left, right = cfg.train_dir.split(",")
        crop = (cfg.image_size // multiple) * multiple
        return StereoPairDataset(left, right, crop=(crop, crop), multiple=multiple,
                                 seed=cfg.seed)
    return StereoKittiDataset(cfg.train_dir.split(","), train=True, seed=cfg.seed,
                              multiple=multiple)


def _to(dev: torch.device, batch):
    return tuple(torch.as_tensor(b).to(dev, non_blocking=True) for b in batch)


def _update(state: TrainState, loss: torch.Tensor) -> None:
    """Backward of ``loss`` and one clamped Adam update, each in its
    profiler range."""
    with torch.profiler.record_function("train_step/backward"):
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
    with torch.profiler.record_function("train_step/optimizer"):
        apply_gradients(state)


def _device_of(state: TrainState) -> torch.device:
    return next(state.model.parameters()).device


def make_reg_stage_step(base: DSCStereoModel):
    """``step(state, batch, generator)`` of the residual stage over the
    frozen ``base``: the base reconstruction without a gradient, the stage's
    noisy forward, loss 1 − MS-SSIM(clip(base + residual)), one update."""

    def step_fn(state: TrainState, batch, generator: Optional[torch.Generator]):
        im1, im2 = _to(_device_of(state), batch)
        with torch.profiler.record_function("train_step/forward"):
            with torch.no_grad():
                base_recon = base(im1, im2)["recon"]
            out = state.model(im1, im2, train=True, generator=generator)
            loss = 1.0 - ms_ssim(torch.clamp(base_recon + out["recon_raw"], 0.0, 1.0), im1)
        _update(state, loss)
        return {"loss": loss.detach()}

    return step_fn


def train_reg_stage(cfg: TrainConfig, name: str, pretrain: str = "",
                    device: Optional[str] = None) -> TrainState:
    """Frozen ``temp_0031bpp`` base (``pretrain``: its checkpoint) and a
    trainable ``reg_0_0625`` residual stage, on ``device`` (default
    ``cuda``). Returns the residual stage's train state."""
    dev = resolve_device(device)
    base = DSCStereoModel(DSC_PRESETS["temp_0031bpp"])
    base = _load_frozen(base.init_(torch.Generator().manual_seed(cfg.seed)), pretrain).to(dev)
    reg = DSCStereoModel(DSC_PRESETS["reg_0_0625"])
    reg.init_(torch.Generator().manual_seed(cfg.seed)).to(dev)
    state = create_train_state(reg, lr=cfg.lr_base, grad_clip=cfg.grad_clip)
    return _run_epochs(cfg, name, _kitti(cfg), state, make_reg_stage_step(base), dev)


def _gen(cfg: TrainConfig) -> torch.Generator:
    return torch.Generator().manual_seed(cfg.seed)


def make_two_steps_step(base: Balle17Compressor):
    """The ``LatentCompressor``'s step over the frozen ``base``: both eyes'
    eval latents round(g_a(im)) without a gradient, loss the compressor's
    latent MSE."""

    def step_fn(state: TrainState, batch, generator: Optional[torch.Generator]):
        im1, im2 = _to(_device_of(state), batch)
        with torch.profiler.record_function("train_step/forward"):
            with torch.no_grad():
                z1, z2 = (quant.round(base.Encoder(im)) for im in (im1, im2))
            loss = state.model(z1, z2)["mse"]
        _update(state, loss)
        return {"loss": loss.detach()}

    return step_fn


def train_two_steps(cfg: TrainConfig, name: str, pretrain: str = "",
                    device: Optional[str] = None) -> TrainState:
    """Frozen Ballé-17 (``pretrain``: its checkpoint) and a trainable
    ``LatentCompressor``, on ``device`` (default ``cuda``), over the stereo
    source floored to ×16."""
    dev = resolve_device(device)
    gen = _gen(cfg)
    base = _load_frozen(Balle17Compressor(cfg.out_channel_n).init_(gen), pretrain).to(dev)
    comp = LatentCompressor(cfg.out_channel_n).init_(gen).to(dev)
    state = create_train_state(comp, lr=cfg.lr_base, grad_clip=cfg.grad_clip)
    return _run_epochs(cfg, name, _kitti(cfg, multiple=16), state, make_two_steps_step(base),
                       dev)


def make_decoder_only_step(encoder: Analysis17):
    """The fresh decoder's step over the frozen ``encoder``: both eyes'
    latents without a gradient, one noise draw U(−½, ½) of the latent's
    shape added to both, loss the sum of the two clipped MSEs."""

    def step_fn(state: TrainState, batch, generator: Optional[torch.Generator]):
        im1, im2 = _to(_device_of(state), batch)
        with torch.profiler.record_function("train_step/forward"):
            with torch.no_grad():
                z1, z2 = encoder(im1), encoder(im2)
                noise = quant.add_uniform_noise(torch.zeros_like(z1), generator, 0.5)
            r1 = torch.clamp(state.model(z1 + noise), 0.0, 1.0)
            r2 = torch.clamp(state.model(z2 + noise), 0.0, 1.0)
            loss = torch.mean((r1 - im1) ** 2) + torch.mean((r2 - im2) ** 2)
        _update(state, loss)
        return {"loss": loss.detach()}

    return step_fn


def train_decoder_only(cfg: TrainConfig, name: str, pretrain: str = "",
                       device: Optional[str] = None) -> TrainState:
    """The frozen encoder of a Ballé-17 checkpoint (``pretrain``) and a
    fresh ``Synthesis17``, on ``device`` (default ``cuda``), over the stereo
    source floored to ×16."""
    dev = resolve_device(device)
    gen = _gen(cfg)
    base = _load_frozen(Balle17Compressor(cfg.out_channel_n).init_(gen), pretrain).to(dev)
    dec = init_modules_(Synthesis17(cfg.out_channel_n), gen).to(dev)
    state = create_train_state(dec, lr=cfg.lr_base, grad_clip=cfg.grad_clip)
    return _run_epochs(cfg, name, _kitti(cfg, multiple=16), state,
                       make_decoder_only_step(base.Encoder), dev)


def _l1_to_target(im1: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """L1 of ``out`` against im1 cut to its size (the patch grid may fall
    short of the image)."""
    return torch.mean(torch.abs(im1[:, : out.shape[1], : out.shape[2]] - out))


def make_att_exp_step():
    """Patch-match attention's step on the raw images: L1 of im1 against
    att(im1, im2)."""

    def step_fn(state: TrainState, batch, generator: Optional[torch.Generator]):
        im1, im2 = _to(_device_of(state), batch)
        with torch.profiler.record_function("train_step/forward"):
            loss = _l1_to_target(im1, state.model(im1, im2))
        _update(state, loss)
        return {"loss": loss.detach()}

    return step_fn


def train_att_exp(cfg: TrainConfig, name: str, pretrain: str = "",
                  device: Optional[str] = None) -> TrainState:
    """``PatchMatchAttention(dim=3, dim_head=128)`` on raw stereo images, on
    ``device`` (default ``cuda``)."""
    dev = resolve_device(device)
    model = init_dsc_(PatchMatchAttention(3, 128), _gen(cfg)).to(dev)
    state = create_train_state(model, lr=cfg.lr_base, grad_clip=cfg.grad_clip)
    return _run_epochs(cfg, name, _kitti(cfg), state, make_att_exp_step(), dev)


def make_att_block_step(base: DSCStereoModel):
    """The attention's step over the frozen DSC ``base``: its eval forward's
    (z1, z2) without a gradient, then att(z1, z2, v = im2) against im1, L1."""

    def step_fn(state: TrainState, batch, generator: Optional[torch.Generator]):
        im1, im2 = _to(_device_of(state), batch)
        with torch.profiler.record_function("train_step/forward"):
            with torch.no_grad():
                out = base(im1, im2)
            loss = _l1_to_target(im1, state.model(out["z1"], out["z2"], im2))
        _update(state, loss)
        return {"loss": loss.detach()}

    return step_fn


def train_att_block(cfg: TrainConfig, name: str, pretrain: str = "",
                    device: Optional[str] = None) -> TrainState:
    """A frozen ``temp_1bpp`` DSC model (``pretrain``: its checkpoint) and
    ``PatchMatchAttention(dim=128, dim_head=1024)``, on ``device`` (default
    ``cuda``)."""
    dev = resolve_device(device)
    gen = _gen(cfg)
    base = _load_frozen(DSCStereoModel(DSC_PRESETS["temp_1bpp"]).init_(gen), pretrain).to(dev)
    # q = z1: the base's n channels (128 for temp_1bpp; JAX's conv infers them)
    att = init_dsc_(PatchMatchAttention(base.config.n, 1024), gen).to(dev)
    state = create_train_state(att, lr=cfg.lr_base, grad_clip=cfg.grad_clip)
    return _run_epochs(cfg, name, _kitti(cfg), state, make_att_block_step(base), dev)


def make_passr_step():
    """PASSRnet's step: its train forward on (blurred left, right), the SR,
    smoothness, cycle and photometric losses against the left eye."""

    def step_fn(state: TrainState, batch, generator: Optional[torch.Generator]):
        blurry, right, left = _to(_device_of(state), batch)
        with torch.profiler.record_function("train_step/forward"):
            sr, ms, cycles, vs = state.model(blurry, right, train=True)
            losses = passr_losses(sr, left, ms, cycles, vs, blurry, right)
        _update(state, losses["loss"])
        return {k: v.detach() for k, v in losses.items()}

    return step_fn


def train_passr(cfg: TrainConfig, name: str, pretrain: str = "",
                device: Optional[str] = None) -> TrainState:
    """``PASSRnet(upscale_factor=1)`` over ``StereoPassrDataset`` crops of
    ``image_size`` (floored to ×32), on ``device`` (default ``cuda``)."""
    dev = resolve_device(device)
    hw = (cfg.image_size // 32) * 32
    model = PASSRnet(upscale_factor=1).init_(_gen(cfg)).to(dev)
    state = create_train_state(model, lr=cfg.lr_base, grad_clip=cfg.grad_clip)
    dataset = StereoPassrDataset(cfg.train_dir.split(","), train=True, crop=(hw, hw),
                                 seed=cfg.seed)
    return _run_epochs(cfg, name, dataset, state, make_passr_step(), dev)


def make_fif_enhance_step():
    """The enhancer's step: its residual over cat(recon, warped SI), L1 of
    recon + residual against the original."""

    def step_fn(state: TrainState, batch, generator: Optional[torch.Generator]):
        im_si, im_rec, im_orig = _to(_device_of(state), batch)
        with torch.profiler.record_function("train_step/forward"):
            res = state.model(torch.cat([im_rec, im_si], dim=-1))
            loss = torch.mean(torch.abs(im_rec + res - im_orig))
        _update(state, loss)
        return {"loss": loss.detach()}

    return step_fn


def train_fif_enhance(cfg: TrainConfig, name: str, pretrain: str = "",
                      device: Optional[str] = None) -> TrainState:
    """``FinalEnhanceNet`` over ``FIFEnhanceDataset`` triplets (``train_dir``:
    the reconstructed-images folder) cropped at ``image_size`` (floored to
    ×32), on ``device`` (default ``cuda``)."""
    dev = resolve_device(device)
    hw = (cfg.image_size // 32) * 32
    model = FinalEnhanceNet().init_(_gen(cfg)).to(dev)
    state = create_train_state(model, lr=cfg.lr_base, grad_clip=cfg.grad_clip)
    dataset = FIFEnhanceDataset(cfg.train_dir, random_crop=True, crop=(hw, hw), seed=cfg.seed)
    return _run_epochs(cfg, name, dataset, state, make_fif_enhance_step(), dev)


TRAINERS = {"two_steps": train_two_steps, "reg_stage": train_reg_stage,
            "decoder_only": train_decoder_only, "att_exp": train_att_exp,
            "att_block": train_att_block, "passr": train_passr,
            "fif_enhance": train_fif_enhance}
