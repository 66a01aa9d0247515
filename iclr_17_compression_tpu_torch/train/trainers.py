"""Auxiliary trainers: the residual rate-regression stage, and the epoch
loop and LR helpers the DSC trainers share.

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
  or train state, or from the port's own train-state file.
- ``make_stereo_dataset``: the stereo training source of a config;
  ``_kitti``: that of the auxiliary trainers.
- ``train_reg_stage``: a frozen 0.031-bpp DSC base and a trainable residual
  stage; loss 1 − MS-SSIM of (base recon + residual)
  (train_reg0.065model.py:100-145).

``TRAINERS`` names the JAX package's seven trainers; the six other than
``reg_stage`` (``two_steps``, ``decoder_only``, ``att_exp``, ``att_block``,
``passr``, ``fif_enhance``) raise, naming ROADMAP item 18.
"""

import dataclasses
import logging
import os
from typing import Callable, Optional

import torch

from ..data.datasets import (StereoHoloPixDataset, StereoKittiDataset, StereoPairDataset,
                             batch_iterator)
from ..models.dsc import DSC_PRESETS, DSCStereoModel
from ..ops.metrics import ms_ssim
from ..utils.device import resolve_device
from .checkpoint import save_train_state, snapshot_train_state
from .config import TrainConfig
from .schedules import ReduceLROnPlateau
from .state import TrainState, apply_gradients, create_train_state, step_generator
from .weights import load_dsc_weights

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
    epochs or ``tot_step`` steps."""
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
        epoch_loss /= max(n_batches, 1)
        tail.end_epoch(state, epoch, epoch_loss)
        logger.info("epoch %d done: loss=%.5f lr=%.2e", epoch, epoch_loss, tail.lr)
        if global_step >= cfg.tot_step:
            break
    return state


def _load_frozen(model: torch.nn.Module, pretrain: str) -> torch.nn.Module:
    """A frozen model: ``pretrain``'s weights when given (else its own
    init), in eval mode, with no parameter requiring a gradient."""
    if pretrain:
        load_dsc_weights(model, pretrain)
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


def _kitti(cfg: TrainConfig):
    """The auxiliary trainers' stereo source: the pairs cropped square at
    ``image_size`` (floored to ×32), else KITTI, whatever ``cfg.dataset``
    says (the reference's auxiliary scripts read KITTI alone)."""
    if cfg.dataset == "pairs":
        return make_stereo_dataset(cfg, pairs_crop=(cfg.image_size // 32) * 32)
    return make_stereo_dataset(dataclasses.replace(cfg, dataset="kitti"))


def make_reg_stage_step(base: DSCStereoModel):
    """``step(state, batch, generator)`` of the residual stage over the
    frozen ``base``: the base reconstruction without a gradient, the stage's
    noisy forward, loss 1 − MS-SSIM(clip(base + residual)), one update."""

    def step_fn(state: TrainState, batch, generator: Optional[torch.Generator]):
        dev = next(state.model.parameters()).device
        im1, im2 = (torch.as_tensor(b).to(dev, non_blocking=True) for b in batch)
        with torch.profiler.record_function("train_step/forward"):
            with torch.no_grad():
                base_recon = base(im1, im2)["recon"]
            out = state.model(im1, im2, train=True, generator=generator)
            loss = 1.0 - ms_ssim(torch.clamp(base_recon + out["recon_raw"], 0.0, 1.0), im1)
        with torch.profiler.record_function("train_step/backward"):
            state.optimizer.zero_grad(set_to_none=True)
            loss.backward()
        with torch.profiler.record_function("train_step/optimizer"):
            apply_gradients(state)
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


def _not_ported(name: str) -> Callable:
    def trainer(cfg: TrainConfig, run_name: str, pretrain: str = "", device=None):
        raise NotImplementedError(f"trainer {name!r} is not ported yet (ROADMAP item 18)")

    return trainer


TRAINERS = {"reg_stage": train_reg_stage,
            **{name: _not_ported(name) for name in ("two_steps", "decoder_only", "att_exp",
                                                    "att_block", "passr", "fif_enhance")}}
