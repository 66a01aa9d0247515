"""Training CLI: Ballé-17, the scale hyperprior, the joint-AR
codec, the DSC stereo codecs and the seven auxiliary trainers.

Counterpart of ``iclr_17_compression_tpu/train/cli.py`` (``main``,
``train_single_image``, ``train_dsc``, ``_restore``; its
``make_stereo_dataset`` lives in ``train/trainers.py`` beside the
auxiliary trainers' source):

  python -m iclr_17_compression_tpu_torch.train.cli \
      --config examples/balle17.json -n run1 [--pretrain ckpt] [--resume dir]
  python -m iclr_17_compression_tpu_torch.train.cli --config examples/dsc_0031bpp.json

Reference parity: the flags -n/-p/--config/--seed (train.py:30-39), the
JSON config schema (train.py:41-66), step-decay LR + warmup
(train.py:69-81), rd_loss = λ·d + bpp (train.py:100-102), the elementwise
gradient clamp ±5 (train.py:106-111), periodic Kodak eval and checkpoints
(train.py:150-153), windowed meters and logging (train.py:114-149). DSC
presets (``model: "dsc:<preset>"``) train in the train_2StepsNet loop shape
(per-epoch plateau LR, a validation pass, best-train / best-val / latest
checkpoints, train_2StepsNet.py:112-256); ``model`` one of ``two_steps``,
``reg_stage``, ``decoder_only``, ``att_exp``, ``att_block``, ``passr``,
``fif_enhance`` runs that auxiliary trainer (``train/trainers.py``), with
``--pretrain`` its frozen model's checkpoint where it has one. ``hyperprior`` and
``joint`` train in the Ballé-17 loop with rd_loss = λ·mse + bpp; the steps
of a model with ``train_cudnn_autotune`` set (the joint) run under
``cudnn_autotune`` on the card (``utils/device.py``: cuDNN's heuristic takes
an FFT route for the joint's 3×3 convs at C = 192, 32× slower a step on an
H100; the hyperprior's 5×5 convs are as fast without it).

Runs on CUDA (``resolve_device``: it raises without a card) unless a loop
is given ``device="cpu"``. The training mesh (JAX ``train/cli.py``'s
``training_mesh`` → ``shard_train_step``): ``mesh_data`` × ``mesh_tile``
slots over ``devices`` (default: every CUDA device, ``device`` first; on
the CPU, ``device`` alone), each batch split along N over the data axis and
along W over the tile axis (``train/mesh_step.py``); the model, the
optimizer and the checkpoints live at slot (0, 0). On one card that is a
1×1 mesh, the one-device step. A W-tile is made of whole units of the
model's downsampling (16 Ballé-17, 64 the hyperprior and joint, 32 DSC).

Resume: ``--resume <dir-or-ckpt>`` restores the model (slot (0, 0), which
the split step copies to every other slot), the Adam moments and the step,
and from the sidecar the epoch and mid-epoch batch offset (Ballé-17) or
the next epoch, LR and plateau state (DSC). The step's noise
comes from a generator seeded by (seed, global step) — the counterpart of
``fold_in(rng, global_step)`` — and the crops are a pure function of
(seed, epoch, index), so a resumed run draws the batches and the noise the
uninterrupted one would.
"""

import argparse
import contextlib
import dataclasses
import logging
import os
import time
from typing import Optional, Sequence

import numpy as np
import torch

from ..data.datasets import ImageFolderDataset, KodakDataset, StereoKittiDataset, batch_iterator
from ..eval.kodak import eval_kodak
from ..models.dsc import DSC_PRESETS, refuse_untrainable
from ..parallel.halo import tiled_hyperprior_train, tiled_joint_train
from ..parallel.mesh import Device, training_mesh, validate_tile_extent
from ..utils.device import cudnn_autotune, resolve_device
from .checkpoint import (
    load_params_partial,
    load_train_state,
    resolve_resume,
    save_params,
    save_train_state,
)
from .config import TrainConfig
from .mesh_step import shard_train_step
from .meters import AverageMeter
from .observability import MetricsLogger, ProfileWindow
from .schedules import step_decay_schedule
from .state import (TrainState, build_model, create_train_state, make_balle17_train_step,
                    make_dsc_train_step, make_hyperprior_train_step, step_generator)
from .trainers import TRAINERS, EpochTail, make_stereo_dataset

logger = logging.getLogger("iclr17c_torch")


def setup_logging(name: str, save_dir: str) -> None:
    os.makedirs(save_dir, exist_ok=True)
    logger.handlers.clear()  # idempotent across runs in one process
    logger.setLevel(logging.INFO)
    fmt = logging.Formatter("[%(asctime)s][%(levelname)s] %(message)s")
    fh = logging.FileHandler(os.path.join(save_dir, "train.log"))
    fh.setFormatter(fmt)
    sh = logging.StreamHandler()
    sh.setFormatter(fmt)
    logger.addHandler(fh)
    logger.addHandler(sh)


SINGLE_IMAGE_MODELS = ("balle17", "hyperprior", "joint")


def check_supported(cfg: TrainConfig) -> None:
    """Raise for what the port does not train: an unknown model, and
    ``fif_0031bpp`` in ``train_dsc`` (ROADMAP Queue 3: the JAX trainer
    keeps no batch statistics; ``models.dsc.refuse_untrainable``)."""
    if cfg.model.startswith("dsc:"):
        refuse_untrainable(DSC_PRESETS[cfg.model.split(":", 1)[1]])
    elif cfg.model not in SINGLE_IMAGE_MODELS and cfg.model not in TRAINERS:
        raise ValueError(f"unknown model {cfg.model!r}")


def make_training_mesh(cfg: TrainConfig, dev: torch.device,
                       devices: Optional[Sequence[Device]], width: int, total_div: int):
    """``training_mesh`` of the config over ``devices`` (default: every
    CUDA device, ``dev`` first, on a CUDA ``dev``; else ``dev`` alone),
    with JAX's tile-extent check, logged."""
    if devices is None:
        devices = [dev] + [torch.device("cuda", i) for i in range(torch.cuda.device_count())
                           if i != (dev.index or 0)] if dev.type == "cuda" else [dev]
    mesh = training_mesh(cfg.batch_size, cfg.mesh_data, cfg.mesh_tile, devices)
    validate_tile_extent(width, mesh.shape["tile"], total_div=total_div)
    logger.info("mesh: data=%d tile=%d", *mesh.devices.shape)
    return mesh


def _restore(state: TrainState, resume: str):
    """Resolve and load a full train-state checkpoint: (state, sidecar)."""
    path = resolve_resume(resume)
    if path is None:
        raise FileNotFoundError(f"--resume {resume!r}: no checkpoint found")
    state, meta = load_train_state(state, path)
    logger.info("resumed %s at step %d (meta=%s)", path, state.step, meta)
    return state, meta


def train_single_image(cfg: TrainConfig, name: str, pretrain: str = "", resume: str = "",
                       device: Optional[str] = None,
                       devices: Optional[Sequence[Device]] = None) -> TrainState:
    """The Ballé-17 / hyperprior / joint-AR training loop (reference
    train.py shape) on ``device`` (default ``cuda``), over the training
    mesh of ``devices`` (``make_training_mesh``). Returns the final train
    state."""
    dev = resolve_device(device)
    check_supported(cfg)
    if cfg.model not in SINGLE_IMAGE_MODELS:
        raise ValueError(f"train_single_image trains {SINGLE_IMAGE_MODELS}, not {cfg.model!r}")
    save_dir = os.path.join(cfg.save_root, name)
    setup_logging(name, save_dir)
    mesh = make_training_mesh(cfg, dev, devices, cfg.image_size, total_div=16)
    dev = mesh.devices[0, 0]

    model = build_model(cfg.model, device=dev, seed=cfg.seed, out_channel_n=cfg.out_channel_n,
                        out_channel_m=cfg.out_channel_m, quant=cfg.quant, n=cfg.joint_n)
    lr = step_decay_schedule(cfg.lr_base, cfg.lr_decay, cfg.lr_decay_interval, cfg.warmup_step)
    state = create_train_state(model, lr=lr, grad_clip=cfg.grad_clip)
    start_epoch, start_skip = 0, 0
    if resume:
        state, meta = _restore(state, resume)
        start_epoch = int(meta.get("epoch", 0))
        start_skip = int(meta.get("batch_in_epoch", 0))
    elif pretrain:
        load_params_partial(model, pretrain)
        logger.info("loaded pretrain %s", pretrain)
    logger.info("device: %s", torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu")

    if cfg.model == "balle17":
        step_fn = make_balle17_train_step(cfg.train_lambda, distortion=cfg.loss or "mse")
    else:
        step_fn = make_hyperprior_train_step(
            cfg.train_lambda,
            tiled=tiled_joint_train if cfg.model == "joint" else tiled_hyperprior_train)
    step_fn = shard_train_step(step_fn, mesh)
    dataset = ImageFolderDataset(cfg.train_dir, cfg.image_size, cfg.seed)
    test_set = KodakDataset(cfg.test_dir) if cfg.test_dir else None

    meters = {k: AverageMeter(cfg.print_freq) for k in ("rd_loss", "mse", "bpp", "psnr")}
    mlog = MetricsLogger(save_dir, tensorboard=cfg.tensorboard)
    prof = ProfileWindow(cfg.profile_dir, cfg.profile_start_step, cfg.profile_num_steps)

    def _checkpoint(epoch: int, batch_in_epoch: int):
        save_params(model, save_dir, state.step)
        save_train_state(state, save_dir, "latest", epoch=epoch,
                         extra={"batch_in_epoch": batch_in_epoch})

    # a model whose convs need cuDNN's algorithms chosen by timing says so
    # (``train_cudnn_autotune``, utils/device.py); the flags hold for its
    # train steps only (the joint's eval at 768×512 keeps cuDNN's heuristic:
    # timing those shapes peaks at 74 GiB of workspace on an H100)
    autotune = cudnn_autotune if getattr(model, "train_cudnn_autotune", False) \
        and dev.type == "cuda" else contextlib.nullcontext
    try:
        t_last = time.time()
        for epoch in range(start_epoch, cfg.tot_epoch):
            batch_in_epoch = start_skip if epoch == start_epoch else 0
            for batch in batch_iterator(
                dataset, cfg.batch_size, seed=cfg.seed, epoch=epoch,
                num_workers=cfg.num_workers, skip=batch_in_epoch,
            ):
                prof.tick(state.step)
                with autotune():
                    metrics = step_fn(state, torch.from_numpy(batch),
                                      step_generator(cfg.seed, state.step, dev))
                batch_in_epoch += 1
                if state.step % cfg.cal_step == 0:
                    for k in meters:
                        if k in metrics:  # the hyperprior step reports no psnr
                            meters[k].update(float(metrics[k]))
                if state.step % cfg.print_freq == 0:
                    dt = time.time() - t_last
                    t_last = time.time()
                    logger.info(
                        "step %d | %s | %.1f img/s", state.step,
                        " ".join(f"{k}={m.avg:.5f}" for k, m in meters.items()),
                        cfg.print_freq * cfg.batch_size / max(dt, 1e-9))
                    mlog.log(state.step, {k: m.avg for k, m in meters.items()})
                if state.step % cfg.save_model_freq == 0:
                    _checkpoint(epoch, batch_in_epoch)
                    if test_set is not None:
                        res = eval_kodak(model, list(test_set))
                        logger.info(
                            "KODAK step %d: bpp=%.4f psnr=%.3f msssim=%.5f (%.3f dB)",
                            state.step, res["bpp"], res["psnr"], res["ms_ssim"],
                            res["ms_ssim_db"])
                        mlog.log(state.step,
                                 {k: res[k] for k in ("bpp", "psnr", "ms_ssim", "ms_ssim_db")},
                                 prefix="test/")
                if state.step >= cfg.tot_step:
                    _checkpoint(epoch, batch_in_epoch)
                    return state
        _checkpoint(cfg.tot_epoch, 0)
        return state
    finally:
        prof.close()
        mlog.close()


def train_dsc(cfg: TrainConfig, name: str, pretrain: str = "", resume: str = "",
              device: Optional[str] = None,
              devices: Optional[Sequence[Device]] = None) -> TrainState:
    """The DSC stereo training loop (reference train_2StepsNet.py shape) on
    ``device`` (default ``cuda``), its steps over the training mesh of
    ``devices`` (``make_training_mesh``; the validation pass at slot (0,
    0)): per epoch, the mean training loss into
    the plateau LR, ``best_train`` (the best epoch's state, written on the
    next ``save_epoch_freq`` epoch or at the end), a validation pass over
    ``test_dir`` (``*_10.png`` KITTI frames, batch 1, ``loss_full`` of the
    eval forward) with ``best_val``, ``epoch_<n>`` every
    10·``save_epoch_freq`` epochs and ``latest`` with what a resume needs.
    Stops on ``tot_epoch``, as the JAX loop does. Returns the train state."""
    dev = resolve_device(device)
    check_supported(cfg)
    if not cfg.model.startswith("dsc:"):
        raise ValueError(f"train_dsc trains dsc:<preset> models, not {cfg.model!r}")
    save_dir = os.path.join(cfg.save_root, name)
    setup_logging(name, save_dir)
    mesh = make_training_mesh(cfg, dev, devices, (cfg.image_size // 32) * 32, total_div=32)
    dev = mesh.devices[0, 0]

    model = build_model(cfg.model, device=dev, seed=cfg.seed, loss=cfg.loss)
    state = create_train_state(model, lr=cfg.lr_base, grad_clip=cfg.grad_clip)
    tail = EpochTail(cfg, save_dir, best_every=cfg.save_epoch_freq,
                     periodic_every=10 * cfg.save_epoch_freq)
    start_epoch = 0
    if resume:
        state, meta = _restore(state, resume)
        start_epoch = int(meta.get("next_epoch", meta.get("epoch", 0)))
        tail.restore(state, meta)
    elif pretrain:
        load_params_partial(model, pretrain)
        logger.info("loaded pretrain %s", pretrain)
    logger.info("device: %s", torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu")

    step_fn = shard_train_step(make_dsc_train_step(), mesh, n_batch_args=2)
    dataset = make_stereo_dataset(cfg)
    # reference train_2StepsNet.py:221-256: a validation pass each epoch and
    # a best-val checkpoint beside the best-train one
    val_set = (StereoKittiDataset(cfg.test_dir.split(","), train=False, seed=cfg.seed)
               if cfg.test_dir else None)

    def val_loss_of(im1: np.ndarray, im2: np.ndarray) -> float:
        with torch.no_grad():
            out = model(torch.from_numpy(im1).to(dev), torch.from_numpy(im2).to(dev))
        return float(out["loss_full"])

    best_val = float("inf")
    mlog = MetricsLogger(save_dir, tensorboard=cfg.tensorboard)
    prof = ProfileWindow(cfg.profile_dir, cfg.profile_start_step, cfg.profile_num_steps)
    try:
        for epoch in range(start_epoch, cfg.tot_epoch):
            epoch_loss, n_batches = 0.0, 0
            for im1, im2 in batch_iterator(dataset, cfg.batch_size, seed=cfg.seed, epoch=epoch,
                                           num_workers=cfg.num_workers):
                prof.tick(state.step)
                metrics = step_fn(state, torch.from_numpy(im1), torch.from_numpy(im2),
                                  step_generator(cfg.seed, state.step, dev))
                epoch_loss += float(metrics["loss"])
                n_batches += 1
                if state.step % cfg.print_freq == 0:
                    logger.info("epoch %d step %d | %s", epoch, state.step,
                                " ".join(f"{k}={float(v):.5f}" for k, v in metrics.items()))
                    mlog.log(state.step, {k: float(v) for k, v in metrics.items()})
            epoch_loss /= max(n_batches, 1)
            tail.end_epoch(state, epoch, epoch_loss)
            if val_set is not None:
                losses = [val_loss_of(v1, v2) for v1, v2 in batch_iterator(
                    val_set, 1, shuffle=False, seed=0, drop_last=False)]
                val_loss = sum(losses) / max(len(losses), 1)
                mlog.log(state.step, {"val_loss": val_loss}, prefix="epoch/")
                if val_loss < best_val:
                    best_val = val_loss
                    save_train_state(state, save_dir, "best_val", epoch, val_loss)
                logger.info("epoch %d val: loss=%.5f (best %.5f)", epoch, val_loss, best_val)
            if epoch % cfg.save_epoch_freq == 0 or epoch == cfg.tot_epoch - 1:
                save_train_state(state, save_dir, "latest", epoch, epoch_loss,
                                 extra={"next_epoch": epoch + 1, **tail.sidecar()})
            logger.info("epoch %d done: loss=%.5f lr=%.2e", epoch, epoch_loss, tail.lr)
            mlog.log(state.step, {"epoch_loss": epoch_loss, "lr": tail.lr}, prefix="epoch/")
        tail.finish()  # an off-cycle best still waiting at the end
        return state
    finally:
        prof.close()
        mlog.close()


def main(argv=None) -> TrainState:
    ap = argparse.ArgumentParser(description="codec trainer (PyTorch, CUDA)")
    ap.add_argument("-n", "--name", default="run", help="experiment name")
    ap.add_argument("-p", "--pretrain", default="", help="pretrained ckpt path")
    ap.add_argument("--resume", default="", help="run dir or .ckpt to resume from")
    ap.add_argument("--config", default="", help="JSON config")
    ap.add_argument("--seed", type=int, default=None)
    args = ap.parse_args(argv)
    resolve_device()  # raise before writing anything on a machine without a card

    cfg = TrainConfig.from_json(args.config) if args.config else TrainConfig()
    if args.seed is not None:
        cfg = dataclasses.replace(cfg, seed=args.seed)
    check_supported(cfg)
    np.random.seed(cfg.seed)
    torch.autograd.set_detect_anomaly(cfg.debug_nans)

    # the resolved config beside the run, for the analysis tools
    save_dir = os.path.join(cfg.save_root, args.name)
    os.makedirs(save_dir, exist_ok=True)
    with open(os.path.join(save_dir, "config.json"), "w") as f:
        f.write(cfg.to_json())
    if cfg.model in TRAINERS:
        setup_logging(args.name, save_dir)
        return TRAINERS[cfg.model](cfg, args.name, args.pretrain)
    if cfg.model.startswith("dsc:"):
        return train_dsc(cfg, args.name, args.pretrain, args.resume)
    return train_single_image(cfg, args.name, args.pretrain, args.resume)


if __name__ == "__main__":
    main()
