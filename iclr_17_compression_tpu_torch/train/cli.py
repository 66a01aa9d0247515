"""Training CLI for Ballé-17 on one card.

Counterpart of ``main`` and ``train_single_image`` in
``iclr_17_compression_tpu/train/cli.py``:

  python -m iclr_17_compression_tpu_torch.train.cli \
      --config examples/balle17.json -n run1 [--pretrain ckpt] [--resume dir]

Reference parity: the flags -n/-p/--config/--seed (train.py:30-39), the
JSON config schema (train.py:41-66), step-decay LR + warmup
(train.py:69-81), rd_loss = λ·d + bpp (train.py:100-102), the elementwise
gradient clamp ±5 (train.py:106-111), periodic Kodak eval and checkpoints
(train.py:150-153), windowed meters and logging (train.py:114-149).

Runs on CUDA (``resolve_device``: it raises without a card) unless
``train_single_image`` is given ``device="cpu"``. One card: the JAX
package's data×tile mesh has no counterpart yet (ROADMAP item 20), so
``mesh_data`` must be None or 1 and ``mesh_tile`` 1.

Resume: ``--resume <dir-or-ckpt>`` restores the model, the Adam moments and
the step, and the epoch and mid-epoch batch offset from the sidecar. The
step's noise comes from a generator seeded by (seed, global step) — the
counterpart of ``fold_in(rng, global_step)`` — and the crops are a pure
function of (seed, epoch, index), so a resumed run draws the batches and
the noise the uninterrupted one would.
"""

import argparse
import dataclasses
import logging
import os
import time
from typing import Optional

import numpy as np
import torch

from ..data.datasets import ImageFolderDataset, KodakDataset, batch_iterator
from ..eval.kodak import eval_kodak
from ..models.balle17 import Balle17Compressor
from ..utils.device import resolve_device
from .checkpoint import (
    load_params_partial,
    load_train_state,
    resolve_resume,
    save_params,
    save_train_state,
)
from .config import TrainConfig
from .meters import AverageMeter
from .observability import MetricsLogger, ProfileWindow
from .schedules import step_decay_schedule
from .state import TrainState, create_train_state, make_balle17_train_step

logger = logging.getLogger("iclr17c_torch")

# the ROADMAP item that ports each model family the JAX trainer also runs
_NOT_PORTED = {"hyperprior": 16, "joint": 16, "dsc:": 15}


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


def check_supported(cfg: TrainConfig) -> None:
    """Raise for what the port does not train yet, naming its ROADMAP item."""
    if cfg.model != "balle17":
        item = next((i for k, i in _NOT_PORTED.items() if cfg.model.startswith(k)), None)
        where = f"ROADMAP item {item}" if item else "no ROADMAP item"
        raise NotImplementedError(
            f"model {cfg.model!r}: the port trains balle17 only ({where} ports it)")
    if cfg.mesh_data not in (None, 1) or cfg.mesh_tile != 1:
        raise NotImplementedError(
            f"mesh_data={cfg.mesh_data}, mesh_tile={cfg.mesh_tile}: the port trains on one "
            "card (data and tile parallelism are ROADMAP item 20)")


def step_generator(seed: int, step: int, device: torch.device) -> torch.Generator:
    """The training noise of global step ``step``: a generator on ``device``
    seeded by (seed, step), the counterpart of ``fold_in(rng, step)``."""
    return torch.Generator(device=device).manual_seed((seed << 32) + step)


def train_single_image(cfg: TrainConfig, name: str, pretrain: str = "", resume: str = "",
                       device: Optional[str] = None) -> TrainState:
    """The Ballé-17 training loop (reference train.py shape) on ``device``
    (default ``cuda``). Returns the final train state."""
    dev = resolve_device(device)
    check_supported(cfg)
    save_dir = os.path.join(cfg.save_root, name)
    setup_logging(name, save_dir)

    model = Balle17Compressor(cfg.out_channel_n, quant=cfg.quant)
    model.init_(torch.Generator().manual_seed(cfg.seed)).to(dev)
    lr = step_decay_schedule(cfg.lr_base, cfg.lr_decay, cfg.lr_decay_interval, cfg.warmup_step)
    state = create_train_state(model, lr=lr, grad_clip=cfg.grad_clip)
    start_epoch, start_skip = 0, 0
    if resume:
        path = resolve_resume(resume)
        if path is None:
            raise FileNotFoundError(f"--resume {resume!r}: no checkpoint found")
        state, meta = load_train_state(state, path)
        start_epoch = int(meta.get("epoch", 0))
        start_skip = int(meta.get("batch_in_epoch", 0))
        logger.info("resumed %s at step %d (meta=%s)", path, state.step, meta)
    elif pretrain:
        load_params_partial(model, pretrain)
        logger.info("loaded pretrain %s", pretrain)
    logger.info("device: %s", torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu")

    step_fn = make_balle17_train_step(cfg.train_lambda, distortion=cfg.loss or "mse")
    dataset = ImageFolderDataset(cfg.train_dir, cfg.image_size, cfg.seed)
    test_set = KodakDataset(cfg.test_dir) if cfg.test_dir else None

    meters = {k: AverageMeter(cfg.print_freq) for k in ("rd_loss", "mse", "bpp", "psnr")}
    mlog = MetricsLogger(save_dir, tensorboard=cfg.tensorboard)
    prof = ProfileWindow(cfg.profile_dir, cfg.profile_start_step, cfg.profile_num_steps)

    def _checkpoint(epoch: int, batch_in_epoch: int):
        save_params(model, save_dir, state.step)
        save_train_state(state, save_dir, "latest", epoch=epoch,
                         extra={"batch_in_epoch": batch_in_epoch})

    try:
        t_last = time.time()
        for epoch in range(start_epoch, cfg.tot_epoch):
            batch_in_epoch = start_skip if epoch == start_epoch else 0
            for batch in batch_iterator(
                dataset, cfg.batch_size, seed=cfg.seed, epoch=epoch,
                num_workers=cfg.num_workers, skip=batch_in_epoch,
            ):
                prof.tick(state.step)
                x = torch.from_numpy(batch).to(dev, non_blocking=True)
                metrics = step_fn(state, x, step_generator(cfg.seed, state.step, dev))
                batch_in_epoch += 1
                if state.step % cfg.cal_step == 0:
                    for k in meters:
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


def main(argv=None) -> TrainState:
    ap = argparse.ArgumentParser(description="Ballé-17 trainer (PyTorch, one CUDA card)")
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
    np.random.seed(cfg.seed)
    torch.autograd.set_detect_anomaly(cfg.debug_nans)

    # the resolved config beside the run, for the analysis tools
    save_dir = os.path.join(cfg.save_root, args.name)
    os.makedirs(save_dir, exist_ok=True)
    with open(os.path.join(save_dir, "config.json"), "w") as f:
        f.write(cfg.to_json())
    return train_single_image(cfg, args.name, args.pretrain, args.resume)


if __name__ == "__main__":
    main()
