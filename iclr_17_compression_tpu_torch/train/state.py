"""Train state, the train steps and the model factory.

Counterpart of ``iclr_17_compression_tpu/train/state.py`` (``TrainState``,
``_make_optimizer``, ``make_balle17_train_step``, ``make_dsc_train_step``,
``make_hyperprior_train_step``, ``build_model``). JAX's pure
``(state, batch, rng) -> (state, metrics)`` becomes a step that updates the
model and optimizer in place and returns the metrics.

Optimizer parity with ``optax.chain(optax.clip(5), optax.adam(lr))``: each
gradient element is clamped to ±``grad_clip`` (the reference's
``.clamp_(-5, 5)``, train.py:106-111), then ``torch.optim.Adam`` with
β = (0.9, 0.999) and eps 1e-8 outside the square root, as optax's. The LR of
update k (from 0) is ``schedule(k)``, as optax evaluates a schedule at its
update count.
"""

import dataclasses
from dataclasses import dataclass
from typing import Callable, Dict, Optional

import torch

from ..ops.metrics import ms_ssim
from ..utils.device import resolve_device

ADAM_BETAS = (0.9, 0.999)
ADAM_EPS = 1e-8


def make_optimizer(params, lr: float = 1e-4) -> torch.optim.Adam:
    """Adam as ``optax.adam``'s defaults; ``apply_gradients`` sets its LR
    from the schedule before each update."""
    return torch.optim.Adam(params, lr=lr, betas=ADAM_BETAS, eps=ADAM_EPS)


@dataclass
class TrainState:
    """The model, its optimizer, the LR schedule, the clamp and the number
    of updates taken (``step``)."""

    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    schedule: Callable[[int], float]
    grad_clip: float = 5.0
    step: int = 0


def create_train_state(model: torch.nn.Module, lr=1e-4, grad_clip: float = 5.0) -> TrainState:
    """``lr`` is a float or a ``step → lr`` schedule."""
    schedule = lr if callable(lr) else (lambda step: lr)
    return TrainState(model, make_optimizer(model.parameters(), schedule(0)), schedule,
                      grad_clip)


def apply_gradients(state: TrainState) -> None:
    """Clamp every gradient element, then one Adam update at the schedule's
    LR for this step."""
    for group in state.optimizer.param_groups:
        group["lr"] = state.schedule(state.step)
        for p in group["params"]:
            if p.grad is not None:
                p.grad.clamp_(-state.grad_clip, state.grad_clip)
    state.optimizer.step()
    state.step += 1


def step_generator(seed: int, step: int, device: torch.device) -> torch.Generator:
    """The training noise of global step ``step``: a generator on ``device``
    seeded by (seed, step), the counterpart of ``fold_in(rng, step)``."""
    return torch.Generator(device=device).manual_seed((seed << 32) + step)


def msssim_window(batch: torch.Tensor) -> int:
    """Window 11 needs ≥ 176 px for 5 scales; smaller crops use the
    reference's small-image window 7."""
    return 11 if min(batch.shape[1:3]) >= 176 else 7


def make_balle17_train_step(train_lambda: float = 8192.0, distortion: str = "mse"):
    """``train_step(state, batch, generator)``: rd_loss = λ·d + bpp with d the
    MSE, or 1 − MS-SSIM for ``msssim``; one update; the metrics
    ``rd_loss``, ``mse``, ``bpp`` and ``psnr`` (detached tensors)."""
    if distortion not in ("mse", "msssim"):
        # a DSC loss string ('l1') or typo ('ms_ssim') must not silently
        # train the whole run as MSE
        raise ValueError(f"balle17 distortion must be 'mse' or 'msssim', got {distortion!r}")

    def train_step(state: TrainState, batch: torch.Tensor,
                   generator: Optional[torch.Generator]) -> Dict[str, torch.Tensor]:
        with torch.profiler.record_function("train_step/forward"):
            out = state.model(batch, train=True, generator=generator)
            if distortion == "msssim":
                d = 1.0 - ms_ssim(out["recon"], batch, win_size=msssim_window(batch))
            else:
                d = out["mse"]
            rd_loss = train_lambda * d + out["bpp"]
        with torch.profiler.record_function("train_step/backward"):
            state.optimizer.zero_grad(set_to_none=True)
            rd_loss.backward()
        with torch.profiler.record_function("train_step/optimizer"):
            apply_gradients(state)
        mse = out["mse"].detach()
        return {
            "rd_loss": rd_loss.detach(),
            "mse": mse,
            "bpp": out["bpp"].detach(),
            "psnr": 10.0 * torch.log10(1.0 / torch.clamp(mse, min=1e-10)),
        }

    return train_step


def make_dsc_train_step(w_full: float = 1.0, w_base: float = 1.0, w_z: float = 0.0):
    """``train_step(state, im1, im2, generator)`` for a ``DSCStereoModel``:
    loss = w_full·loss_full + w_base·loss (the base branch's) [+ w_z·loss_z]
    (reference train_2StepsNet.py:190, train_new.py:177); one update; the
    metrics ``loss``, ``loss_full``, ``loss_base`` and ``loss_z`` (detached
    tensors)."""

    def train_step(state: TrainState, im1: torch.Tensor, im2: torch.Tensor,
                   generator: Optional[torch.Generator]) -> Dict[str, torch.Tensor]:
        with torch.profiler.record_function("train_step/forward"):
            out = state.model(im1, im2, train=True, generator=generator)
            loss = w_full * out["loss_full"] + w_base * out["loss"]
            if w_z:
                loss = loss + w_z * out["loss_z"]
        with torch.profiler.record_function("train_step/backward"):
            state.optimizer.zero_grad(set_to_none=True)
            loss.backward()
        with torch.profiler.record_function("train_step/optimizer"):
            apply_gradients(state)
        return {"loss": loss.detach(), "loss_full": out["loss_full"].detach(),
                "loss_base": out["loss"].detach(), "loss_z": out["loss_z"].detach()}

    return train_step


def make_hyperprior_train_step(train_lambda: float = 8192.0):
    """``train_step(state, batch, generator)`` for a ``ScaleHyperprior`` or
    a ``JointAutoregressive``: rd_loss = λ·mse + bpp (bpp_y + bpp_z); one
    update; the metrics ``rd_loss``, ``mse``, ``bpp``, ``bpp_y`` and
    ``bpp_z`` (detached tensors)."""

    def train_step(state: TrainState, batch: torch.Tensor,
                   generator: Optional[torch.Generator]) -> Dict[str, torch.Tensor]:
        with torch.profiler.record_function("train_step/forward"):
            out = state.model(batch, train=True, generator=generator)
            rd_loss = train_lambda * out["mse"] + out["bpp"]
        with torch.profiler.record_function("train_step/backward"):
            state.optimizer.zero_grad(set_to_none=True)
            rd_loss.backward()
        with torch.profiler.record_function("train_step/optimizer"):
            apply_gradients(state)
        return {"rd_loss": rd_loss.detach(),
                **{k: out[k].detach() for k in ("mse", "bpp", "bpp_y", "bpp_z")}}

    return train_step


def build_model(name: str, device: Optional[str] = None, seed: int = 0, **kw) -> torch.nn.Module:
    """Model factory: ``balle17`` (``out_channel_n``, ``quant``),
    ``hyperprior`` (``out_channel_n`` 192, ``out_channel_m`` 320, ``quant``:
    ``sigma-norm``, else ``round``, as the JAX model reads any other name,
    such as the config's default ``noise-round``), ``joint`` (``n`` 192) or
    ``dsc:<preset>`` (``loss`` overrides the preset's), drawn from the JAX
    package's init with a generator seeded by ``seed``, on ``device``
    (default ``cuda``)."""
    from ..models.balle17 import Balle17Compressor
    from ..models.cheng2020 import JointAutoregressive
    from ..models.dsc import DSC_PRESETS, DSCStereoModel
    from ..models.hyperprior import ScaleHyperprior

    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    if name == "balle17":
        model = Balle17Compressor(kw.get("out_channel_n", 128),
                                  quant=kw.get("quant", "noise-round"))
    elif name.startswith("dsc:"):
        cfg = DSC_PRESETS[name.split(":", 1)[1]]
        if kw.get("loss"):
            cfg = dataclasses.replace(cfg, loss=kw["loss"])
        model = DSCStereoModel(cfg)
    elif name == "hyperprior":
        model = ScaleHyperprior(kw.get("out_channel_n", 192), kw.get("out_channel_m", 320),
                                quant="sigma-norm" if kw.get("quant") == "sigma-norm"
                                else "round")
    elif name == "joint":
        model = JointAutoregressive(kw.get("n", 192))
    else:
        raise ValueError(f"unknown model {name!r}")
    return model.init_(gen).to(dev)
