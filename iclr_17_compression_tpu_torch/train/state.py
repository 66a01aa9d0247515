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

Each step is a ``TrainStep``: the step, and what ``shard_train_step``
(``train/mesh_step.py``) needs to split it over a device mesh:
``mesh_loss(split)``, the loss and the whole batch's metrics from the
slots' forwards (a W-tiled data row through
``parallel.halo.tiled_balle17_train``, ``tiled_hyperprior_train``,
``tiled_joint_train`` or ``parallel.tiled.tiled_dsc_train``), and
``tile_unit``, the columns a W-tile is made of (the model's
downsampling). A loss
that is a ratio of sums (MSE, L1, bpp) is pooled from the slots' sums and
counts; MS-SSIM, a product of powers of per-level means, from its
per-level sums (``ops.metrics.ms_ssim_sums``; a W-tiled data row's tiles
are gathered for its windows): the mean of per-slot losses is not the
whole batch's loss, nor its gradient.
"""

import dataclasses
from dataclasses import dataclass
from typing import Callable, Dict, Optional

import torch

from ..models.dsc import elementwise_error, loss_terms, loss_triplet, refuse_untrainable
from ..ops.metrics import ms_ssim, ms_ssim_of_sums, ms_ssim_sums
from ..parallel.halo import tiled_balle17_train, tiled_hyperprior_train
from ..parallel.mesh import gather_tiles
from ..parallel.tiled import tiled_dsc_train
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


@dataclass
class TrainStep:
    """A train step, ``step(state, *batches, generator) -> metrics``, and
    what splitting it over a device mesh needs
    (``train.mesh_step.shard_train_step``): ``mesh_loss(split)`` → (the
    loss, the whole batch's metrics) from the slots' forwards, and
    ``tile_unit``, the columns a W-tile is made of."""

    step: Callable
    mesh_loss: Callable
    tile_unit: int

    def __call__(self, state: TrainState, *args) -> Dict[str, torch.Tensor]:
        return self.step(state, *args)


def step_generator(seed: int, step: int, device: torch.device) -> torch.Generator:
    """The training noise of global step ``step``: a generator on ``device``
    seeded by (seed, step), the counterpart of ``fold_in(rng, step)``."""
    return torch.Generator(device=device).manual_seed((seed << 32) + step)


def msssim_window(batch: torch.Tensor) -> int:
    """Window 11 needs ≥ 176 px for 5 scales; smaller crops use the
    reference's small-image window 7."""
    return 11 if min(batch.shape[1:3]) >= 176 else 7


def _add(total, part):
    """``total + part`` (``part`` where ``total`` is None; counts as tuples
    add elementwise)."""
    if total is None:
        return part
    if isinstance(part, tuple):
        return tuple(a + b for a, b in zip(total, part))
    return total + part


def _balle17_metrics(rd_loss, mse, bpp) -> Dict[str, torch.Tensor]:
    mse = mse.detach()
    return {"rd_loss": rd_loss.detach(), "mse": mse, "bpp": bpp.detach(),
            "psnr": 10.0 * torch.log10(1.0 / torch.clamp(mse, min=1e-10))}


def _run_step(state: TrainState, loss_of: Callable):
    """One update: ``loss_of()`` → (loss, metrics) under the forward's
    range, the backward, the clamp and Adam; returns the metrics."""
    with torch.profiler.record_function("train_step/forward"):
        loss, metrics = loss_of()
    with torch.profiler.record_function("train_step/backward"):
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
    with torch.profiler.record_function("train_step/optimizer"):
        apply_gradients(state)
    return metrics


def make_balle17_train_step(train_lambda: float = 8192.0, distortion: str = "mse"):
    """``train_step(state, batch, generator)``: rd_loss = λ·d + bpp with d the
    MSE, or 1 − MS-SSIM for ``msssim``; one update; the metrics
    ``rd_loss``, ``mse``, ``bpp`` and ``psnr`` (detached tensors). Splits
    over a mesh's data and tile axes (tiles of 16 columns)."""
    if distortion not in ("mse", "msssim"):
        # a DSC loss string ('l1') or typo ('ms_ssim') must not silently
        # train the whole run as MSE
        raise ValueError(f"balle17 distortion must be 'mse' or 'msssim', got {distortion!r}")

    def train_step(state: TrainState, batch: torch.Tensor,
                   generator: Optional[torch.Generator]) -> Dict[str, torch.Tensor]:
        def loss_of():
            out = state.model(batch, train=True, generator=generator)
            if distortion == "msssim":
                d = 1.0 - ms_ssim(out["recon"], batch, win_size=msssim_window(batch))
            else:
                d = out["mse"]
            rd_loss = train_lambda * d + out["bpp"]
            return rd_loss, _balle17_metrics(rd_loss, out["mse"], out["bpp"])

        return _run_step(state, loss_of)

    def mesh_loss(split):
        dev = split.device
        sse = bits = ms_sums = ms_counts = None
        n_el = n_pix = 0
        for r, row in enumerate(split.models):
            tiles = split.batches[0][r]
            outs = ([row[0](tiles[0], train=True, generator=split.noise[r][0])]
                    if len(row) == 1 else tiled_balle17_train(row, tiles, split.noise[r]))
            for out, x in zip(outs, tiles):
                pixels = x.numel() // 3  # an RGB image's pixels, blocked or not
                sse = _add(sse, (out["mse"] * x.numel()).to(dev))
                bits = _add(bits, (out["bpp"] * pixels).to(dev))
                n_el += x.numel()
                n_pix += pixels
            if distortion == "msssim":
                x = gather_tiles(tiles)
                sums, counts = ms_ssim_sums(gather_tiles([o["recon"] for o in outs]), x,
                                            win_size=msssim_window(x))
                ms_sums, ms_counts = _add(ms_sums, sums.to(dev)), _add(ms_counts, counts)
        mse, bpp = sse / n_el, bits / n_pix
        d = 1.0 - ms_ssim_of_sums(ms_sums, ms_counts) if distortion == "msssim" else mse
        rd_loss = train_lambda * d + bpp
        return rd_loss, _balle17_metrics(rd_loss, mse, bpp)

    return TrainStep(train_step, mesh_loss, tile_unit=16)


def make_dsc_train_step(w_full: float = 1.0, w_base: float = 1.0, w_z: float = 0.0):
    """``train_step(state, im1, im2, generator)`` for a ``DSCStereoModel``:
    loss = w_full·loss_full + w_base·loss (the base branch's) [+ w_z·loss_z]
    (reference train_2StepsNet.py:190, train_new.py:177); one update; the
    metrics ``loss``, ``loss_full``, ``loss_base`` and ``loss_z`` (detached
    tensors). Splits over a mesh's data and tile axes (tiles of 32 columns,
    the code's downsampling); the split step refuses what the JAX trainer
    cannot train (``models.dsc.refuse_untrainable``)."""

    def total(loss_base, loss_full, loss_z):
        loss = w_full * loss_full + w_base * loss_base
        if w_z:
            loss = loss + w_z * loss_z
        return loss, {"loss": loss.detach(), "loss_full": loss_full.detach(),
                      "loss_base": loss_base.detach(), "loss_z": loss_z.detach()}

    def train_step(state: TrainState, im1: torch.Tensor, im2: torch.Tensor,
                   generator: Optional[torch.Generator]) -> Dict[str, torch.Tensor]:
        def loss_of():
            out = state.model(im1, im2, train=True, generator=generator)
            return total(out["loss"], out["loss_full"], out["loss_z"])

        return _run_step(state, loss_of)

    def mesh_loss(split):
        cfg, dev = split.models[0][0].config, split.device
        refuse_untrainable(cfg)  # FIF's batch statistics are the whole batch's
        sums, counts = {}, {}
        for r, row in enumerate(split.models):
            im1, im2 = split.batches[0][r], split.batches[1][r]
            outs = ([row[0].outputs(im1[0], im2[0], train=True, generator=split.noise[r][0])]
                    if len(row) == 1 else tiled_dsc_train(row, im1, im2, split.noise[r]))
            terms = [loss_terms(cfg, o, a, b) for o, a, b in zip(outs, im1, im2)]
            for name in terms[0]:
                pairs = [t[name] for t in terms]
                if cfg.loss == "msssim":
                    s, c = ms_ssim_sums(gather_tiles([a for a, _ in pairs]),
                                        gather_tiles([b for _, b in pairs]),
                                        win_size=cfg.msssim_win)
                    s = s.to(dev)
                else:
                    s = sum(elementwise_error(cfg, a, b).sum().to(dev) for a, b in pairs)
                    c = sum(a.numel() for a, _ in pairs)
                sums[name], counts[name] = _add(sums.get(name), s), _add(counts.get(name), c)

        def value(name):
            if cfg.loss == "msssim":
                return ms_ssim_of_sums(sums[name], counts[name])
            return sums[name] / counts[name]

        return total(*loss_triplet(cfg, value, torch.zeros((), device=dev)))

    return TrainStep(train_step, mesh_loss, tile_unit=32)


def make_hyperprior_train_step(train_lambda: float = 8192.0,
                               tiled: Callable = tiled_hyperprior_train):
    """``train_step(state, batch, generator)`` for a ``ScaleHyperprior`` or
    a ``JointAutoregressive``: rd_loss = λ·mse + bpp (bpp_y + bpp_z); one
    update; the metrics ``rd_loss``, ``mse``, ``bpp``, ``bpp_y`` and
    ``bpp_z`` (detached tensors). Splits over a mesh's data and tile axes
    (tiles of 64 columns, ẑ's downsampling; a W-tiled data row through
    ``tiled``, the model's W-tiled train forward:
    ``parallel.halo.tiled_hyperprior_train``, or ``tiled_joint_train`` for
    the joint codec)."""

    def metrics_of(rd_loss, parts):
        return {"rd_loss": rd_loss.detach(), **{k: v.detach() for k, v in parts.items()}}

    def train_step(state: TrainState, batch: torch.Tensor,
                   generator: Optional[torch.Generator]) -> Dict[str, torch.Tensor]:
        def loss_of():
            out = state.model(batch, train=True, generator=generator)
            rd_loss = train_lambda * out["mse"] + out["bpp"]
            return rd_loss, metrics_of(rd_loss, {k: out[k] for k in
                                                 ("mse", "bpp", "bpp_y", "bpp_z")})

        return _run_step(state, loss_of)

    def mesh_loss(split):
        dev = split.device
        sse = bits_y = bits_z = None
        n_el = n_pix = 0
        for r, row in enumerate(split.models):
            tiles = split.batches[0][r]
            outs = ([row[0](tiles[0], train=True, generator=split.noise[r][0])]
                    if len(row) == 1 else tiled(row, tiles, split.noise[r]))
            for out, x in zip(outs, tiles):
                pixels = x.numel() // x.shape[3]
                sse = _add(sse, (out["mse"] * x.numel()).to(dev))
                bits_y = _add(bits_y, (out["bpp_y"] * pixels).to(dev))
                bits_z = _add(bits_z, (out["bpp_z"] * pixels).to(dev))
                n_el += x.numel()
                n_pix += pixels
        mse = sse / n_el
        bpp = (bits_y + bits_z) / n_pix
        rd_loss = train_lambda * mse + bpp
        return rd_loss, metrics_of(rd_loss, {"mse": mse, "bpp": bpp, "bpp_y": bits_y / n_pix,
                                             "bpp_z": bits_z / n_pix})

    return TrainStep(train_step, mesh_loss, tile_unit=64)


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
