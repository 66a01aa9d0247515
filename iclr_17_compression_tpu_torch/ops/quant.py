"""Quantizers.

Counterpart of ``iclr_17_compression_tpu/ops/quant.py``. ``round`` is
half-to-even, as ``jnp.round``. Training:

- ``add_uniform_noise``: x + U(-h, h), drawn from an explicit generator
  (the counterpart of an explicit ``jax.random`` key), or, in a step split
  over a device mesh, the slot's part of the whole batch's draw
  (``MeshNoise``);
- ``round_ste`` / ``quantize_coarse_ste``: the eval quantizer forward, the
  identity gradient;
- ``binarize_ste``: (x > 0.5) forward, the identity gradient.
"""

from fractions import Fraction
from typing import Dict, Optional, Tuple

import torch


def round(x: torch.Tensor) -> torch.Tensor:  # noqa: A001 - mirrors jnp.round
    """Round half to even."""
    return torch.round(x)


def quantize_coarse(x: torch.Tensor, step: float = 16.0, clip: float = 128.0) -> torch.Tensor:
    """Round to multiples of ``step`` and clamp to ±clip (step 16, clip 128:
    the 17-level code of the DSC models)."""
    return torch.clamp(torch.round(x / step) * step, -clip, clip)


def uniform_noise(shape, generator: Optional[torch.Generator], half_width: float,
                  device, dtype) -> torch.Tensor:
    """U(-half_width, half_width) of ``shape``, drawn from ``generator`` (the
    default generator of ``device`` if None)."""
    u = torch.rand(shape, generator=generator, device=device, dtype=dtype)
    return u * (2.0 * half_width) - half_width


def add_uniform_noise(x: torch.Tensor, generator, half_width: float = 0.5) -> torch.Tensor:
    """Additive uniform quantization noise U(-half_width, half_width), drawn
    on ``x``'s device from ``generator`` (the default generator if None), or
    ``generator``'s part of the whole batch's draw where it is a
    ``SlotNoise``."""
    if isinstance(generator, SlotNoise):
        return x + generator.take(x, half_width)
    return x + uniform_noise(x.shape, generator, half_width, x.device, x.dtype)


class MeshNoise:
    """The noise of one train step split over a device mesh.

    JAX draws each noise tensor at the whole batch's shape from one
    replicated key and GSPMD slices it for each device. Here draw ``k`` of
    the step is made once, at the whole batch's shape, from ``generator``
    (the one-device step's, so in its order and with its bits), by the
    first slot that reaches it; each slot (``slot``) takes its rows of the
    batch and its columns of the image from it, on its own device.
    ``shape`` is the whole batch's (N, H, W); a noised tensor of H' rows
    spans W·H'/H columns (the image's W-tiles start on multiples of the
    model's downsampling)."""

    def __init__(self, generator: Optional[torch.Generator], shape: Tuple[int, int, int]):
        self.generator = generator
        self.shape = tuple(shape)
        self.drawn: Dict[int, torch.Tensor] = {}

    def slot(self, rows: slice, cols: slice) -> "SlotNoise":
        """The view of batch rows ``rows`` and image columns ``cols``."""
        return SlotNoise(self, rows, cols)


class SlotNoise:
    """One mesh slot's view of a ``MeshNoise``: ``take`` gives the slot's
    part of the step's next draw."""

    def __init__(self, whole: MeshNoise, rows: slice, cols: slice):
        self.whole, self.rows, self.cols = whole, rows, cols
        self.draws = 0

    def take(self, x: torch.Tensor, half_width: float) -> torch.Tensor:
        n, h, w = self.whole.shape
        scale = Fraction(x.shape[1], h)
        width, c0, c1 = (v * scale for v in (w, self.cols.start, self.cols.stop))
        if any(v.denominator != 1 for v in (width, c0, c1)):
            raise ValueError(f"noise of {tuple(x.shape)}: image columns {self.cols} of {w} "
                             f"do not fall on its grid (×{scale})")
        shape = (n, x.shape[1], int(width), x.shape[3])
        k, self.draws = self.draws, self.draws + 1
        full = self.whole.drawn.get(k)
        if full is None:
            gen = self.whole.generator
            full = uniform_noise(shape, gen, half_width, x.device if gen is None else gen.device,
                                 x.dtype)
            self.whole.drawn[k] = full
        if tuple(full.shape) != shape:
            raise ValueError(f"draw {k}: a slot asks for {shape}, the batch drew "
                             f"{tuple(full.shape)}")
        part = full[self.rows, :, int(c0):int(c1)]
        if part.shape != x.shape:
            raise ValueError(f"draw {k}: the slot's part {tuple(part.shape)} is not "
                             f"{tuple(x.shape)}")
        return part.to(x.device)


def round_ste(x: torch.Tensor) -> torch.Tensor:
    """round(x) in the forward pass, identity gradient."""
    return x + (torch.round(x) - x).detach()


def quantize_coarse_ste(x: torch.Tensor, step: float = 16.0, clip: float = 128.0) -> torch.Tensor:
    """The coarse quantizer with a straight-through gradient (clip is hard)."""
    return x + (quantize_coarse(x, step, clip) - x).detach()


class _BinarizeSTE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return (x > 0.5).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        return g


def binarize_ste(x: torch.Tensor) -> torch.Tensor:
    """(x > 0.5) → {0, 1} with the identity backward pass."""
    return _BinarizeSTE.apply(x)
