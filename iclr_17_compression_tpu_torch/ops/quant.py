"""Quantizers.

Counterpart of ``iclr_17_compression_tpu/ops/quant.py``. ``round`` is
half-to-even, as ``jnp.round``. Training:

- ``add_uniform_noise``: x + U(-h, h), drawn from an explicit generator
  (the counterpart of an explicit ``jax.random`` key);
- ``round_ste`` / ``quantize_coarse_ste``: the eval quantizer forward, the
  identity gradient;
- ``binarize_ste``: (x > 0.5) forward, the identity gradient.
"""

from typing import Optional

import torch


def round(x: torch.Tensor) -> torch.Tensor:  # noqa: A001 - mirrors jnp.round
    """Round half to even."""
    return torch.round(x)


def quantize_coarse(x: torch.Tensor, step: float = 16.0, clip: float = 128.0) -> torch.Tensor:
    """Round to multiples of ``step`` and clamp to ±clip (step 16, clip 128:
    the 17-level code of the DSC models)."""
    return torch.clamp(torch.round(x / step) * step, -clip, clip)


def add_uniform_noise(x: torch.Tensor, generator: Optional[torch.Generator],
                      half_width: float = 0.5) -> torch.Tensor:
    """Additive uniform quantization noise U(-half_width, half_width), drawn
    on ``x``'s device from ``generator`` (the default generator if None)."""
    u = torch.rand(x.shape, generator=generator, device=x.device, dtype=x.dtype)
    return x + (u * (2.0 * half_width) - half_width)


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
