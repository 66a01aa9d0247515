"""Eval-mode quantizers.

Counterpart of the eval half of ``iclr_17_compression_tpu/ops/quant.py``.
``round`` is half-to-even, as ``jnp.round``. The training quantizers (noise,
straight-through, binarize) belong to the training slice.
"""

import torch


def round(x: torch.Tensor) -> torch.Tensor:  # noqa: A001 - mirrors jnp.round
    """Round half to even."""
    return torch.round(x)


def quantize_coarse(x: torch.Tensor, step: float = 16.0, clip: float = 128.0) -> torch.Tensor:
    """Round to multiples of ``step`` and clamp to ±clip (step 16, clip 128:
    the 17-level code of the DSC models)."""
    return torch.clamp(torch.round(x / step) * step, -clip, clip)
