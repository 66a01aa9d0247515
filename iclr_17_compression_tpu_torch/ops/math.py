"""Elementwise math with custom gradients.

Counterpart of ``iclr_17_compression_tpu/ops/math.py``. ``lower_bound`` is
``max(x, bound)`` whose backward lets the gradient through where the input
is at or above the bound OR the upstream gradient is negative (it would push
the value back up), so clamped GDN parameters stay trainable.
"""

import torch


class _LowerBound(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, bound):
        ctx.save_for_backward(x >= bound)
        return torch.clamp(x, min=bound)

    @staticmethod
    def backward(ctx, g):
        (above,) = ctx.saved_tensors
        return torch.where(above | (g < 0), g, torch.zeros_like(g)), None


def lower_bound(x: torch.Tensor, bound: float) -> torch.Tensor:
    return _LowerBound.apply(x, bound)
