"""Parallax attention (PAM) of the DSC ``pam_0031bpp`` preset, NHWC.

Counterpart of part of ``iclr_17_compression_tpu/models/passr.py``:
``_disk``, ``_morph``, ``clean_mask``, ``ResB`` and ``PAM``. ``PASSRnet``
and ``ResASPPB`` are not ported yet.

- ``ResB``: 3×3 conv (no bias) → LeakyReLU(0.1) → 3×3 conv (no bias), plus
  the input; keys ``body.0`` / ``body.2`` as the reference's.
- ``PAM``: per-row W×W attention between the left and right features
  (``torch.matmul`` over (N·H, W, C) batches), a validity mask from the
  attention mass (> 0.1, no gradient) cleaned by morphology, and a 1×1
  fusion conv over cat(attended right values, left input, mask). With
  ``train=True`` it also returns both attention maps, the cycle maps and
  both masks, as the JAX module does.
- ``clean_mask``: binary closing then opening with a disk of radius 3, each
  dilation or erosion a convolution of the {0, 1} mask with the disk
  thresholded at 0.5 (dilation: any hit) or at |disk| − 0.5 (erosion: all
  hits), zero padding outside, as the JAX package computes it.
"""

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..nn.blocks import _LeakyReLU
from ..nn.layers import TorchConv
from ..ops.conv import nchw, nhwc


def _disk(radius: int) -> np.ndarray:
    y, x = np.ogrid[-radius: radius + 1, -radius: radius + 1]
    return (x * x + y * y <= radius * radius).astype(np.float32)


def _morph(mask: torch.Tensor, selem: np.ndarray, op: str) -> torch.Tensor:
    """Binary dilation or erosion of an NHWC (…, 1) {0, 1} mask by a flat
    structuring element."""
    r = selem.shape[0] // 2
    k = torch.from_numpy(selem).to(mask.device, torch.float32)[None, None]
    hits = nhwc(F.conv2d(nchw(mask.to(torch.float32)).contiguous(), k, padding=r))
    if op == "dilate":
        return (hits > 0.5).to(mask.dtype)
    return (hits >= float(selem.sum()) - 0.5).to(mask.dtype)


def clean_mask(mask: torch.Tensor, radius: int = 3) -> torch.Tensor:
    """Closing then opening with ``_disk(radius)``."""
    selem = _disk(radius)
    m = _morph(_morph(mask, selem, "dilate"), selem, "erode")  # closing
    return _morph(_morph(m, selem, "erode"), selem, "dilate")   # opening


class _LeakyReLU01(nn.Module):
    """LeakyReLU(0.1) with JAX's derivative 1 at 0."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _LeakyReLU.apply(x, 0.1)


class ResB(nn.Module):
    """3×3 conv → LeakyReLU(0.1) → 3×3 conv, plus the input (no biases)."""

    def __init__(self, channels: int):
        super().__init__()
        self.body = nn.Sequential(
            TorchConv(channels, channels, 3, padding=1, bias=False), _LeakyReLU01(),
            TorchConv(channels, channels, 3, padding=1, bias=False))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.body(x) + x


def _row_attention(q_map: torch.Tensor, s_map: torch.Tensor) -> torch.Tensor:
    """(N, H, W, C) × (N, H, W, C) → the rows' softmax(q sᵀ), (N, H, W, W)."""
    return torch.softmax(torch.matmul(q_map, s_map.transpose(-1, -2)), dim=-1)


def _valid(m: torch.Tensor) -> torch.Tensor:
    """The cleaned validity mask (N, H, W, 1) of an attention map: where the
    attention mass a column receives exceeds 0.1."""
    return clean_mask((m.detach().sum(dim=2) > 0.1).to(torch.float32)[..., None])


class PAM(nn.Module):
    """Parallax attention over image rows (reference models/PASSRnet.py:113-178)."""

    def __init__(self, channels: int):
        super().__init__()
        c = channels
        self.rb = ResB(c)
        self.b1 = TorchConv(c, c, 1)
        self.b2 = TorchConv(c, c, 1)
        self.b3 = TorchConv(c, c, 1)
        self.fusion = TorchConv(2 * c + 1, c, 1)

    def forward(self, x_left: torch.Tensor, x_right: torch.Tensor, train: bool = False):
        buf_l, buf_r = self.rb(x_left), self.rb(x_right)
        m_r2l = _row_attention(self.b1(buf_l), self.b2(buf_r))  # (N, H, W, W)
        m_l2r = _row_attention(self.b1(buf_r), self.b2(buf_l))
        v_l2r = _valid(m_l2r)
        fused = torch.matmul(m_r2l, self.b3(x_right))
        out = self.fusion(torch.cat([fused, x_left, v_l2r.to(x_left.dtype)], dim=-1))
        if not train:
            return out
        v_r2l = _valid(m_r2l)
        m_lrl = torch.matmul(m_r2l, m_l2r)
        m_rlr = torch.matmul(m_l2r, m_r2l)
        return out, (m_r2l, m_l2r), (m_lrl, m_rlr), (v_l2r, v_r2l)

