"""PASSRnet, parallax-attention stereo super-resolution, and its parallax
attention (PAM, also the DSC ``pam_0031bpp`` preset's fusion), NHWC.

Counterpart of ``iclr_17_compression_tpu/models/passr.py`` (reference
models/PASSRnet.py:7-178, train_PASSRnet.py:110-140).

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
- ``ResASPPB``: three stages of three dilated 3×3 convs (dilations 1, 4,
  8; LeakyReLU(0.1)) and a 1×1 bottleneck each, summed with the input.
- ``PASSRnet``: a feature extractor per eye (conv, ResB, ResASPPB, ResB,
  ResASPPB, ResB), PAM, then four ResBs, a 1×1 conv to C·r², a pixel
  shuffle by r and two 3×3 convs to RGB; keys ``init_feature_left``,
  ``init_feature_right``, ``pam`` and ``upscale`` as the reference's.
  ``init_`` draws torch's default conv init, as the JAX module's.
- ``passr_losses``: SR MSE + attention smoothness + cycle + photometric
  losses.
"""

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..nn.blocks import PixelShuffle, _LeakyReLU, init_dsc_
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



class ResASPPB(nn.Module):
    """Three atrous stages (``conv{j}_{i}.0``: 3×3 at dilations 1, 4, 8, no
    bias, LeakyReLU(0.1); ``b_{i}``: 1×1 over their concatenation), each
    fed the last; the input plus the three stages' outputs."""

    DILATIONS = (1, 4, 8)

    def __init__(self, channels: int):
        super().__init__()
        c = channels
        for i in (1, 2, 3):
            for j, dil in enumerate(self.DILATIONS):
                setattr(self, f"conv{j + 1}_{i}", nn.Sequential(
                    TorchConv(c, c, 3, padding=dil, dilation=dil, bias=False), _LeakyReLU01()))
            setattr(self, f"b_{i}", TorchConv(3 * c, c, 1, bias=False))

    def _stage(self, x: torch.Tensor, i: int) -> torch.Tensor:
        cat = torch.cat([getattr(self, f"conv{j + 1}_{i}")(x) for j in range(3)], dim=-1)
        return getattr(self, f"b_{i}")(cat)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b1 = self._stage(x, 1)
        b2 = self._stage(b1, 2)
        b3 = self._stage(b2, 3)
        return x + b1 + b2 + b3


def _feature_extractor(c: int) -> nn.Sequential:
    return nn.Sequential(TorchConv(3, c, 3, padding=1, bias=False), _LeakyReLU01(), ResB(c),
                         ResASPPB(c), ResB(c), ResASPPB(c), ResB(c))


class PASSRnet(nn.Module):
    """Stereo SR (reference models/PASSRnet.py:7-58). ``forward(x_left,
    x_right, train)`` returns the SR left image; with ``train=True`` also
    PAM's attention maps, cycle maps and validity masks."""

    def __init__(self, upscale_factor: int = 2, channels: int = 64):
        super().__init__()
        c, r = channels, upscale_factor
        self.init_feature_left = _feature_extractor(c)
        self.init_feature_right = _feature_extractor(c)
        self.pam = PAM(c)
        self.upscale = nn.Sequential(
            ResB(c), ResB(c), ResB(c), ResB(c), TorchConv(c, c * r * r, 1, bias=False),
            PixelShuffle(r), TorchConv(c, 3, 3, padding=1, bias=False),
            TorchConv(3, 3, 3, padding=1, bias=False))

    def init_(self, generator: torch.Generator) -> "PASSRnet":
        """torch's default conv init, drawn from ``generator``."""
        return init_dsc_(self, generator)

    def forward(self, x_left: torch.Tensor, x_right: torch.Tensor, train: bool = False):
        buf_l = self.init_feature_left(x_left)
        buf_r = self.init_feature_right(x_right)
        if not train:
            return self.upscale(self.pam(buf_l, buf_r))
        buf, ms, cycles, vs = self.pam(buf_l, buf_r, train=True)
        return self.upscale(buf), ms, cycles, vs


def passr_losses(sr, hr, ms, cycles, vs, lr_left, lr_right, w_smooth: float = 0.005,
                 w_cycle: float = 0.005, w_photo: float = 0.005) -> dict:
    """SR MSE + attention smoothness (L1 of neighbouring rows and columns of
    both maps) + cycle (the cycle maps against the identity) + photometric
    (the right image warped by M_r2l against the left, inside v_l2r)."""
    m_r2l, m_l2r = ms
    m_lrl, m_rlr = cycles
    v_l2r, _ = vs
    loss_sr = torch.mean((sr - hr) ** 2)

    def smooth(m):
        return (torch.mean(torch.abs(m[:, 1:] - m[:, :-1]))
                + torch.mean(torch.abs(m[:, :, 1:] - m[:, :, :-1])))

    loss_smooth = smooth(m_r2l) + smooth(m_l2r)
    eye = torch.eye(lr_left.shape[2], device=sr.device, dtype=sr.dtype)
    loss_cycle = torch.mean(torch.abs(m_lrl - eye)) + torch.mean(torch.abs(m_rlr - eye))
    warped_l = torch.matmul(m_r2l, lr_right)
    loss_photo = torch.mean(torch.abs((warped_l - lr_left) * v_l2r))
    total = loss_sr + w_smooth * loss_smooth + w_cycle * loss_cycle + w_photo * loss_photo
    return {"loss": total, "loss_sr": loss_sr, "loss_smooth": loss_smooth,
            "loss_cycle": loss_cycle, "loss_photo": loss_photo}
