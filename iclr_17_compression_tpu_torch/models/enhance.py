"""The enhancement nets, NHWC: the FIF dilated-conv trunk (also the DSC
``fif_0031bpp`` preset's), the FIF enhancement head and the gated final
enhancer.

Counterpart of ``iclr_17_compression_tpu/models/enhance.py``.

- ``ConvBlock``: circular padding by the dilation (``wrap_pad``), a VALID
  dilated 3×3 conv (identity weight init, zero bias), LeakyReLU(0.2),
  ``AdaptiveBatchNorm``; ``convblk.0`` / ``convblk.2`` as the reference's
  ``basic_blocks.py`` names them.
- ``AdaptiveBatchNorm``: a·x + b·BN(x), scalars a (init 1) and b (init 0).
  BN is written out, not ``nn.BatchNorm2d``, to give flax's
  ``BatchNorm(momentum=0.9, epsilon=1e-5)`` exactly: with ``train=True`` it
  normalizes by the batch's mean and its biased variance
  max(0, E[x²] − E[x]²) and moves the running statistics by
  running = 0.9·running + 0.1·batch (torch's momentum would be 0.1 and its
  running variance unbiased); with ``train=False`` it normalizes by the
  running statistics. Those are buffers (``bn.running_mean``,
  ``bn.running_var``) in the ``state_dict``; the JAX package keeps them in
  its ``batch_stats`` collection.
- ``FIF``: five ConvBlocks at dilations 1, 2, 4, 8, 1, named ``conv1``-
  ``conv4`` and ``conv8`` as in the reference's ``FIF_net.py`` (the JAX
  package's ``conv5``).
- ``FIFEnhance``: the trunk at ``features`` channels over any input, then a
  1×1 conv (``out_conv``) to a 3-channel residual.
- ``FinalEnhanceNet``: over cat(recon, side information), two branches of
  three ``ResidualBlock``s (``conv_a``; ``conv_b`` with a 1×1 conv
  after), gated a·σ(b), then ResidualBlock ×2, an ``AttentionBlock`` and
  ResidualBlock ×2 down to a 3-channel residual (reference
  final_enhance_net.py:32-64; keys ``conv_a.{0,1,2}``, ``conv_b.{0..3}``,
  ``final_block.{0..4}``). ``init_`` draws torch's default conv init.
"""

import torch
from torch import nn

from ..nn.blocks import AttentionBlock, ResidualBlock, _LeakyReLU, init_dsc_
from ..nn.layers import TorchConv
from ..ops import conv as ops_conv

FIF_DILATIONS = (1, 2, 4, 8, 1)
FIF_NAMES = ("conv1", "conv2", "conv3", "conv4", "conv8")
BN_MOMENTUM, BN_EPS = 0.9, 1e-5


def _identity_conv_init(weight: torch.Tensor) -> None:
    """An OIHW kernel that passes input channel i to output channel i."""
    cout, cin, kh, kw = weight.shape
    with torch.no_grad():
        weight.zero_()
        for i in range(min(cin, cout)):
            weight[i, i, kh // 2, kw // 2] = 1.0


class FlaxBatchNorm(nn.Module):
    """BatchNorm over the channel axis of NHWC with flax's semantics (see
    the module docstring); parameters ``weight`` (flax ``scale``) and
    ``bias``."""

    def __init__(self, ch: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(ch))
        self.bias = nn.Parameter(torch.zeros(ch))
        self.register_buffer("running_mean", torch.zeros(ch))
        self.register_buffer("running_var", torch.ones(ch))

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        if train:
            axes = tuple(range(x.dim() - 1))
            mean = x.mean(dim=axes)
            var = torch.clamp((x * x).mean(dim=axes) - mean * mean, min=0.0)
            with torch.no_grad():
                self.running_mean.mul_(BN_MOMENTUM).add_((1.0 - BN_MOMENTUM) * mean)
                self.running_var.mul_(BN_MOMENTUM).add_((1.0 - BN_MOMENTUM) * var)
        else:
            mean, var = self.running_mean, self.running_var
        return (x - mean) * (torch.rsqrt(var + BN_EPS) * self.weight) + self.bias


class AdaptiveBatchNorm(nn.Module):
    """a·x + b·BN(x) with scalar a and b."""

    def __init__(self, ch: int):
        super().__init__()
        self.a = nn.Parameter(torch.ones(()))
        self.b = nn.Parameter(torch.zeros(()))
        self.bn = FlaxBatchNorm(ch)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        return self.a * x + self.b * self.bn(x, train)


class CircularDilatedConv(nn.Conv2d):
    """A k×k conv of dilation d on NHWC after circular padding by d, VALID:
    identity weight, zero bias."""

    def __init__(self, cin: int, cout: int, kernel_size: int = 3, dilation: int = 1):
        super().__init__(cin, cout, kernel_size, dilation=dilation)
        _identity_conv_init(self.weight)
        with torch.no_grad():
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        d = self.dilation[0]
        return ops_conv.conv2d(wrap_pad(x, d), self.weight, self.bias, dilation=d)


def wrap_pad(x: torch.Tensor, d: int) -> torch.Tensor:
    """NHWC padded by ``d`` on each side of H and W with the opposite edge's
    pixels, wrapping as often as ``d`` needs (``jnp.pad(mode="wrap")``;
    ``F.pad``'s circular mode wraps at most once)."""
    _, h, w, _ = x.shape
    rows = torch.arange(-d, h + d, device=x.device) % h
    cols = torch.arange(-d, w + d, device=x.device) % w
    return x.index_select(1, rows).index_select(2, cols)


class ConvBlock(nn.Module):
    """Circular-padded dilated conv → LeakyReLU(0.2) → AdaptiveBatchNorm."""

    def __init__(self, cin: int, features: int, kernel_size: int = 3, dilation: int = 1):
        super().__init__()
        self.convblk = nn.Sequential(CircularDilatedConv(cin, features, kernel_size, dilation),
                                     nn.Identity(), AdaptiveBatchNorm(features))

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        conv, _, abn = self.convblk
        return abn(_LeakyReLU.apply(conv(x), 0.2), train)


class FIF(nn.Module):
    """Fast-image-filter trunk: ConvBlocks at dilations 1, 2, 4, 8, 1."""

    def __init__(self, features: int = 256):
        super().__init__()
        for name, dil in zip(FIF_NAMES, FIF_DILATIONS):
            setattr(self, name, ConvBlock(features, features, 3, dil))

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        for name in FIF_NAMES:
            x = getattr(self, name)(x, train)
        return x


class FIFEnhance(nn.Module):
    """FIF-style enhancement head: ConvBlocks at dilations 1, 2, 4, 8, 1
    (the first from ``in_channels``), then a 1×1 conv to 3 channels."""

    def __init__(self, in_channels: int, features: int = 64):
        super().__init__()
        for i, (name, dil) in enumerate(zip(FIF_NAMES, FIF_DILATIONS)):
            setattr(self, name, ConvBlock(in_channels if i == 0 else features, features, 3, dil))
        self.out_conv = TorchConv(features, 3, 1)

    def init_(self, generator: torch.Generator) -> "FIFEnhance":
        """The identity convs stay; torch's default init for ``out_conv``."""
        return init_dsc_(self, generator)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        for name in FIF_NAMES:
            x = getattr(self, name)(x, train)
        return self.out_conv(x)


class FinalEnhanceNet(nn.Module):
    """Gated residual enhancer over cat(recon, side information) (6
    channels); returns the 3-channel residual to add to the recon."""

    def __init__(self, n: int = 64, act: str = "leaky_relu", in_channels: int = 6):
        super().__init__()
        self.conv_a = nn.Sequential(ResidualBlock(in_channels, n, act), ResidualBlock(n, n, act),
                                    ResidualBlock(n, n, act))
        self.conv_b = nn.Sequential(ResidualBlock(in_channels, n, act), ResidualBlock(n, n, act),
                                    ResidualBlock(n, n, act), TorchConv(n, n, 1))
        self.final_block = nn.Sequential(ResidualBlock(n, n, act), ResidualBlock(n, n, act),
                                         AttentionBlock(n), ResidualBlock(n, n, act),
                                         ResidualBlock(n, 3, act))

    def init_(self, generator: torch.Generator) -> "FinalEnhanceNet":
        """torch's default conv init, drawn from ``generator``."""
        return init_dsc_(self, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.final_block(self.conv_a(x) * torch.sigmoid(self.conv_b(x)))
