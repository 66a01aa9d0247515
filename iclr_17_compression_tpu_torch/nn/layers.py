"""Base modules with torch-reference parameter layouts, NHWC activations.

Counterpart of ``iclr_17_compression_tpu/nn/layers.py`` (``TorchConv``,
``TorchConvTranspose``, ``MaskedConv``, ``GDN``, ``BitEstimator``). Parameters keep the
reference PyTorch layouts and names, so a port model's ``state_dict()`` has
the reference keys that ``iclr_17_compression_tpu.train.torch_import`` maps:
conv weight OIHW, deconv weight (Cin, Cout, kh, kw), GDN ``beta``/``gamma``
reparameterized, Bitparm ``h``/``b``/``a`` as (C,).

Construction uses torch's default init. Ballé-17 training starts from the
JAX package's initializers instead, drawn from an explicit generator by each
module's ``init_(generator)``: ``xavier_normal_`` with the layer's gain on
conv and deconv weights, biases at 0.01, the GDN identity init, and Bitparm
``h``/``b``/``a`` ~ N(0, 0.01²). The DSC models keep torch's default law
for their convs, drawn from a generator by ``torch_default_init_``. The
values differ from the JAX package's draws (another generator); the
distributions are the same.
"""

import math
from typing import Optional

import torch
from torch import nn

from ..ops import conv as ops_conv
from ..ops import entropy as ops_entropy
from ..ops.gdn import GDNParams, gdn, gdn_param_init


def xavier_normal_(w: torch.Tensor, gain: float, generator: torch.Generator) -> None:
    """``xavier_normal_`` with an explicit gain, in place, over a conv weight
    (Cout, Cin, k, k) or a deconv weight (Cin, Cout, k, k): std =
    gain·sqrt(2 / ((Cin + Cout)·k·k)), symmetric in the two channel counts,
    as ``xavier_normal_gain`` (``iclr_17_compression_tpu/nn/layers.py``)."""
    fan_sum = (w.shape[0] + w.shape[1]) * w.shape[2] * w.shape[3]
    std = gain * math.sqrt(2.0 / fan_sum)
    with torch.no_grad():
        w.copy_(std * torch.randn(w.shape, generator=generator))


def torch_default_init_(conv: nn.Conv2d, generator: torch.Generator) -> None:
    """torch's default conv init, U(±1/√fan_in) for the weight and the bias
    (fan_in = Cin·kh·kw), drawn from ``generator``, in place: the JAX
    package's ``torch_conv_default_init``, which the DSC models use."""
    bound = 1.0 / math.sqrt(conv.weight[0].numel())
    with torch.no_grad():
        conv.weight.uniform_(-bound, bound, generator=generator)
        if conv.bias is not None:
            conv.bias.uniform_(-bound, bound, generator=generator)


def init_modules_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """The JAX package's training init of ``module``, in place: every
    submodule's own ``init_``, drawn from ``generator`` in module order."""
    for m in module.modules():
        if m is not module and hasattr(m, "init_"):
            m.init_(generator)
    return module


class _JaxInit:
    """``init_``: the weight drawn by ``xavier_normal_`` with ``self.gain``,
    the bias (where there is one) set to 0.01."""

    def init_(self, generator: torch.Generator) -> None:
        xavier_normal_(self.weight, self.gain, generator)
        if self.bias is not None:
            with torch.no_grad():
                self.bias.fill_(0.01)


class TorchConv(_JaxInit, nn.Conv2d):
    """``nn.Conv2d`` taking and returning NHWC; ``gain`` is the training
    init's xavier gain.

    ``input_block = s`` (stride s, kernel 2s+1, padding s: the Ballé-17
    conv1): the input comes blocked by ``ops.conv.space_to_depth(x, s)`` and
    the conv runs as a 3×3 stride-1 conv over s²·Cin channels with the
    weight ``block_conv_weight`` gives. The parameter keeps its canonical
    OIHW shape, so checkpoints serve both graphs."""

    def __init__(self, *args, gain: float = 1.0, input_block: int = 1, **kw):
        super().__init__(*args, **kw)
        self.gain = gain
        self.input_block = input_block
        s = input_block
        if s > 1 and (self.kernel_size != (2 * s + 1,) * 2 or self.stride != (s, s)
                      or self.padding != (s, s) or self.dilation != (1, 1)
                      or self.groups != 1):
            raise ValueError("input_block covers the kernel 2s+1 / stride s / padding s conv")

    def blocked_weight(self) -> torch.Tensor:
        """The HWIO weight of the blocked 3×3 stride-1 conv."""
        return ops_conv.block_conv_weight(ops_conv.oihw_to_hwio(self.weight), self.input_block)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.input_block > 1:
            return ops_conv.conv2d(x, ops_conv.hwio_to_oihw(self.blocked_weight()), self.bias,
                                   stride=1, padding=1)
        return ops_conv.conv2d(x, self.weight, self.bias, stride=self.stride,
                               padding=self.padding, dilation=self.dilation)


class TorchConvTranspose(_JaxInit, nn.ConvTranspose2d):
    """``nn.ConvTranspose2d`` taking and returning NHWC; ``gain`` is the
    training init's xavier gain.

    ``output_block = s`` (stride s, kernel 2s+1, padding s, output_padding
    s−1: the Ballé-17 deconv3): the output comes blocked, (B, H, W,
    s²·Cout), from a 3×3 stride-1 conv with the weight
    ``block_deconv_weight`` gives and the bias tiled s² times; un-block it
    with ``ops.conv.depth_to_space(y, s)``. The parameter keeps its
    canonical shape."""

    def __init__(self, *args, gain: float = 1.0, output_block: int = 1, **kw):
        super().__init__(*args, **kw)
        self.gain = gain
        self.output_block = output_block
        s = output_block
        if s > 1 and (self.kernel_size != (2 * s + 1,) * 2 or self.stride != (s, s)
                      or self.padding != (s, s) or self.output_padding != (s - 1, s - 1)
                      or self.dilation != (1, 1) or self.groups != 1):
            raise ValueError("output_block covers the kernel 2s+1 / stride s / padding s / "
                             "output_padding s-1 transposed conv")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = self.output_block
        if s > 1:
            wb = ops_conv.block_deconv_weight(ops_conv.deconv_torch_to_hwio(self.weight), s)
            bb = None if self.bias is None else self.bias.repeat(s * s)
            return ops_conv.conv2d(x, ops_conv.hwio_to_oihw(wb), bb, stride=1, padding=1)
        return ops_conv.conv_transpose2d(
            x, self.weight, self.bias, stride=self.stride, padding=self.padding,
            output_padding=self.output_padding,
        )


class MaskedConv(TorchConv):
    """PixelCNN-style masked conv, NHWC: mask A hides the centre tap and
    everything after it in raster order, mask B everything after the
    centre. The mask multiplies the OIHW weight at call time (a buffer
    outside the state_dict), so the stored weight is the reference's
    ``context_prediction.weight``. ``init_`` is torch's default U(±1/√fan_in),
    as the JAX ``MaskedConv`` draws it."""

    def __init__(self, cin: int, cout: int, kernel_size: int, mask_type: str = "A",
                 stride: int = 1, padding: int = 0):
        if mask_type not in ("A", "B"):
            raise ValueError(f"bad mask_type {mask_type!r}")
        super().__init__(cin, cout, kernel_size, stride=stride, padding=padding)
        kh, kw = self.kernel_size
        mask = torch.ones(kh, kw)
        mask[kh // 2, kw // 2 + (mask_type == "B"):] = 0.0
        mask[kh // 2 + 1:] = 0.0
        self.register_buffer("mask", mask, persistent=False)

    def init_(self, generator: torch.Generator) -> None:
        torch_default_init_(self, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return ops_conv.conv2d(x, self.weight * self.mask, self.bias, stride=self.stride,
                               padding=self.padding)


class GDN(nn.Module):
    """(Inverse) generalized divisive normalization over channels (NHWC).
    On CUDA it runs the K1 kernel."""

    def __init__(self, ch: int, inverse: bool = False):
        super().__init__()
        init = gdn_param_init(ch)
        self.inverse = inverse
        self.beta = nn.Parameter(init.beta)
        self.gamma = nn.Parameter(init.gamma)

    def init_(self, generator: Optional[torch.Generator] = None) -> None:
        """The identity-like init (deterministic: draws nothing)."""
        init = gdn_param_init(self.beta.shape[0])
        with torch.no_grad():
            self.beta.copy_(init.beta)
            self.gamma.copy_(init.gamma)

    def params(self) -> GDNParams:
        return GDNParams(self.beta, self.gamma)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return gdn(x, self.params(), inverse=self.inverse)


class Bitparm(nn.Module):
    """One layer of the factorized CDF (reference models/bitEstimator.py)."""

    def __init__(self, channel: int, final: bool = False):
        super().__init__()
        self.final = final
        self.h = nn.Parameter(0.01 * torch.randn(channel))
        self.b = nn.Parameter(0.01 * torch.randn(channel))
        self.a = None if final else nn.Parameter(0.01 * torch.randn(channel))

    def init_(self, generator: torch.Generator) -> None:
        """h, b, a ~ N(0, 0.01²), in that order."""
        with torch.no_grad():
            for p in (self.h, self.b, self.a):
                if p is not None:
                    p.copy_(0.01 * torch.randn(p.shape, generator=generator))

    def params(self) -> ops_entropy.BitparmParams:
        return ops_entropy.BitparmParams(self.h, self.b, self.a)


class BitEstimator(nn.Module):
    """Factorized-prior cumulative CDF C(x), per channel: (..., C) → (0, 1)."""

    def __init__(self, channel: int):
        super().__init__()
        self.f1 = Bitparm(channel)
        self.f2 = Bitparm(channel)
        self.f3 = Bitparm(channel)
        self.f4 = Bitparm(channel, final=True)

    def params(self) -> ops_entropy.BitEstimatorParams:
        return ops_entropy.BitEstimatorParams(
            self.f1.params(), self.f2.params(), self.f3.params(), self.f4.params()
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return ops_entropy.bit_estimator_cdf(x, self.params())
