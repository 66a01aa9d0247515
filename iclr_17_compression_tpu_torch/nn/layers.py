"""Base modules with torch-reference parameter layouts, NHWC activations.

Counterpart of ``iclr_17_compression_tpu/nn/layers.py`` (``TorchConv``,
``TorchConvTranspose``, ``GDN``, ``BitEstimator``). Parameters keep the
reference PyTorch layouts and names, so a port model's ``state_dict()`` has
the reference keys that ``iclr_17_compression_tpu.train.torch_import`` maps:
conv weight OIHW, deconv weight (Cin, Cout, kh, kw), GDN ``beta``/``gamma``
reparameterized, Bitparm ``h``/``b``/``a`` as (C,).

Initialization is torch's default here: the port loads trained weights;
training-time init belongs to the training slice.
"""

import torch
from torch import nn

from ..ops import conv as ops_conv
from ..ops import entropy as ops_entropy
from ..ops.gdn import GDNParams, gdn, gdn_param_init


class TorchConv(nn.Conv2d):
    """``nn.Conv2d`` taking and returning NHWC."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return ops_conv.conv2d(x, self.weight, self.bias, stride=self.stride,
                               padding=self.padding)


class TorchConvTranspose(nn.ConvTranspose2d):
    """``nn.ConvTranspose2d`` taking and returning NHWC."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return ops_conv.conv_transpose2d(
            x, self.weight, self.bias, stride=self.stride, padding=self.padding,
            output_padding=self.output_padding,
        )


class GDN(nn.Module):
    """(Inverse) generalized divisive normalization over channels (NHWC).
    On CUDA it runs the K1 kernel."""

    def __init__(self, ch: int, inverse: bool = False):
        super().__init__()
        init = gdn_param_init(ch)
        self.inverse = inverse
        self.beta = nn.Parameter(init.beta)
        self.gamma = nn.Parameter(init.gamma)

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
