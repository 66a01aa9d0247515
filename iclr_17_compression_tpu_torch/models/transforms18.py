"""Ballé-2018 four-stage transforms and the hyperprior transforms, NHWC.

Counterpart of ``iclr_17_compression_tpu/models/transforms18.py``:

  Analysis18     : 3× (conv 5×5 s2 p2 + GDN), then conv 5×5 s2 p2 N→M (÷16)
  Synthesis18    : 3× (deconv 5×5 s2 p2 op1 + IGDN), then deconv N→3 (×16)
  AnalysisPrior  : |y| → conv 3×3 s1 → ReLU → conv 5×5 s2 → ReLU → conv 5×5 s2
  SynthesisPrior : deconv 5×5 s2 op1 → ReLU ×2 → deconv 3×3 s1 → exp (σ > 0)

Layer names are the reference's (``conv{i}``, ``gdn{i}``, ``deconv{i}``,
``igdn{i}``), so under a ``ScaleHyperprior`` the state_dict keys are those
``import_hyperprior`` (``iclr_17_compression_tpu/train/torch_import.py``)
maps. On CUDA ``Analysis18`` runs conv1-3 with their GDNs as three K2
launches (``conv_gdn_module``); conv4 (Cout = M = 320, beyond K2's 256) is
``F.conv2d``, as the JAX package computes it outside any Pallas kernel.
Each IGDN of ``Synthesis18`` is one K1 launch; the deconvolutions and the
prior transforms are cuDNN. On the CPU every stage is plain PyTorch.
``init_`` gains are the JAX package's xavier gains, biases 0.01.
"""

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..nn.layers import GDN, TorchConv, TorchConvTranspose
from ..ops.kernels.conv_gdn_kernel import conv_gdn_module


def _deconv(cin: int, cout: int, k: int, stride: int, gain: float) -> TorchConvTranspose:
    return TorchConvTranspose(cin, cout, k, stride=stride, padding=k // 2,
                              output_padding=stride - 1, gain=gain)


class Analysis18(nn.Module):
    def __init__(self, out_channel_n: int = 192, out_channel_m: int = 320):
        super().__init__()
        n, m = out_channel_n, out_channel_m
        sq2 = math.sqrt(2)
        self.conv1 = TorchConv(3, n, 5, stride=2, padding=2, gain=math.sqrt(2 * (3 + n) / 6))
        self.gdn1 = GDN(n)
        self.conv2 = TorchConv(n, n, 5, stride=2, padding=2, gain=sq2)
        self.gdn2 = GDN(n)
        self.conv3 = TorchConv(n, n, 5, stride=2, padding=2, gain=sq2)
        self.gdn3 = GDN(n)
        self.conv4 = TorchConv(n, m, 5, stride=2, padding=2,
                               gain=math.sqrt(2 * (m + n) / (n + n)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for conv, gdn in ((self.conv1, self.gdn1), (self.conv2, self.gdn2),
                          (self.conv3, self.gdn3)):
            x = conv_gdn_module(x, conv, gdn)
        return self.conv4(x)


class Synthesis18(nn.Module):
    def __init__(self, out_channel_n: int = 192, out_channel_m: int = 320):
        super().__init__()
        n, m = out_channel_n, out_channel_m
        sq2 = math.sqrt(2)
        self.deconv1 = _deconv(m, n, 5, 2, math.sqrt(2 * (m + n) / (m + m)))
        self.igdn1 = GDN(n, inverse=True)
        self.deconv2 = _deconv(n, n, 5, 2, sq2)
        self.igdn2 = GDN(n, inverse=True)
        self.deconv3 = _deconv(n, n, 5, 2, sq2)
        self.igdn3 = GDN(n, inverse=True)
        self.deconv4 = _deconv(n, 3, 5, 2, math.sqrt(2 * (n + 3) / (n + n)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.igdn1(self.deconv1(x))
        x = self.igdn2(self.deconv2(x))
        x = self.igdn3(self.deconv3(x))
        return self.deconv4(x)


class AnalysisPrior(nn.Module):
    def __init__(self, out_channel_n: int = 192, out_channel_m: int = 320):
        super().__init__()
        n, m = out_channel_n, out_channel_m
        sq2 = math.sqrt(2)
        self.conv1 = TorchConv(m, n, 3, stride=1, padding=1,
                               gain=math.sqrt(2 * (m + n) / (m + m)))
        self.conv2 = TorchConv(n, n, 5, stride=2, padding=2, gain=sq2)
        self.conv3 = TorchConv(n, n, 5, stride=2, padding=2, gain=sq2)

    def forward(self, y: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.conv1(torch.abs(y)))
        x = F.relu(self.conv2(x))
        return self.conv3(x)


class SynthesisPrior(nn.Module):
    """The hyper-decoder: σ = exp(net(ẑ))."""

    def __init__(self, out_channel_n: int = 192, out_channel_m: int = 320):
        super().__init__()
        n, m = out_channel_n, out_channel_m
        sq2 = math.sqrt(2)
        self.deconv1 = _deconv(n, n, 5, 2, sq2)
        self.deconv2 = _deconv(n, n, 5, 2, sq2)
        self.deconv3 = _deconv(n, m, 3, 1, math.sqrt(2 * (m + n) / (n + n)))

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.deconv1(z))
        x = F.relu(self.deconv2(x))
        return torch.exp(self.deconv3(x))
