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

Each transform's layer order is written once, in ``transform(run, x)``:
``forward`` runs it under ``Layers`` (one device), the W-tiled train
forward under ``parallel.halo.TileLayers`` (each conv with halos).
"""

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..nn.layers import GDN, TorchConv, TorchConvTranspose
from ..ops.kernels.conv_gdn_kernel import conv_gdn_module


class Layers:
    """How a transform's layers run on one device: ``conv_gdn(x, conv,
    gdn)`` the conv and GDN of those names as one call (K2 on the card),
    ``layer(x, name)`` the layer ``name``, ``each(fn, x)`` an elementwise
    ``fn``. ``parallel.halo.TileLayers`` runs the same transforms tile by
    tile."""

    def __init__(self, mods: nn.Module):
        self.mods = mods

    def conv_gdn(self, x, conv: str, gdn: str):
        return conv_gdn_module(x, getattr(self.mods, conv), getattr(self.mods, gdn))

    def layer(self, x, name: str):
        return getattr(self.mods, name)(x)

    def each(self, fn, x):
        return fn(x)


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
        return self.transform(Layers(self), x)

    def transform(self, run, x):
        for i in (1, 2, 3):
            x = run.conv_gdn(x, f"conv{i}", f"gdn{i}")
        return run.layer(x, "conv4")


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
        return self.transform(Layers(self), x)

    def transform(self, run, x):
        for i in (1, 2, 3):
            x = run.layer(run.layer(x, f"deconv{i}"), f"igdn{i}")
        return run.layer(x, "deconv4")


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
        return self.transform(Layers(self), y)

    def transform(self, run, y):
        x = run.each(F.relu, run.layer(run.each(torch.abs, y), "conv1"))
        x = run.each(F.relu, run.layer(x, "conv2"))
        return run.layer(x, "conv3")


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
        return self.transform(Layers(self), z)

    def transform(self, run, z):
        x = run.each(F.relu, run.layer(z, "deconv1"))
        x = run.each(F.relu, run.layer(x, "deconv2"))
        return run.each(torch.exp, run.layer(x, "deconv3"))
