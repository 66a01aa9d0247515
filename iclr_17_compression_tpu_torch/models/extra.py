"""Secondary experimental models, NHWC.

Counterpart of ``iclr_17_compression_tpu/models/extra.py``:

- ``ImageCompressorFC``: Ballé-17 with a fully connected layer over the
  flattened latent (reference model_fc.py:38-86); no training noise, as the
  reference. The latent is flattened in the reference's NCHW order
  (channel, row, column), so ``fc`` is the reference's Linear as it stands;
  the JAX package flattens NHWC and carries the difference in
  ``torch_import._fc_perm``.
- ``LatentCompressor``: the "compress z in two steps" net over frozen
  Ballé-17 latents (reference model_small.py:45-87): a conv stack that
  downsamples z1 to 32 channels, and a stack that rebuilds z1 from
  cat(z1, z2); returns recon_z, z1_down and their MSE.
- ``AnalysisSmall`` / ``SynthesisSmall``: a latent-of-latent codec with a
  fully connected bottleneck 4096 → 2048 → 1024 (reference
  models/analysis_small.py:13-45, models/synthesis_small.py:8-54). Each
  conv or deconv is followed by a GDN or IGDN at ``out_channel_n`` = 512:
  cuDNN and then K1 on the card (K2 takes at most 256 output channels).

Module names give the reference state_dict keys that
``iclr_17_compression_tpu/train/torch_import.py`` reads (``import_fc``,
``import_latent_compressor``, ``import_analysis_small``,
``import_synthesis_small``). ``init_(generator)`` draws the JAX package's
initializers: xavier-normal with each layer's gain and biases 0.01 where the
JAX module names them, torch's default U(±1/√fan_in) for its plain
``TorchConv``s, flax's ``Dense`` default (LeCun-normal, truncated at two
standard deviations; zero bias) for the linear layers, the GDN identity.
"""

import math
from typing import Dict, Tuple

import torch
from torch import nn

from ..nn.layers import (GDN, BitEstimator, TorchConv, TorchConvTranspose, init_modules_,
                         torch_default_init_)
from ..ops.conv import nchw, nhwc
from ..ops.entropy import estimate_bits
from ..utils.device import precision_on_cuda
from .balle17 import Analysis17, Synthesis17

# The linear layers' truncated normal: flax's lecun_normal scales the
# standard normal cut at ±2 by 1/0.8796 so that the variance is 1/fan_in.
_TRUNC_STD = 0.87962566103423978


class Linear(nn.Linear):
    """``nn.Linear`` (weight (out, in), as the reference stores it) with
    flax ``Dense``'s default init."""

    def init_(self, generator: torch.Generator) -> None:
        std = 1.0 / math.sqrt(self.in_features) / _TRUNC_STD
        with torch.no_grad():
            nn.init.trunc_normal_(self.weight, 0.0, std, -2.0 * std, 2.0 * std,
                                  generator=generator)
            self.bias.zero_()


class ImageCompressorFC(nn.Module):
    """Ballé-17 with a fully connected latent layer. ``latent_hw`` is the
    latent grid (the input's H/16, W/16), which sizes ``fc``. ``forward``
    returns the JAX model's dict: recon (clipped), latent (rounded at eval,
    the encoder's output in training), mse (of the unclipped recon), bpp."""

    def __init__(self, out_channel_n: int = 64, latent_hw: Tuple[int, int] = (16, 16)):
        super().__init__()
        n = out_channel_n
        self.out_channel_n, self.latent_hw = n, tuple(latent_hw)
        dim = n * latent_hw[0] * latent_hw[1]
        self.Encoder = Analysis17(n)
        self.Decoder = Synthesis17(n)
        self.bitEstimator = BitEstimator(n)
        self.fc = Linear(dim, dim)

    def init_(self, generator: torch.Generator) -> "ImageCompressorFC":
        return init_modules_(self, generator)

    def forward(self, image: torch.Tensor, train: bool = False) -> Dict[str, torch.Tensor]:
        precision_on_cuda(image)
        n_img, h, w, _ = image.shape
        feature = self.Encoder(image)
        latent = feature if train else torch.round(feature)
        fc = self.fc(nchw(latent).reshape(n_img, -1))
        recon = self.Decoder(nhwc(fc.reshape(nchw(latent).shape)))
        total_bits, _ = estimate_bits(latent.float(), self.bitEstimator.params())
        return {"recon": torch.clamp(recon, 0.0, 1.0), "latent": latent,
                "mse": torch.mean((recon - image) ** 2), "bpp": total_bits / (n_img * h * w)}


class LatentCompressor(nn.Module):
    """Stage-2 latent fusion over frozen Ballé-17 latents z1 (to compress)
    and z2 (side information), both (N, h, w, 128). Keys
    ``conv_down_zx.{0,2,4,6}`` (each followed by a ReLU) and
    ``fc_combine_zx_zy.{0..4}`` (no activations)."""

    def __init__(self, channels: int = 128):
        super().__init__()
        c = channels
        self.conv_down_zx = nn.Sequential(
            TorchConv(c, 64, 3, padding=1), nn.ReLU(), TorchConv(64, 64, 1), nn.ReLU(),
            TorchConv(64, 32, 3, padding=1), nn.ReLU(), TorchConv(32, 32, 1), nn.ReLU())
        self.fc_combine_zx_zy = nn.Sequential(
            TorchConv(2 * c, 256, 7, padding=3), TorchConv(256, 256, 7, padding=3),
            TorchConv(256, 128, 3, padding=1), TorchConv(128, 128, 3, padding=1),
            TorchConv(128, 128, 3, padding=1))

    def init_(self, generator: torch.Generator) -> "LatentCompressor":
        for m in self.modules():
            if isinstance(m, TorchConv):
                torch_default_init_(m, generator)
        return self

    def forward(self, z1: torch.Tensor, z2: torch.Tensor) -> Dict[str, torch.Tensor]:
        precision_on_cuda(z1)
        recon_z = self.fc_combine_zx_zy(torch.cat([z1, z2], dim=-1))
        return {"recon_z": recon_z, "z1_down": self.conv_down_zx(z1),
                "mse": torch.mean((recon_z - z1) ** 2)}


class AnalysisSmall(nn.Module):
    """A ``in_channels``-channel latent (N, grid, grid, C) → a 1024-dim code:
    conv 3×3 → GDN → conv 1×1 → GDN → conv 3×3 → GDN → conv 1×1 to
    ``out_channel_m``, flattened (NCHW order) → fc1 (ReLU) → fc2."""

    def __init__(self, in_channels: int = 1024, out_channel_n: int = 512,
                 out_channel_m: int = 16, grid: int = 16):
        super().__init__()
        n, m, sq2 = out_channel_n, out_channel_m, math.sqrt(2)
        self.grid = grid
        self.conv1 = TorchConv(in_channels, n, 3, padding=1, gain=math.sqrt(2 * (3 + n) / 6))
        self.gdn1 = GDN(n)
        self.conv2 = TorchConv(n, n, 1, gain=sq2)
        self.gdn2 = GDN(n)
        self.conv3 = TorchConv(n, n, 3, padding=1, gain=sq2)
        self.gdn3 = GDN(n)
        self.conv4 = TorchConv(n, m, 1, gain=math.sqrt(2 * (m + n) / (n + n)))
        self.fc1 = nn.Sequential(Linear(m * grid * grid, 2048), nn.ReLU())
        self.fc2 = Linear(2048, 1024)

    def init_(self, generator: torch.Generator) -> "AnalysisSmall":
        return init_modules_(self, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        precision_on_cuda(x)
        x = self.gdn1(self.conv1(x))
        x = self.gdn2(self.conv2(x))
        x = self.gdn3(self.conv3(x))
        x = self.conv4(x)
        return self.fc2(self.fc1(nchw(x).reshape(x.shape[0], -1)))


class SynthesisSmall(nn.Module):
    """A 1024-dim code → fc1 (ReLU) → fc2 (ReLU) to 4096, viewed as an NCHW
    (16, 16, 16) latent → deconv 1×1 → IGDN → deconv 3×3 → IGDN →
    deconv 1×1 → IGDN → deconv 3×3 to 1024 channels, NHWC."""

    def __init__(self, out_channel_n: int = 512, out_channel_m: int = 16):
        super().__init__()
        n, m, sq2 = out_channel_n, out_channel_m, math.sqrt(2)
        self.fc1 = nn.Sequential(Linear(1024, 2048), nn.ReLU())
        self.fc2 = nn.Sequential(Linear(2048, 4096), nn.ReLU())
        self.deconv1 = TorchConvTranspose(16, n, 1, gain=math.sqrt(2 * (m + n) / (m + m)))
        self.igdn1 = GDN(n, inverse=True)
        self.deconv2 = TorchConvTranspose(n, n, 3, padding=1, gain=sq2)
        self.igdn2 = GDN(n, inverse=True)
        self.deconv3 = TorchConvTranspose(n, n, 1, gain=sq2)
        self.igdn3 = GDN(n, inverse=True)
        self.deconv4 = TorchConvTranspose(n, 1024, 3, padding=1,
                                          gain=math.sqrt(2 * (n + 3) / (n + n)))

    def init_(self, generator: torch.Generator) -> "SynthesisSmall":
        return init_modules_(self, generator)

    def forward(self, code: torch.Tensor) -> torch.Tensor:
        precision_on_cuda(code)
        x = self.fc2(self.fc1(code))
        x = nhwc(x.reshape(x.shape[0], 16, 16, 16))
        x = self.igdn1(self.deconv1(x))
        x = self.igdn2(self.deconv2(x))
        x = self.igdn3(self.deconv3(x))
        return self.deconv4(x)
