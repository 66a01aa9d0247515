"""Ballé-2017 codec, eval forward.

Counterpart of ``iclr_17_compression_tpu/models/balle17.py``:

  analysis : conv 9×9 s4 p4 (3→N) → GDN → conv 5×5 s2 p2 → GDN →
             conv 5×5 s2 p2 (no bias)                        [÷16 spatial]
  synthesis: deconv 5×5 s2 p2 op1 → IGDN → deconv 5×5 s2 p2 op1 → IGDN →
             deconv 9×9 s4 p4 op3 (N→3)                      [×16 spatial]
  quant    : eval round(x)
  rate     : factorized BitEstimator, bits = Σ clip(-log2 ΔC, 0, 50)

On CUDA the analysis transform runs as three K2 launches
(``analysis17_fused``) and each IGDN as one K1 launch; on the CPU every
stage is plain PyTorch. Module names give the reference state_dict keys
(``Encoder.conv1.weight``, ``Decoder.igdn2.gamma``, ``bitEstimator.f1.h``).
The training modes (noise, straight-through, binarize) belong to the
training slice.
"""

from typing import Dict

import torch
from torch import nn

from ..nn.layers import GDN, BitEstimator, TorchConv, TorchConvTranspose
from ..ops import quant
from ..ops.entropy import estimate_bits
from ..ops.kernels.conv_gdn_kernel import analysis17_fused


class Analysis17(nn.Module):
    """3-stage analysis transform (÷16), NHWC."""

    def __init__(self, out_channel_n: int = 128):
        super().__init__()
        n = out_channel_n
        self.conv1 = TorchConv(3, n, 9, stride=4, padding=4)
        self.gdn1 = GDN(n)
        self.conv2 = TorchConv(n, n, 5, stride=2, padding=2)
        self.gdn2 = GDN(n)
        self.conv3 = TorchConv(n, n, 5, stride=2, padding=2, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.device.type == "cuda":
            return analysis17_fused(self, x)
        x = self.gdn1(self.conv1(x))
        x = self.gdn2(self.conv2(x))
        return self.conv3(x)


class Synthesis17(nn.Module):
    """3-stage synthesis transform (×16), NHWC."""

    def __init__(self, out_channel_n: int = 128):
        super().__init__()
        n = out_channel_n
        self.deconv1 = TorchConvTranspose(n, n, 5, stride=2, padding=2, output_padding=1)
        self.igdn1 = GDN(n, inverse=True)
        self.deconv2 = TorchConvTranspose(n, n, 5, stride=2, padding=2, output_padding=1)
        self.igdn2 = GDN(n, inverse=True)
        self.deconv3 = TorchConvTranspose(n, 3, 9, stride=4, padding=4, output_padding=3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.igdn1(self.deconv1(x))
        x = self.igdn2(self.deconv2(x))
        return self.deconv3(x)


class Balle17Compressor(nn.Module):
    """End-to-end Ballé-17 codec. ``forward(image)`` (NHWC in [0, 1]) returns
    the eval-mode dict of the JAX model:
      recon  : reconstruction clipped to [0, 1]
      latent : round(analysis(image))
      mse    : mean squared error of the unclipped reconstruction
      bpp    : estimated bits per pixel under the factorized prior
    """

    def __init__(self, out_channel_n: int = 128):
        super().__init__()
        self.out_channel_n = out_channel_n
        self.Encoder = Analysis17(out_channel_n)
        self.Decoder = Synthesis17(out_channel_n)
        self.bitEstimator = BitEstimator(out_channel_n)

    def forward(self, image: torch.Tensor) -> Dict[str, torch.Tensor]:
        n, h, w, _ = image.shape
        latent = quant.round(self.Encoder(image))
        recon = self.Decoder(latent)
        mse = torch.mean((recon - image) ** 2)
        # rate term in fp32 always: the CDF difference of two near-equal
        # sigmoids cancels catastrophically in lower precision
        total_bits, _ = estimate_bits(latent.float(), self.bitEstimator.params())
        return {
            "recon": torch.clamp(recon, 0.0, 1.0),
            "latent": latent,
            "mse": mse,
            "bpp": total_bits / (n * h * w),
        }
