"""Ballé-2017 codec.

Counterpart of ``iclr_17_compression_tpu/models/balle17.py``:

  analysis : conv 9×9 s4 p4 (3→N) → GDN → conv 5×5 s2 p2 → GDN →
             conv 5×5 s2 p2 (no bias)                        [÷16 spatial]
  synthesis: deconv 5×5 s2 p2 op1 → IGDN → deconv 5×5 s2 p2 op1 → IGDN →
             deconv 9×9 s4 p4 op3 (N→3)                      [×16 spatial]
  quant    : train x+U(-0.5,0.5) (noise-round) or round with a straight-
             through gradient (ste); eval round(x); or the binarized code
             (binarize: sigmoid → (x > 0.5), identity gradient)
  rate     : factorized BitEstimator, bits = Σ clip(-log2 ΔC, 0, 50)

On CUDA the analysis transform runs as three K2 launches
(``analysis17_fused``) and each IGDN as one K1 launch, forward and under
autograd alike; on the CPU every stage is plain PyTorch. Every forward on a
CUDA tensor applies the precision policy's flags
(``utils.device.precision_on_cuda``; at the default, TF32 off), so the cuDNN
convolutions of the forward and of the backward that follows run in fp32,
as the JAX package computes. Module names give the reference state_dict
keys (``Encoder.conv1.weight``, ``Decoder.igdn2.gamma``,
``bitEstimator.f1.h``).

``io_block = 4`` is the JAX package's blocked image I/O: the model takes
``ops.conv.space_to_depth(image, 4)`` and returns a blocked recon; conv1 and
deconv3 run as 3×3 stride-1 convs over 48 channels (conv1 as K2 on CUDA)
with the canonical parameters reinterpreted, so checkpoints are shared with
the unblocked graph. Under ``ops.precision.cast_storage(model,
torch.bfloat16)`` and a bf16 image the forward runs bf16 storage (K1, K2
and K3 in their bf16 variants on CUDA); the rate term stays fp32.
"""

import math
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from ..nn.layers import GDN, BitEstimator, TorchConv, TorchConvTranspose, init_modules_
from ..ops import quant
from ..ops.entropy import estimate_bits
from ..ops.kernels.conv_gdn_kernel import analysis17_fused
from ..utils.device import precision_on_cuda

QUANT_MODES = ("noise-round", "ste", "binarize")


class Analysis17(nn.Module):
    """3-stage analysis transform (÷16), NHWC. ``binarize=True`` is the
    reference's Analysis_net_17_new: sigmoid → binarizer, returning
    (code, pre_binarize)."""

    def __init__(self, out_channel_n: int = 128, binarize: bool = False, input_block: int = 1):
        super().__init__()
        n = out_channel_n
        self.binarize = binarize
        self.conv1 = TorchConv(3, n, 9, stride=4, padding=4, gain=math.sqrt(2 * (3 + n) / 6),
                               input_block=input_block)
        self.gdn1 = GDN(n)
        self.conv2 = TorchConv(n, n, 5, stride=2, padding=2, gain=math.sqrt(2))
        self.gdn2 = GDN(n)
        self.conv3 = TorchConv(n, n, 5, stride=2, padding=2, bias=False, gain=math.sqrt(2))

    def features(self, x: torch.Tensor) -> torch.Tensor:
        """The three stages, before any binarizer."""
        precision_on_cuda(x)
        if x.device.type == "cuda":
            return analysis17_fused(self, x)
        x = self.gdn1(self.conv1(x))
        x = self.gdn2(self.conv2(x))
        return self.conv3(x)

    def forward(self, x: torch.Tensor):
        x = self.features(x)
        if self.binarize:
            pre = torch.sigmoid(x)
            return quant.binarize_ste(pre), pre
        return x


class Synthesis17(nn.Module):
    """3-stage synthesis transform (×16), NHWC; ``output_block = 4`` emits
    the recon space-to-depth-blocked."""

    def __init__(self, out_channel_n: int = 128, output_block: int = 1):
        super().__init__()
        n = out_channel_n
        sq2 = math.sqrt(2)
        self.deconv1 = TorchConvTranspose(n, n, 5, stride=2, padding=2, output_padding=1,
                                          gain=sq2)
        self.igdn1 = GDN(n, inverse=True)
        self.deconv2 = TorchConvTranspose(n, n, 5, stride=2, padding=2, output_padding=1,
                                          gain=sq2)
        self.igdn2 = GDN(n, inverse=True)
        self.deconv3 = TorchConvTranspose(n, 3, 9, stride=4, padding=4, output_padding=3,
                                          gain=sq2, output_block=output_block)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        precision_on_cuda(x)
        x = self.igdn1(self.deconv1(x))
        x = self.igdn2(self.deconv2(x))
        return self.deconv3(x)


class Balle17Compressor(nn.Module):
    """End-to-end Ballé-17 codec. ``forward(image, train, generator)``
    (NHWC in [0, 1]) returns the JAX model's dict:
      recon  : reconstruction clipped to [0, 1]
      latent : the quantized (or, training noise-round, noised) latent
      mse    : mean squared error of the unclipped reconstruction
      bpp    : estimated bits per pixel under the factorized prior; for
               ``binarize``, latent elements per pixel
      pre_binarize : the sigmoid before the binarizer (``binarize`` only)
    ``generator`` draws the training noise of ``noise-round`` (the
    counterpart of the JAX model's explicit ``rng``). ``io_block = 4``:
    blocked image I/O (image and recon ``space_to_depth(·, 4)``); the
    parameters, mse and bpp are those of the unblocked graph.
    """

    def __init__(self, out_channel_n: int = 128, quant: str = "noise-round",
                 io_block: int = 1):
        super().__init__()
        if quant not in QUANT_MODES:
            raise ValueError(f"quant must be one of {QUANT_MODES}, got {quant!r}")
        self.out_channel_n = out_channel_n
        self.quant = quant
        self.io_block = io_block
        self.Encoder = Analysis17(out_channel_n, binarize=quant == "binarize",
                                  input_block=io_block)
        self.Decoder = Synthesis17(out_channel_n, output_block=io_block)
        self.bitEstimator = BitEstimator(out_channel_n)

    def init_(self, generator: torch.Generator) -> "Balle17Compressor":
        """The JAX package's training init (``nn/layers.py``), drawn from
        ``generator`` in module order."""
        return init_modules_(self, generator)

    def quantize(self, feature: torch.Tensor, train: bool = False,
                 generator=None) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """The latent of the analysis' ``feature`` (``Analysis17.features``)
        and the sigmoid before the binarizer (``binarize`` only, else None):
        the binarizer, the training noise (from ``generator``, or a mesh
        slot's ``ops.quant.SlotNoise``) or STE rounding, or the rounding."""
        if self.quant == "binarize":
            pre = torch.sigmoid(feature)
            return quant.binarize_ste(pre), pre
        if train and self.quant == "noise-round":
            return quant.add_uniform_noise(feature, generator, 0.5), None
        if train:
            return quant.round_ste(feature), None
        return quant.round(feature), None

    def outputs(self, image: torch.Tensor, latent: torch.Tensor, recon: torch.Tensor,
                pre_binarize: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        """The forward's dict from its image, latent and unclipped recon."""
        n, h, w, _ = image.shape
        n_pix = n * h * w * self.io_block * self.io_block
        out = {} if pre_binarize is None else {"pre_binarize": pre_binarize}
        out.update(recon=torch.clamp(recon, 0.0, 1.0), latent=latent,
                   mse=torch.mean((recon - image) ** 2))
        if self.quant == "binarize":
            out["bpp"] = torch.tensor(latent.numel() / n_pix, device=image.device)
        else:
            # rate term in fp32 always: the CDF difference of two near-equal
            # sigmoids cancels catastrophically in lower precision
            total_bits, _ = estimate_bits(latent.float(), self.bitEstimator.params())
            out["bpp"] = total_bits / n_pix
        return out

    def forward(self, image: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        precision_on_cuda(image)
        latent, pre = self.quantize(self.Encoder.features(image), train, generator)
        return self.outputs(image, latent, self.Decoder(latent), pre)
