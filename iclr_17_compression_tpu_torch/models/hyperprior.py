"""Scale-hyperprior codec built from the Ballé-2018 transforms.

Counterpart of ``iclr_17_compression_tpu/models/hyperprior.py``:

  y = g_a(x);   z = h_a(y);   ẑ = round(z);   σ = clip(h_s(ẑ), 1e-10, 1e10)
  rate(ẑ)  : the factorized BitEstimator prior
  rate(ŷ)  : Laplace(0, σ):  P = F(ŷ + ½) − F(ŷ − ½)
  quant    : 'round'      ŷ = round(y)
             'sigma-norm' ŷ = round(y/σ)·σ, the symbols round(y/σ) against
                          a unit Laplace

Every rate is the reference's clip(−log2 P, 0, 50), in fp32. Module names
give the reference keys that ``import_hyperprior`` maps: ``Encoder``
(g_a), ``Decoder`` (g_s), ``priorEncoder`` (h_a), ``priorDecoder`` (h_s),
``bitEstimator_z``. On CUDA the encoder's three conv + GDN stages are K2
launches and the decoder's three IGDNs K1 launches (``transforms18.py``);
every forward on a CUDA tensor applies the precision policy's flags
(TF32 off at the default).

``compress`` / ``decompress`` write and read real streams: ẑ against the
BitEstimator's tables (built on the CPU in fp32), ŷ against the σ-indexed
Laplace tables of ``coding/gaussian.py`` ('round' snaps σ to the
log-spaced table; 'sigma-norm' codes against one unit-Laplace row). The
transforms run on the model's device; the latents are rounded on the host
with ``np.round``, as the JAX codec rounds them. Both directions compute σ
from the same ẑ on the same device with the same deterministic cuDNN
algorithms (``ScaleHyperprior.sigma``), so their table indices agree. A file
written on one device and read on another decodes only where no σ lands on
the other side of a table edge (the JAX package has the same property
across its backends). On bf16-stored weights (``ops.precision.cast_storage``)
the codec computes in fp32 with the bf16-rounded weights
(``ops.precision.promoted``: the JAX functions refuse such weights), while
the eval forward of a bf16 image runs in bf16 throughout, as JAX's does.

Training (``train=True``) replaces both roundings by additive U(±½)
noise drawn from one explicit generator, ẑ's first and then ŷ's (or
y/σ's), the counterpart of JAX's ``rng_z, rng_y = split(rng)``; the K2
and K1 launches are then their autograd Functions. The forward is its
pieces (``quantize_z``, ``sigma``, ``quantize_y``, ``outputs``), which the
W-tiled train forward (``parallel.halo.tiled_hyperprior_train``) calls
tile by tile.
"""

from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..coding.api import build_cdf_tables_from_bit_estimator, decode_latent, encode_latent
from ..coding.gaussian import (default_laplace_codec, default_scale_table, scale_indices,
                               unit_laplace_codec)
from ..nn.layers import BitEstimator, init_modules_
from ..ops import quant
from ..ops.entropy import LOG2
from ..ops.precision import promoted
from ..utils.device import apply_precision, cudnn_deterministic, precision_on_cuda
from .transforms18 import Analysis18, AnalysisPrior, Synthesis18, SynthesisPrior

QUANT_MODES = ("round", "sigma-norm")


def laplace_cdf(x: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
    """CDF of Laplace(0, sigma), elementwise."""
    return 0.5 - 0.5 * torch.sign(x) * torch.expm1(-torch.abs(x) / sigma)


def _clip_bits(prob: torch.Tensor) -> torch.Tensor:
    return torch.clamp(-torch.log(prob + 1e-10) / LOG2, 0.0, 50.0)


class ScaleHyperprior(nn.Module):
    def __init__(self, out_channel_n: int = 192, out_channel_m: int = 320,
                 quant: str = "round"):
        super().__init__()
        if quant not in QUANT_MODES:
            raise ValueError(f"quant must be one of {QUANT_MODES}, got {quant!r}")
        n, m = out_channel_n, out_channel_m
        self.out_channel_n, self.out_channel_m, self.quant = n, m, quant
        self.Encoder = Analysis18(n, m)
        self.Decoder = Synthesis18(n, m)
        self.priorEncoder = AnalysisPrior(n, m)
        self.priorDecoder = SynthesisPrior(n, m)
        self.bitEstimator_z = BitEstimator(n)

    def init_(self, generator: torch.Generator) -> "ScaleHyperprior":
        """The JAX package's init (xavier with each layer's gain, biases
        0.01, GDN identity, Bitparm N(0, 0.01²)), drawn from ``generator``
        in module order."""
        return init_modules_(self, generator)

    @staticmethod
    def bound_sigma(raw: torch.Tensor) -> torch.Tensor:
        """σ = clip(h_s(ẑ), 1e-10, 1e10) of the hyper decoder's output."""
        return torch.clamp(raw, 1e-10, 1e10)

    def sigma(self, z_hat: torch.Tensor) -> torch.Tensor:
        """σ of ẑ, with cuDNN held to deterministic algorithms: h_s is
        transposed convs, whose default cuDNN algorithms sum with atomics,
        and the encoder and decoder (and the eval forward) must compute the
        same σ bit for bit."""
        with cudnn_deterministic():
            return self.bound_sigma(self.priorDecoder(z_hat))

    def quantize_z(self, z: torch.Tensor, train: bool = False, generator=None) -> torch.Tensor:
        """ẑ: the training noise (from ``generator``, or a mesh slot's
        ``ops.quant.SlotNoise``), else the rounding."""
        return quant.add_uniform_noise(z, generator, 0.5) if train else torch.round(z)

    def quantize_y(self, y: torch.Tensor, sigma: torch.Tensor, train: bool = False,
                   generator=None) -> Tuple[torch.Tensor, torch.Tensor]:
        """(ŷ, P(ŷ)) of the analysis output ``y`` under σ, by the model's
        quantizer; the noise, where ``train``, drawn after ẑ's."""
        if self.quant == "sigma-norm":
            y_norm = y / sigma
            y_norm_hat = (quant.add_uniform_noise(y_norm, generator, 0.5) if train
                          else torch.round(y_norm))
            ones = torch.ones_like(sigma)
            return (y_norm_hat * sigma,
                    laplace_cdf(y_norm_hat + 0.5, ones) - laplace_cdf(y_norm_hat - 0.5, ones))
        y_hat = quant.add_uniform_noise(y, generator, 0.5) if train else torch.round(y)
        return y_hat, laplace_cdf(y_hat + 0.5, sigma) - laplace_cdf(y_hat - 0.5, sigma)

    def outputs(self, image: torch.Tensor, y_hat: torch.Tensor, z_hat: torch.Tensor,
                sigma: torch.Tensor, prob_y: torch.Tensor,
                recon: torch.Tensor) -> Dict[str, torch.Tensor]:
        """The forward's dict from its image, ŷ, ẑ, σ, P(ŷ) and unclipped
        recon: ẑ's rate under ``bitEstimator_z``, each rate per pixel of
        ``image``."""
        prob_z = self.bitEstimator_z(z_hat + 0.5) - self.bitEstimator_z(z_hat - 0.5)
        bits_y = torch.sum(_clip_bits(prob_y))
        bits_z = torch.sum(_clip_bits(prob_z))
        n_img, h, w, _ = image.shape
        n_pixels = n_img * h * w
        return {"recon": torch.clamp(recon, 0.0, 1.0), "latent": y_hat, "hyper_latent": z_hat,
                "sigma": sigma, "mse": torch.mean((recon - image) ** 2),
                "bpp_y": bits_y / n_pixels, "bpp_z": bits_z / n_pixels,
                "bpp": (bits_y + bits_z) / n_pixels}

    def forward(self, image: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        """The forward on an NHWC batch in [0, 1]: the JAX model's dict
        (recon clipped, latent ŷ, hyper_latent ẑ, sigma, mse, bpp_y, bpp_z,
        bpp). ``train``: the noise quantizers, drawn from ``generator``."""
        precision_on_cuda(image)
        y = self.Encoder(image)
        z_hat = self.quantize_z(self.priorEncoder(y), train, generator)
        sigma = self.sigma(z_hat)
        y_hat, prob_y = self.quantize_y(y, sigma, train, generator)
        return self.outputs(image, y_hat, z_hat, sigma, prob_y, self.Decoder(y_hat))


class CompressedHyper(NamedTuple):
    y_stream: bytes
    z_stream: bytes
    y_shape: Tuple[int, int, int]  # (H/16, W/16, M) of one image
    z_shape: Tuple[int, int, int]
    max_sym: int
    z_min: int
    z_max: int
    quant: str  # 'round' | 'sigma-norm'

    @property
    def num_bits(self) -> int:
        return 8 * (len(self.y_stream) + len(self.z_stream))


def z_codec(model: nn.Module, z_min: int, z_max: int):
    """The ẑ tables of a model's ``bitEstimator_z`` over [z_min, z_max]
    (on the CPU, fp32)."""
    return build_cdf_tables_from_bit_estimator(model.bitEstimator_z.params(), z_min, z_max)


def _device(model: nn.Module) -> torch.device:
    """The model's device (the precision policy applied if it is a card)."""
    dev = next(model.parameters()).device
    if dev.type == "cuda":
        apply_precision()
    return dev


def _host(t: torch.Tensor) -> np.ndarray:
    return t[0].detach().to("cpu", torch.float32).numpy()


@torch.no_grad()
def sigma_of(model: ScaleHyperprior, z_hat: np.ndarray) -> np.ndarray:
    """σ of an (h, w, N) ẑ on the host, computed on the model's device (in
    fp32, on bf16-stored weights too: ``ops.precision.promoted``)."""
    model = promoted(model)
    return _host(model.sigma(torch.from_numpy(z_hat[None]).to(_device(model))))


@torch.no_grad()
def compress(model: ScaleHyperprior, image: torch.Tensor, return_y_hat: bool = False):
    """Encode one image (1, H, W, 3) on the model's device, H and W
    multiples of 64, to streams. ``return_y_hat=True`` also returns the
    encoder's ŷ (h, w, M), which the decoder must reproduce."""
    if image.shape[0] != 1:
        raise ValueError("compress() codes one image at a time")
    model = promoted(model)
    y_t = model.Encoder(image.to(_device(model), torch.float32))
    z = _host(model.priorEncoder(y_t))
    y = _host(y_t)
    z_hat = np.round(z)
    z_min, z_max = int(z_hat.min()), int(z_hat.max())
    z_stream = encode_latent(z_codec(model, z_min, z_max), z_hat.astype(np.int64))
    sigma = sigma_of(model, z_hat)
    if model.quant == "sigma-norm":
        syms = np.round(y / sigma)
        y_hat = syms * sigma
        max_sym = max(int(np.abs(syms).max()), 1)
        codec, tids = unit_laplace_codec(max_sym), np.zeros(syms.size, np.int32)
    else:
        syms = y_hat = np.round(y)
        max_sym = max(int(np.abs(syms).max()), 1)
        codec, tids = default_laplace_codec(max_sym), scale_indices(sigma, default_scale_table())
    comp = CompressedHyper(y_stream=codec.encode(syms.astype(np.int64), tids),
                           z_stream=z_stream, y_shape=tuple(y.shape), z_shape=tuple(z_hat.shape),
                           max_sym=max_sym, z_min=z_min, z_max=z_max, quant=model.quant)
    return (comp, y_hat) if return_y_hat else comp


@torch.no_grad()
def decompress(model: ScaleHyperprior, comp: CompressedHyper, return_y_hat: bool = False):
    """Decode streams to the reconstruction (1, H, W, 3) in [0, 1], on the
    host (and ŷ (h, w, M) with ``return_y_hat``); the transforms run on the
    model's device."""
    model = promoted(model)
    dev = _device(model)
    z_hat = decode_latent(z_codec(model, comp.z_min, comp.z_max), comp.z_stream,
                          comp.z_shape).astype(np.float32)
    sigma = sigma_of(model, z_hat)
    if comp.quant == "sigma-norm":
        tids = np.zeros(int(np.prod(comp.y_shape)), np.int32)
        syms = unit_laplace_codec(comp.max_sym).decode(comp.y_stream, tids)
        y_hat = syms.reshape(comp.y_shape).astype(np.float32) * sigma
    else:
        tids = scale_indices(sigma, default_scale_table())
        syms = default_laplace_codec(comp.max_sym).decode(comp.y_stream, tids)
        y_hat = syms.reshape(comp.y_shape).astype(np.float32)
    recon = model.Decoder(torch.from_numpy(y_hat[None]).to(dev))
    recon = np.clip(recon.cpu().numpy(), 0.0, 1.0)
    return (recon, y_hat) if return_y_hat else recon
