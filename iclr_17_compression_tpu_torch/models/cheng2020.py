"""Joint-autoregressive hierarchical-prior codec (the Cheng-2020 anchor).

Counterpart of ``iclr_17_compression_tpu/models/cheng2020.py``:

- transforms: residual-block g_a (÷16), conv3×3 h_a (÷4), subpel h_s (×4,
  out 2N), residual + subpel g_s (×16), each an indexed ``nn.Sequential``
  whose keys are the CompressAI keys ``import_joint`` maps (``g_a.0``-``6``,
  ``h_a.0/2/4/6/8``, ``h_s.0/2/4/6/8``, ``g_s.0``-``7``);
- context model: a 5×5 mask-A conv (M → 2M), ``context_prediction``;
- entropy parameters: 1×1 convs 4M → 10M/3 → 8M/3 → 2M, split (scales,
  means) in that order (``entropy_parameters.0/2/4``);
- rates: y against N(mu, sigma), z against the factorized BitEstimator
  (``bitEstimator_z``), both clip(−log2 P, 0, 50).

On CUDA each ``ResidualBlockWithStride`` / ``ResidualBlockUpsample`` conv +
(I)GDN pair is one K2 launch (``nn/blocks.py``): three in ``g_a``, three in
``g_s``; every other conv is ``F.conv2d``. Every forward on a CUDA tensor
applies the precision policy's flags (TF32 off at the default).

``compress`` / ``decompress`` write and read real streams. The transforms
and the hyper path run on the model's device (forward convolutions only,
whose cuDNN algorithms give the same bits call after call, so both
directions compute the same hyper decoder output); the sequential part (each
pixel's mu and sigma depend on pixels already coded) runs on the host
(``_HostARContext``): the masked-conv taps and the 1×1 stack as GEMMs over
anti-diagonal wavefronts (``_wavefronts``), against the rANS coder's
streaming decoder. Encoder and decoder run the same host arithmetic, so
mu, sigma and the coded symbols match bit for bit. The host backend is the
caller's explicit choice, ``"native"`` (``coding/ar_native.py``, the
default) or ``"numpy"``: the two differ in the last bits, so a file must be
decoded with the backend that encoded it, and a backend that cannot load
raises. On bf16-stored weights the codec computes in fp32 with the
bf16-rounded weights, as the hyperprior's (``ops.precision.promoted``).

Training (``train=True``) replaces both roundings by additive U(±½)
noise drawn from one explicit generator, ẑ's first and then ŷ's (JAX's
``rng_z, rng_y = split(rng)``); the masked context conv and the entropy
parameters run in one parallel pass, as in the eval forward. The forward
is its pieces (``quantize``, ``context_params``, ``outputs``), which the
W-tiled train forward (``parallel.halo.tiled_joint_train``) calls tile by
tile.
"""

from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..coding.api import StreamingDecoder, decode_latent, encode_latent
from ..coding.gaussian import SCALES_MIN, default_gaussian_codec, default_scale_table, scale_indices
from ..nn.blocks import (ResidualBlock, ResidualBlockUpsample, ResidualBlockWithStride,
                         SubpelConv, _Act, conv1x1, conv3x3, init_dsc_)
from ..nn.layers import BitEstimator, MaskedConv
from ..ops import quant
from ..ops.conv import oihw_to_hwio
from ..ops.entropy import LOG2
from ..ops.precision import promoted
from ..utils.device import precision_on_cuda
from .hyperprior import _device, _host, z_codec

AR_BACKENDS = ("native", "numpy")


def normal_cdf(x: torch.Tensor) -> torch.Tensor:
    return 0.5 * (1.0 + torch.erf(x / np.sqrt(2.0)))


def _clip_bits(prob: torch.Tensor) -> torch.Tensor:
    return torch.clamp(-torch.log(prob + 1e-10) / LOG2, 0.0, 50.0)


def _lrelu() -> nn.Module:
    return _Act("leaky_relu")


class ChengAnalysis(nn.Sequential):
    """g_a (reference models/temp.py:62-71): residual stacks, ÷16."""

    def __init__(self, n: int = 192):
        super().__init__(
            ResidualBlockWithStride(3, n, 2), ResidualBlock(n, n),
            ResidualBlockWithStride(n, n, 2), ResidualBlock(n, n),
            ResidualBlockWithStride(n, n, 2), ResidualBlock(n, n),
            conv3x3(n, n, stride=2),
        )


class ChengHyperAnalysis(nn.Sequential):
    """h_a (reference models/temp.py:73-84): ÷4 on the latent grid."""

    def __init__(self, n: int = 192):
        super().__init__(
            conv3x3(n, n), _lrelu(), conv3x3(n, n), _lrelu(), conv3x3(n, n, stride=2), _lrelu(),
            conv3x3(n, n), _lrelu(), conv3x3(n, n, stride=2),
        )


class ChengHyperSynthesis(nn.Sequential):
    """h_s (reference models/temp.py:86-96): ×4, out 2N channels."""

    def __init__(self, n: int = 192):
        n32 = n * 3 // 2
        super().__init__(
            conv3x3(n, n), _lrelu(), SubpelConv(n, n, 2), _lrelu(),
            conv3x3(n, n32), _lrelu(), SubpelConv(n32, n32, 2), _lrelu(),
            conv3x3(n32, 2 * n),
        )


class ChengSynthesis(nn.Sequential):
    """g_s (reference models/temp.py:98-107): ×16 back to RGB."""

    def __init__(self, n: int = 192):
        super().__init__(
            ResidualBlock(n, n), ResidualBlockUpsample(n, n, 2),
            ResidualBlock(n, n), ResidualBlockUpsample(n, n, 2),
            ResidualBlock(n, n), ResidualBlockUpsample(n, n, 2),
            ResidualBlock(n, n), SubpelConv(n, 3, 2),
        )


class EntropyParameters(nn.Sequential):
    """1×1 convs 4M → 10M/3 → 8M/3 → 2M (scales, means)."""

    def __init__(self, m: int = 192):
        super().__init__(
            conv1x1(4 * m, m * 10 // 3), _lrelu(), conv1x1(m * 10 // 3, m * 8 // 3), _lrelu(),
            conv1x1(m * 8 // 3, 2 * m),
        )


class JointAutoregressive(nn.Module):
    """The end-to-end joint-autoregressive hierarchical-prior codec."""

    # cuDNN's heuristic takes an FFT route for these fp32 3×3 convs at
    # C = 192; a training loop runs this model's steps under
    # ``utils.device.cudnn_autotune`` on the card
    train_cudnn_autotune = True

    def __init__(self, n: int = 192, scale_bound: float = SCALES_MIN):
        super().__init__()
        self.n, self.scale_bound = n, scale_bound
        self.g_a = ChengAnalysis(n)
        self.h_a = ChengHyperAnalysis(n)
        self.h_s = ChengHyperSynthesis(n)
        self.g_s = ChengSynthesis(n)
        self.entropy_parameters = EntropyParameters(n)
        self.context_prediction = MaskedConv(n, 2 * n, 5, mask_type="A", padding=2)
        self.bitEstimator_z = BitEstimator(n)

    def init_(self, generator: torch.Generator) -> "JointAutoregressive":
        """The JAX package's init, drawn from ``generator`` in module order:
        torch's default U(±1/√fan_in) for every conv, the GDN identity,
        Bitparm N(0, 0.01²)."""
        init_dsc_(self, generator)
        for f in (self.bitEstimator_z.f1, self.bitEstimator_z.f2, self.bitEstimator_z.f3,
                  self.bitEstimator_z.f4):
            f.init_(generator)
        return self

    def quantize(self, y: torch.Tensor, z: torch.Tensor, train: bool = False,
                 generator=None) -> Tuple[torch.Tensor, torch.Tensor]:
        """(ẑ, ŷ): the training noise (from ``generator``, or a mesh slot's
        ``ops.quant.SlotNoise``), ẑ's drawn first, else the rounding."""
        if train:
            return (quant.add_uniform_noise(z, generator, 0.5),
                    quant.add_uniform_noise(y, generator, 0.5))
        return torch.round(z), torch.round(y)

    def context_params(self, y_hat: torch.Tensor, hyper: torch.Tensor) -> torch.Tensor:
        """The entropy parameters (scales, then means) of ŷ from the hyper
        decoder's output and ŷ's masked context, in one parallel pass."""
        return self.entropy_parameters(torch.cat([hyper, self.context_prediction(y_hat)], dim=-1))

    def outputs(self, image: torch.Tensor, y_hat: torch.Tensor, z_hat: torch.Tensor,
                params: torch.Tensor, recon: torch.Tensor) -> Dict[str, torch.Tensor]:
        """The forward's dict from its image, ŷ, ẑ, the entropy parameters
        and the unclipped recon: ŷ's Gaussian rate, ẑ's under
        ``bitEstimator_z``, each per pixel of ``image``."""
        sigma = torch.clamp(torch.abs(params[..., : self.n]), min=self.scale_bound)
        mu = params[..., self.n:]
        delta = y_hat - mu
        prob_y = normal_cdf((delta + 0.5) / sigma) - normal_cdf((delta - 0.5) / sigma)
        prob_z = self.bitEstimator_z(z_hat + 0.5) - self.bitEstimator_z(z_hat - 0.5)
        n_img, h, w, _ = image.shape
        n_pixels = n_img * h * w
        bits_y = torch.sum(_clip_bits(prob_y))
        bits_z = torch.sum(_clip_bits(prob_z))
        return {"recon": torch.clamp(recon, 0.0, 1.0), "latent": y_hat, "hyper_latent": z_hat,
                "sigma": sigma, "mu": mu, "mse": torch.mean((recon - image) ** 2),
                "bpp_y": bits_y / n_pixels, "bpp_z": bits_z / n_pixels,
                "bpp": (bits_y + bits_z) / n_pixels}

    def forward(self, image: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        """The forward on an NHWC batch in [0, 1]: the JAX model's dict
        (recon clipped, latent ŷ, hyper_latent ẑ, sigma, mu, mse, bpp_y,
        bpp_z, bpp). The context runs in one parallel masked conv.
        ``train``: the noise quantizers, drawn from ``generator``."""
        precision_on_cuda(image)
        y = self.g_a(image)
        z_hat, y_hat = self.quantize(y, self.h_a(y), train, generator)
        params = self.context_params(y_hat, self.h_s(z_hat))
        return self.outputs(image, y_hat, z_hat, params, self.g_s(y_hat))


# ---------------------------------------------------------------------------
# The file codec: device transforms, the host AR context, rANS.
# ---------------------------------------------------------------------------


class CompressedImage(NamedTuple):
    y_stream: bytes
    z_stream: bytes
    y_shape: Tuple[int, int, int]  # (H/16, W/16, N) of one image
    z_shape: Tuple[int, int, int]
    max_sym: int  # the symbol range the header ships
    z_min: int
    z_max: int

    @property
    def num_bits(self) -> int:
        return 8 * (len(self.y_stream) + len(self.z_stream))


def _wavefronts(h: int, w: int, slope: int = 3):
    """Anti-diagonal wavefronts t = slope·i + j over an (h, w) grid, as
    (rows, cols) arrays. With the 5×5 mask-A context, pixel (i, j) reads
    (i, j-1), (i, j-2) and rows i-1, i-2 at columns ≤ j+2; at slope 3 each
    of those lies on an earlier wavefront (worst (i-1, j+2): t-1), so a
    wavefront's pixels decode as one batch. Symbols are coded in wavefront
    order, ascending row within one."""
    fronts = []
    for t in range(slope * (h - 1) + w):
        i0 = max(0, -(-(t - (w - 1)) // slope))
        i1 = min(h - 1, t // slope)
        if i0 > i1:
            continue
        ii = np.arange(i0, i1 + 1, dtype=np.int64)
        fronts.append((ii, t - slope * ii))
    return fronts


class _HostARContext:
    """The host's copy of ``context_prediction`` + ``entropy_parameters``,
    evaluated over a batch of pixels (one wavefront) at once, identically
    by encoder and decoder.

    Exact refactors, as the JAX package makes them: conv0 of the entropy
    parameters is linear before its leaky ReLU, so its hyper half and both
    biases are evaluated for every pixel in one GEMM up front (``prep``);
    the twelve live taps of the mask-A window (rows i-2, i-1 and the two
    left taps of row i) are one gather and one (P, 12·M) @ (12·M, 2M) GEMM.

    ``backend``: ``"native"`` (``coding/ar_native.py``) or ``"numpy"``;
    ``"native"`` raises if it cannot load.
    """

    def __init__(self, model: JointAutoregressive, backend: str = "native"):
        if backend not in AR_BACKENDS:
            raise ValueError(f"AR host backend must be one of {AR_BACKENDS}, got {backend!r}")

        def host(t):
            return np.ascontiguousarray(t.detach().to("cpu", torch.float32).numpy())

        cp = model.context_prediction
        w = oihw_to_hwio(host(cp.weight))  # (5, 5, M, 2M)
        kh, kw = w.shape[:2]
        mask = np.ones((kh, kw, 1, 1), np.float32)
        mask[kh // 2, kw // 2:] = 0.0
        mask[kh // 2 + 1:] = 0.0
        self.ctx_w = w * mask
        self.ctx_b = host(cp.bias)
        self.ep = [(np.ascontiguousarray(host(conv.weight)[:, :, 0, 0].T), host(conv.bias))
                   for conv in (model.entropy_parameters[0], model.entropy_parameters[2],
                                model.entropy_parameters[4])]
        self.kh, self.kw = kh, kw
        m = w.shape[2]
        self.m = m
        w0, b0 = self.ep[0]
        nh = w0.shape[0] - 2 * m  # the hyper channels feeding conv0 (2M)
        self.w0_h = np.ascontiguousarray(w0[:nh])
        self.w0_c = np.ascontiguousarray(w0[nh:])
        self.b0 = b0
        # the 12 live taps as one (12·M, 2M) matrix; the order is the order
        # of the (row, col) offsets below
        self.w_taps = np.ascontiguousarray(np.concatenate(
            [self.ctx_w[:2].reshape(2 * kw * m, 2 * m),
             self.ctx_w[kh // 2, : kw // 2].reshape((kw // 2) * m, 2 * m)], axis=0))
        offs = [(r, c) for r in range(2) for c in range(kw)] + [
            (kh // 2, c) for c in range(kw // 2)]
        self.off_r = np.array([o[0] for o in offs], np.int64)
        self.off_c = np.array([o[1] for o in offs], np.int64)
        self.backend = backend
        self._native = None
        if backend == "native":
            from ..coding.ar_native import NativeAR

            self._native = NativeAR.create(self.w_taps, self.w0_c, self.ep[1], self.ep[2],
                                           self.off_r, self.off_c, m)

    def prep(self, hyper: np.ndarray) -> np.ndarray:
        """conv0's hyper part and both biases for every pixel:
        (h, w, 2M) → (h, w, C0)."""
        base = hyper.reshape(-1, hyper.shape[-1]) @ self.w0_h
        base += self.b0 + self.ctx_b @ self.w0_c
        return base.reshape(hyper.shape[0], hyper.shape[1], -1)

    def mu_sigma_batch(self, y_hat_pad: np.ndarray, base: np.ndarray, ii: np.ndarray,
                       jj: np.ndarray, scale_bound: float) -> Tuple[np.ndarray, np.ndarray]:
        """(mu, sigma), each (P, M), of the wavefront pixels (ii, jj).
        ``y_hat_pad`` is ŷ zero-padded by kh//2 and kw//2, final wherever
        this wavefront reads. Lanes are padded to a multiple of 16 (BLAS
        sgemm runs far below its rate under 16 rows); padded lanes gather
        pixel (0, 0) and are dropped."""
        if self._native is not None:
            return self._native.mu_sigma(y_hat_pad, base, ii, jj, scale_bound)
        m = self.m
        p_n = ii.shape[0]
        p_pad = -(-p_n // 16) * 16
        if p_pad != p_n:
            zi = np.zeros(p_pad - p_n, np.int64)
            ii = np.concatenate([ii, zi])
            jj = np.concatenate([jj, zi])
        rows = ii[:, None] + self.off_r[None, :]
        cols = jj[:, None] + self.off_c[None, :]
        taps = y_hat_pad[rows, cols].reshape(p_pad, -1)  # (P, 12·M)
        x = base[ii, jj] + (taps @ self.w_taps) @ self.w0_c
        np.maximum(x, 0.01 * x, out=x)  # leaky_relu(0.01)
        x = x @ self.ep[1][0] + self.ep[1][1]
        np.maximum(x, 0.01 * x, out=x)
        x = x @ self.ep[2][0] + self.ep[2][1]
        x = x[:p_n]
        sigma = np.maximum(np.abs(x[:, :m]), scale_bound)
        return x[:, m:], sigma


def ar_encode(host: _HostARContext, y: np.ndarray, hyper: np.ndarray, scale_bound: float):
    """The host AR pass of the encoder over y (h, w, M) and the hyper
    decoder's output (h, w, 2M): (the y stream, max_sym, ŷ (h, w, M), the
    symbols' scale indices in coding order)."""
    h, w, m = y.shape
    pad = host.kh // 2
    y_hat_pad = np.zeros((h + 2 * pad, w + 2 * pad, m), np.float32)
    base = host.prep(hyper)
    sym_parts, sig_parts = [], []
    for ii, jj in _wavefronts(h, w):
        mu, sigma = host.mu_sigma_batch(y_hat_pad, base, ii, jj, scale_bound)
        s = np.round(y[ii, jj] - mu)
        sym_parts.append(s.astype(np.int32).reshape(-1))
        sig_parts.append(sigma.reshape(-1))
        y_hat_pad[ii + pad, jj + pad] = s + mu
    syms = np.concatenate(sym_parts)  # wavefront coding order
    max_sym = max(int(np.abs(syms).max()), 1)
    tids = scale_indices(np.concatenate(sig_parts), default_scale_table())
    stream = default_gaussian_codec(max_sym).encode(syms.astype(np.int64), tids)
    return stream, max_sym, y_hat_pad[pad: pad + h, pad: pad + w].copy(), tids


def ar_decode(host: _HostARContext, stream: bytes, y_shape: Tuple[int, int, int],
              max_sym: int, hyper: np.ndarray, scale_bound: float) -> np.ndarray:
    """The host AR pass of the decoder: ŷ (h, w, M) from the y stream."""
    h, w, m = y_shape
    pad = host.kh // 2
    y_hat_pad = np.zeros((h + 2 * pad, w + 2 * pad, m), np.float32)
    base = host.prep(hyper)
    table = default_scale_table()
    with StreamingDecoder(default_gaussian_codec(max_sym), stream) as dec:
        for ii, jj in _wavefronts(h, w):
            mu, sigma = host.mu_sigma_batch(y_hat_pad, base, ii, jj, scale_bound)
            s = dec.step(scale_indices(sigma, table)).astype(np.float32).reshape(mu.shape)
            y_hat_pad[ii + pad, jj + pad] = s + mu
    return y_hat_pad[pad: pad + h, pad: pad + w].copy()


@torch.no_grad()
def _hyper(model: JointAutoregressive, z_hat: np.ndarray, dev: torch.device) -> np.ndarray:
    return _host(model.h_s(torch.from_numpy(z_hat[None]).to(dev)))


@torch.no_grad()
def compress(model: JointAutoregressive, image: torch.Tensor, return_y_hat: bool = False,
             backend: str = "native"):
    """Encode one image (1, H, W, 3), H and W multiples of 64, to streams,
    with the AR host ``backend``. ``return_y_hat=True`` also returns the
    encoder's ŷ (h, w, M), which the decoder must reproduce bit for bit."""
    if image.shape[0] != 1:
        raise ValueError("compress() codes one image at a time")
    model = promoted(model)
    dev = _device(model)
    host = _HostARContext(model, backend)
    y_t = model.g_a(image.to(dev, torch.float32))
    z = _host(model.h_a(y_t))
    y = _host(y_t)
    z_hat = np.round(z)
    z_min, z_max = int(z_hat.min()), int(z_hat.max())
    z_stream = encode_latent(z_codec(model, z_min, z_max), z_hat.astype(np.int64))
    y_stream, max_sym, y_hat, _ = ar_encode(host, y, _hyper(model, z_hat, dev),
                                            model.scale_bound)
    comp = CompressedImage(y_stream=y_stream, z_stream=z_stream, y_shape=tuple(y.shape),
                           z_shape=tuple(z_hat.shape), max_sym=max_sym, z_min=z_min,
                           z_max=z_max)
    return (comp, y_hat) if return_y_hat else comp


@torch.no_grad()
def decompress(model: JointAutoregressive, comp: CompressedImage, return_y_hat: bool = False,
               quantize_fetch: bool = False, backend: str = "native"):
    """Decode streams to the reconstruction (1, H, W, 3) in [0, 1] on the
    host, with the AR host ``backend`` the file was encoded with.
    ``quantize_fetch`` rounds to the uint8 display grid on the device and
    fetches one byte a channel (returned as float / 255)."""
    model = promoted(model)
    dev = _device(model)
    host = _HostARContext(model, backend)
    z_hat = decode_latent(z_codec(model, comp.z_min, comp.z_max), comp.z_stream,
                          comp.z_shape).astype(np.float32)
    y_hat = ar_decode(host, comp.y_stream, comp.y_shape, comp.max_sym,
                      _hyper(model, z_hat, dev), model.scale_bound)
    recon = torch.clamp(model.g_s(torch.from_numpy(y_hat[None]).to(dev)), 0.0, 1.0)
    if quantize_fetch:
        out = torch.round(recon * 255.0).to(torch.uint8).cpu().numpy().astype(np.float32) / 255.0
    else:
        out = recon.cpu().numpy()
    return (out, y_hat) if return_y_hat else out
