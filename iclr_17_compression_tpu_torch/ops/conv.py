"""Torch-semantics convolutions on NHWC tensors, and weight layouts.

Counterpart of ``iclr_17_compression_tpu/ops/conv.py`` (``conv2d``,
``conv_transpose2d``, ``pixel_shuffle``) and of the layout helpers in
``iclr_17_compression_tpu/train/torch_import.py``. Activations are NHWC at
every public function, as in the JAX package. Inside, the convolutions run
as ``F.conv2d`` / ``F.conv_transpose2d`` on an NCHW view of the same memory
(channels-last strides, so no copy), as the JAX package leaves them to XLA.

``conv2d`` takes the JAX package's opt-in space-to-depth lowering of
small-Cin strided convs (``ICLR17C_S2D=1``, ``conv_s2d``); the blocked image
I/O of Ballé-17 (``space_to_depth`` / ``depth_to_space`` at the data layer,
``block_conv_weight`` / ``block_deconv_weight`` for the edge convs) keeps
the JAX functions' layouts: block channel order (r_h, r_w, c), weights HWIO.

Weight layouts:
  JAX conv weight   HWIO (kh, kw, Cin, Cout)
  torch conv weight OIHW (Cout, Cin, kh, kw)
  JAX deconv weight HWIO of the equivalent forward conv, spatially
                    pre-flipped (``torch_deconv_weight_to_hwio``)
  torch deconv      (Cin, Cout, kh, kw), as ``F.conv_transpose2d`` takes it
"""

import os

import numpy as np
import torch
import torch.nn.functional as F


def hwio_to_oihw(w):
    """JAX conv weight → torch conv weight (numpy or torch)."""
    return w.transpose(3, 2, 0, 1) if isinstance(w, np.ndarray) else w.permute(3, 2, 0, 1)


def oihw_to_hwio(w):
    """torch conv weight → JAX conv weight (numpy or torch)."""
    return w.transpose(2, 3, 1, 0) if isinstance(w, np.ndarray) else w.permute(2, 3, 1, 0)


def deconv_hwio_to_torch(w: np.ndarray) -> np.ndarray:
    """JAX pre-flipped deconv weight → torch ConvTranspose2d weight; the
    inverse of ``torch_import.torch_deconv_weight_to_hwio``."""
    return np.ascontiguousarray(np.flip(w.transpose(2, 3, 0, 1), axis=(2, 3)))


def deconv_torch_to_hwio(w: torch.Tensor) -> torch.Tensor:
    """torch ConvTranspose2d weight (Cin, Cout, kh, kw) → the JAX package's
    pre-flipped equivalent-forward HWIO (``torch_deconv_weight_to_hwio``),
    differentiable."""
    return w.flip(2, 3).permute(2, 3, 0, 1)


def _pair(v):
    return (int(v), int(v)) if isinstance(v, int) else (int(v[0]), int(v[1]))


def _s2d_enabled() -> bool:
    """Opt-in (``ICLR17C_S2D=1``, read at each call as the JAX package reads
    it): the space-to-depth lowering of small-Cin strided convs."""
    return os.environ.get("ICLR17C_S2D", "0") == "1"


def nchw(x: torch.Tensor) -> torch.Tensor:
    """NHWC tensor → NCHW view (channels-last strides, no copy)."""
    return x.permute(0, 3, 1, 2)


def nhwc(x: torch.Tensor) -> torch.Tensor:
    """NCHW tensor → contiguous NHWC (no copy for a channels-last tensor)."""
    return x.permute(0, 2, 3, 1).contiguous()


def conv2d(x: torch.Tensor, w: torch.Tensor, b=None, *, stride: int = 1,
           padding: int = 0, dilation: int = 1) -> torch.Tensor:
    """NHWC conv with ``nn.Conv2d`` semantics; ``w`` is OIHW. On the CPU the
    input is made contiguous NCHW first: oneDNN's backward of convolutions
    on channels-last views corrupts the heap on the DSC stacks (torch 2.13
    CPU, oneDNN 3.12), and the CPU path is the reference, not the fast one.
    With ``ICLR17C_S2D=1`` a strided conv of at most 4 input channels runs
    as ``conv_s2d``, as in the JAX package."""
    if (_pair(dilation) == (1, 1) and max(_pair(stride)) > 1 and x.shape[3] <= 4
            and _s2d_enabled()):
        out = conv_s2d(x, oihw_to_hwio(w), _pair(stride), _pair(padding))
        return out if b is None else out + b
    xc = nchw(x)
    if x.device.type == "cpu":
        xc = xc.contiguous()
    return nhwc(F.conv2d(xc, w, b, stride=stride, padding=padding, dilation=dilation))


def conv_transpose2d(x: torch.Tensor, w: torch.Tensor, b=None, *, stride: int = 1,
                     padding: int = 0, output_padding: int = 0) -> torch.Tensor:
    """NHWC transposed conv with ``nn.ConvTranspose2d`` semantics; ``w`` is
    (Cin, Cout, kh, kw). Output size (H-1)*s - 2p + k + op."""
    return nhwc(F.conv_transpose2d(nchw(x), w, b, stride=stride, padding=padding,
                                   output_padding=output_padding))


def pixel_shuffle(x: torch.Tensor, r: int) -> torch.Tensor:
    """NHWC ``nn.PixelShuffle(r)``: (N, H, W, Cout·r·r) → (N, H·r, W·r, Cout),
    the input channels in torch's order (c_out, r_h, r_w), as the JAX
    ``pixel_shuffle`` takes them."""
    return x if r == 1 else nhwc(F.pixel_shuffle(nchw(x), r))


def conv_s2d(x: torch.Tensor, w: torch.Tensor, strides, pads) -> torch.Tensor:
    """A strided conv as space-to-depth + a dense stride-1 conv (exact), the
    JAX package's ``_conv_s2d``: ``x`` NHWC, ``w`` HWIO, no bias. The input
    is pre-padded left by pl = ceil(p/s)·s, cut into s×s blocks on the
    channel axis (order (r_h, r_w, c)), and the kernel zero-padded to s·K2
    taps and folded the same way."""
    sh, sw = strides
    ph, pw = pads
    kh, kw, cin, cout = w.shape
    n, h, win, _ = x.shape
    hout = (h + 2 * ph - kh) // sh + 1
    wout = (win + 2 * pw - kw) // sw + 1
    plh, plw = -(-ph // sh) * sh, -(-pw // sw) * sw
    qh, qw = plh - ph, plw - pw
    k2h, k2w = (kh - 1 + qh) // sh + 1, (kw - 1 + qw) // sw + 1
    lh, lw = sh * (hout + k2h - 1), sw * (wout + k2w - 1)
    xp = F.pad(x, (0, 0, plw, max(0, lw - win - plw), plh, max(0, lh - h - plh)))[:, :lh, :lw]
    xb = xp.reshape(n, lh // sh, sh, lw // sw, sw, cin).permute(0, 1, 3, 2, 4, 5)
    xb = xb.reshape(n, lh // sh, lw // sw, sh * sw * cin)
    wp = F.pad(w, (0, 0, 0, 0, qw, sw * k2w - kw - qw, qh, sh * k2h - kh - qh))
    w2 = wp.reshape(k2h, sh, k2w, sw, cin, cout).permute(0, 2, 1, 3, 4, 5)
    w2 = w2.reshape(k2h, k2w, sh * sw * cin, cout)
    xc = nchw(xb)
    if x.device.type == "cpu":
        xc = xc.contiguous()
    return nhwc(F.conv2d(xc, hwio_to_oihw(w2)))


def _transpose(x, axes):
    return x.transpose(axes) if isinstance(x, np.ndarray) else x.permute(axes)


def space_to_depth(x, r: int):
    """NHWC (B, H, W, C) → (B, H/r, W/r, r·r·C), block layout (r_h, r_w, c):
    the JAX package's data-layer blocking, on numpy arrays or tensors."""
    if r == 1:
        return x
    n, h, w, c = x.shape
    x = _transpose(x.reshape(n, h // r, r, w // r, r, c), (0, 1, 3, 2, 4, 5))
    return x.reshape(n, h // r, w // r, r * r * c)


def depth_to_space(x, r: int):
    """The inverse of ``space_to_depth``."""
    if r == 1:
        return x
    n, h, w, cb = x.shape
    c = cb // (r * r)
    x = _transpose(x.reshape(n, h, w, r, r, c), (0, 1, 3, 2, 4, 5))
    return x.reshape(n, h * r, w * r, c)


def block_conv_weight(w: torch.Tensor, s: int) -> torch.Tensor:
    """(k, k, Cin, Cout) HWIO weight of a stride-s conv with k = 2s+1 and
    padding s (the Ballé-17 conv1) → the (3, 3, s²·Cin, Cout) HWIO weight of
    the same conv over ``space_to_depth(x, s)`` at stride 1, padding 1: tap
    di = s·q + r, the taps past k zero (the JAX package's derivation)."""
    k, _, cin, cout = w.shape
    if k != 2 * s + 1:
        raise ValueError(f"block_conv_weight: kernel {k} is not 2s+1 for s={s}")
    w = F.pad(w, (0, 0, 0, 0, 0, 3 * s - k, 0, 3 * s - k))
    w = w.reshape(3, s, 3, s, cin, cout).permute(0, 2, 1, 3, 4, 5)
    return w.reshape(3, 3, s * s * cin, cout)


def block_deconv_weight(w: torch.Tensor, s: int) -> torch.Tensor:
    """(k, k, Cin, Cout) pre-flipped HWIO weight of a stride-s transposed conv
    with k = 2s+1, padding s, output_padding s−1 (the Ballé-17 deconv3) →
    the (3, 3, Cin, s²·Cout) HWIO weight of a stride-1, padding-1 conv that
    emits the output space-to-depth-blocked: front-pad by s−1, fold the taps
    as (3, s) and reverse the phase axis (the JAX package's derivation)."""
    k, _, cin, cout = w.shape
    if k != 2 * s + 1:
        raise ValueError(f"block_deconv_weight: kernel {k} is not 2s+1 for s={s}")
    w = F.pad(w, (0, 0, 0, 0, s - 1, 0, s - 1, 0))
    w = w.reshape(3, s, 3, s, cin, cout).flip(1, 3).permute(0, 2, 4, 1, 3, 5)
    return w.reshape(3, 3, cin, s * s * cout)
