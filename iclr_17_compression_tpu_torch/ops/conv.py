"""Torch-semantics convolutions on NHWC tensors, and weight layouts.

Counterpart of ``iclr_17_compression_tpu/ops/conv.py`` (``conv2d``,
``conv_transpose2d``, ``pixel_shuffle``) and of the layout helpers in
``iclr_17_compression_tpu/train/torch_import.py``. Activations are NHWC at
every public function, as in the JAX package. Inside, the convolutions run
as ``F.conv2d`` / ``F.conv_transpose2d`` on an NCHW view of the same memory
(channels-last strides, so no copy), as the JAX package leaves them to XLA.

Weight layouts:
  JAX conv weight   HWIO (kh, kw, Cin, Cout)
  torch conv weight OIHW (Cout, Cin, kh, kw)
  JAX deconv weight HWIO of the equivalent forward conv, spatially
                    pre-flipped (``torch_deconv_weight_to_hwio``)
  torch deconv      (Cin, Cout, kh, kw), as ``F.conv_transpose2d`` takes it
"""

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
    CPU, oneDNN 3.12), and the CPU path is the reference, not the fast one."""
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
