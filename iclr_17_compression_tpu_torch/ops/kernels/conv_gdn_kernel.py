"""K2: strided conv + bias + optional (I)GDN in one pass, the CUDA kernel
``csrc/conv_gdn.cu`` and its plain version, and the fused Ballé-17 encoder.

Counterpart of ``iclr_17_compression_tpu/ops/pallas/conv_gdn_kernel.py``
(``_conv_gdn_kernel`` / ``conv_gdn_fused_raw`` / ``conv_gdn`` /
``analysis17_fused``). ``conv_gdn`` takes NHWC ``x``, an HWIO weight (as the
JAX function does), an optional bias and optional effective GDN parameters
(``gamma_t`` = gamma.T and ``beta``, as ``conv_gdn_fused_raw`` takes them;
None for no GDN). A CPU tensor goes to
``conv_gdn_plain``; a CUDA tensor launches the kernel or raises.

Gradients: ``conv_gdn`` is a ``torch.autograd.Function`` on both devices.
Its backward is the counterpart of ``_conv_gdn_bwd``, the XLA VJP of
``_ref_conv_gdn`` in the JAX package (there is no Pallas backward): it
recomputes ``conv_gdn_plain`` (cuDNN ``F.conv2d`` + the plain GDN) from the
saved inputs and differentiates it. Through ``conv_gdn_module`` (the
Ballé-17 encoder's ``analysis17_fused``, the DSC blocks' conv + (I)GDN
pairs) the gradient reaches the OIHW conv weights through the
``oihw_to_hwio`` permute and the stored GDN parameters through
``gdn_reparam``'s ``lower_bound`` gate, both outside the Function.

A stage with too few 64-pixel tiles to fill the card splits its K (the k·k
taps) into ``plan_splits`` parts of whole taps; the wrapper allocates the
fp32 partials and the C launcher reduces them in fixed order inside the
same call.
"""

import functools
from typing import Optional

import torch

from . import _build
from .gdn_kernel import gdn_fused_plain, plain_vjp
from ..conv import conv2d, hwio_to_oihw, oihw_to_hwio
from ..gdn import gdn_reparam


BM = 64  # output pixels a block of the kernel (csrc/conv_gdn.cu)


def plan_splits(pixels: int, taps: int, slots: int) -> int:
    """Splits of K for a conv of ``pixels`` output pixels and ``taps`` taps,
    on a card that runs ``slots`` blocks at once (SMs × blocks an SM holds).

    1 when the 64-pixel tiles alone fill the slots. Else the S, at most one a
    tap, that gives at least ``slots`` blocks and the least time in units of
    one tap of one block: waves of ``slots`` blocks times the most taps a
    split holds (fewest splits on a tie).
    """
    tiles = -(-pixels // BM)
    if tiles >= slots:
        return 1
    first = min(taps, -(-slots // tiles))

    def cost(s):
        return -(-tiles * s // slots) * -(-taps // s)

    return min(range(first, taps + 1), key=lambda s: (cost(s), s))


@functools.lru_cache(maxsize=None)
def block_slots(index: int, cout: int) -> int:
    """Blocks of the kernel that card ``index`` runs at once at ``cout``
    output channels: its SMs times the blocks an SM holds."""
    per_sm = _build.kernels().iclr17c_conv_gdn_blocks_per_sm(cout)
    if per_sm < 1:
        raise RuntimeError(f"conv_gdn: no block of the kernel fits an SM at Cout={cout}")
    return per_sm * torch.cuda.get_device_properties(index).multi_processor_count


def conv_gdn_plain(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor],
                   gamma_t: Optional[torch.Tensor], beta: Optional[torch.Tensor],
                   stride: int, padding: int, inverse: bool = False) -> torch.Tensor:
    """The plain PyTorch version: ``F.conv2d`` then the plain GDN."""
    y = conv2d(x, hwio_to_oihw(w), b, stride=stride, padding=padding)
    if gamma_t is not None:
        y = gdn_fused_plain(y, gamma_t, beta, inverse)
    return y


class _ConvGDN(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, b, gamma_t, beta, stride, padding, inverse):
        ctx.save_for_backward(x, w, b, gamma_t, beta)
        ctx.conf = (stride, padding, inverse)
        if x.device.type == "cpu":
            return conv_gdn_plain(x, w, b, gamma_t, beta, stride, padding, inverse)
        return _launch(x, w, b, gamma_t, beta, stride, padding, inverse)

    @staticmethod
    def backward(ctx, g):
        with torch.profiler.record_function("iclr17c::conv_gdn_backward"):
            grads = plain_vjp(lambda *a: conv_gdn_plain(*a, *ctx.conf), ctx.saved_tensors,
                              ctx.needs_input_grad, g)
        return grads + (None, None, None)


def conv_gdn(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor],
             gamma_t: Optional[torch.Tensor], beta: Optional[torch.Tensor],
             stride: int, padding: int, inverse: bool = False) -> torch.Tensor:
    """Conv (+ bias) (+ (I)GDN): the kernel on CUDA, the plain version on CPU;
    differentiable in every tensor argument on both."""
    return _ConvGDN.apply(x, w, b, gamma_t, beta, stride, padding, inverse)


def _launch(x, w, b, gamma_t, beta, stride, padding, inverse):
    n, h, wd, cin = x.shape
    k, k2, cin_w, cout = w.shape
    if k != k2 or cin_w != cin:
        raise ValueError(f"conv_gdn: weight {tuple(w.shape)} does not fit input {tuple(x.shape)}")
    if cout % 32 or cout > 256:
        raise ValueError(f"conv_gdn: the kernel takes Cout % 32 == 0 and Cout <= 256, got {cout}")
    ho = (h + 2 * padding - k) // stride + 1
    wo = (wd + 2 * padding - k) // stride + 1
    gdn_on = gamma_t is not None
    _build.check_tensor("x", x)
    _build.check_tensor("w", w)
    if b is not None:
        _build.check_tensor("b", b, (cout,))
    if gdn_on:
        _build.check_tensor("gamma_t", gamma_t, (cout, cout))
        _build.check_tensor("beta", beta, (cout,))
    out = torch.empty((n, ho, wo, cout), device=x.device, dtype=torch.float32)
    p = n * ho * wo
    lib = _build.kernels()
    with torch.cuda.device(x.device):
        splits = plan_splits(p, k * k, block_slots(torch.cuda.current_device(), cout))
        partials = None
        if splits > 1:
            partials = torch.empty((splits, p, cout), device=x.device, dtype=torch.float32)
        err = lib.iclr17c_conv_gdn(
            x.data_ptr(), w.data_ptr(), None if b is None else b.data_ptr(),
            gamma_t.data_ptr() if gdn_on else None, beta.data_ptr() if gdn_on else None,
            out.data_ptr(), None if partials is None else partials.data_ptr(), splits,
            n, h, wd, cin, ho, wo, cout, k, stride, padding,
            int(gdn_on), int(inverse), torch.cuda.current_stream().cuda_stream,
        )
    _build.check_launch(err, "conv_gdn")
    conv_gdn.launches += 1  # forward launches only: the backward runs plain PyTorch
    return out


conv_gdn.launches = 0


def conv_gdn_module(x: torch.Tensor, conv, gdn=None) -> torch.Tensor:
    """A ``TorchConv`` module followed by a ``GDN`` module (or none) as one
    ``conv_gdn`` call, with the conv's stride and padding and the GDN's
    direction. The gradient reaches the OIHW weight through the
    ``oihw_to_hwio`` permute and the stored GDN parameters through
    ``gdn_reparam``, both outside the Function."""
    gamma_t = beta = None
    if gdn is not None:
        beta, gamma = gdn_reparam(gdn.params())
        gamma_t = gamma.t().contiguous()
    return conv_gdn(x, oihw_to_hwio(conv.weight).contiguous(), conv.bias, gamma_t, beta,
                    conv.stride[0], conv.padding[0], gdn is not None and gdn.inverse)


def analysis17_fused(encoder, x: torch.Tensor) -> torch.Tensor:
    """The Ballé-17 analysis transform as three ``conv_gdn`` calls, driven
    from an ``Analysis17`` module: conv1 9×9 s4 + GDN, conv2 5×5 s2 + GDN,
    conv3 5×5 s2 (no bias, no GDN). NHWC in, NHWC latent out."""
    y = conv_gdn_module(x, encoder.conv1, encoder.gdn1)
    y = conv_gdn_module(y, encoder.conv2, encoder.gdn2)
    return conv_gdn_module(y, encoder.conv3)
