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

In fp32, a stage with too few 64-pixel tiles to fill the card splits its K
(the k·k taps) into ``plan_splits`` parts of whole taps; the wrapper
allocates the fp32 partials and the C launcher reduces them in fixed order
inside the same call.

Two element types, as the Pallas kernel takes any: fp32 (products in
3xTF32), or bf16 x and weight with fp32 bias, γᵀ and β (the Pallas wrapper
casts the weight to x's type and keeps the bias and the GDN parameters in
fp32). The bf16 kernel is one of its own (wgmma on the card's bf16 tensor
cores, products accumulating in fp32); the bias and the (I)GDN epilogue stay
fp32 (3xTF32 norm), and only the store rounds to bf16. It takes the weight
as K-major (Cout, K) rows (``k_major_weight``: the memory of the weight
``conv_gdn_module`` hands it, else a copy), never splits K, and runs blocks
of ``tile_bf16`` output pixels. Launches count in ``conv_gdn.launches``, the
bf16 ones also in ``launches_bf16``.

Blocked image I/O: ``conv_gdn_module`` runs a ``TorchConv`` with
``input_block = s`` (the Ballé-17 conv1 over ``space_to_depth(x, 4)``) as a
3×3 stride-1 K2 call over s²·Cin channels with ``block_conv_weight``; the
reinterpretation is outside the Function, so the gradient reaches the
canonical OIHW weight.
"""

import functools
from typing import Optional

import torch

from . import _build
from .gdn_kernel import gdn_fused_plain, plain_vjp
from ..conv import _pair, conv2d, hwio_to_oihw, oihw_to_hwio
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
    """Blocks of the fp32 kernel that card ``index`` runs at once at
    ``cout`` output channels: its SMs times the blocks an SM holds."""
    per_sm = _build.kernels().iclr17c_conv_gdn_blocks_per_sm(cout)
    if per_sm < 1:
        raise RuntimeError(f"conv_gdn: no block of the kernel fits an SM at Cout={cout}")
    return per_sm * torch.cuda.get_device_properties(index).multi_processor_count


# The bf16 kernel (csrc/conv_gdn.cu, conv_gdn_bf16_kernel): a block of 64
# output pixels is one consumer warpgroup (two blocks share an SM up to Cout
# = 128), one of 128 two that share each weight step (one block an SM,
# built for 64 < Cout <= 192).
BF16_TILES = (64, 128)
# K rows from which the 128-pixel tile pays at Cout <= 128 (32 steps of 64)
DEEP_K_BF16 = 2048


def tile_bf16(pixels: int, depth: int, cout: int, sms: int) -> int:
    """Output pixels of a block of the bf16 kernel for a conv of ``pixels``
    output pixels, ``depth`` = k·k·Cin K rows and ``cout`` channels, on a
    card of ``sms`` SMs. 128 where its grid reaches at least half the SMs
    and either a 64-pixel block would run one an SM (Cout > 128: the 128
    tile doubles the pixels an SM works on) or the K loop is long (``depth``
    >= DEEP_K_BF16: it halves the weight's reads, which short loops do not
    repay for the epilogue that two 64-pixel blocks an SM overlap); else 64,
    and always at Cout <= 64 or > 192, where the 128 tile is not built. The
    thresholds lie between shapes timed on an H100
    (``tools/chip_bf16_kernels.py``)."""
    if not 64 < cout <= 192 or 2 * -(-pixels // 128) < sms:
        return 64
    return 128 if cout > 128 or depth >= DEEP_K_BF16 else 64


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """The SMs of card ``index``."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def k_major_hwio(w: torch.Tensor) -> torch.Tensor:
    """An HWIO weight (k, k, Cin, Cout) copied once into K-major memory, Cout
    rows of K = k·k·Cin values (dy, dx, ci) each, ``ldw`` = K rounded up to 8
    apart (16-byte rows; what lies past K is never read), and returned as
    an HWIO view of it: what the bf16 kernel reads with no copy of its own
    (``k_major_weight``)."""
    k, _, cin, cout = w.shape
    kk = k * k * cin
    rows = w.new_empty((cout, -(-kk // 8) * 8))[:, :kk].view(cout, k, k, cin)
    rows.copy_(w.permute(3, 0, 1, 2))
    return rows.permute(1, 2, 3, 0)


def k_major_weight(w: torch.Tensor):
    """The HWIO weight (k, k, Cin, Cout) as the bf16 kernel's B operand:
    ``(rows, ldw)``, ``rows`` the (Cout, k, k, Cin) view whose memory holds
    row c, the weight's column c in (dy, dx, ci) order, ``ldw`` elements
    after row c - 1. No copy where ``w`` is already such rows seen as HWIO
    (``k_major_hwio``), else one."""
    k, _, cin, cout = w.shape
    rows = w.permute(3, 0, 1, 2)
    ldw = rows.stride(0)
    if (rows.stride()[1:] != (k * cin, cin, 1) or ldw < k * k * cin or ldw % 8
            or w.data_ptr() % 16):
        rows = k_major_hwio(w).permute(3, 0, 1, 2)
        ldw = rows.stride(0)
    return rows, ldw


def conv_gdn_plain(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor],
                   gamma_t: Optional[torch.Tensor], beta: Optional[torch.Tensor],
                   stride: int, padding, inverse: bool = False) -> torch.Tensor:
    """The plain PyTorch version: ``F.conv2d`` then the plain GDN. On bf16
    ``x`` the bf16 operands are upcast and the conv, bias and GDN computed in
    fp32, rounded to bf16 once (the kernel's rounding points)."""
    if x.dtype == torch.bfloat16:
        y = conv_gdn_plain(x.float(), w.float().contiguous(), None if b is None else b.float(),
                           None if gamma_t is None else gamma_t.float(),
                           None if beta is None else beta.float(), stride, padding, inverse)
        return y.to(torch.bfloat16)
    y = conv2d(x, hwio_to_oihw(w), b, stride=stride, padding=_pair(padding))
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
             stride: int, padding, inverse: bool = False) -> torch.Tensor:
    """Conv (+ bias) (+ (I)GDN): the kernel on CUDA, the plain version on CPU;
    differentiable in every tensor argument on both. ``padding``: one int,
    or (above and below, left and right), as a tile that carries its
    neighbours' columns needs (p, 0)."""
    return _ConvGDN.apply(x, w, b, gamma_t, beta, stride, padding, inverse)


def _launch(x, w, b, gamma_t, beta, stride, padding, inverse):
    n, h, wd, cin = x.shape
    k, k2, cin_w, cout = w.shape
    if k != k2 or cin_w != cin:
        raise ValueError(f"conv_gdn: weight {tuple(w.shape)} does not fit input {tuple(x.shape)}")
    if cout % 32 or cout > 256:
        raise ValueError(f"conv_gdn: the kernel takes Cout % 32 == 0 and Cout <= 256, got {cout}")
    pad_h, pad_w = _pair(padding)
    ho = (h + 2 * pad_h - k) // stride + 1
    wo = (wd + 2 * pad_w - k) // stride + 1
    if ho < 1 or wo < 1:
        raise ValueError(f"conv_gdn: input {tuple(x.shape)} gives an empty output")
    gdn_on = gamma_t is not None
    dtype = _build.kernel_dtype("conv_gdn", x)
    bf16 = dtype == torch.bfloat16
    _build.check_tensor("x", x, dtype=dtype)
    if bf16:
        if w.device != x.device or w.dtype != dtype:
            raise ValueError(f"w: expected {dtype} on {x.device}, got {w.dtype} on {w.device}")
        wt, ldw = k_major_weight(w)
    else:
        _build.check_tensor("w", w, dtype=dtype)
    if b is not None:
        _build.check_tensor("b", b, (cout,))
    if gdn_on:
        _build.check_tensor("gamma_t", gamma_t, (cout, cout))
        _build.check_tensor("beta", beta, (cout,))
    out = torch.empty((n, ho, wo, cout), device=x.device, dtype=dtype)
    p = n * ho * wo
    lib = _build.kernels()
    with torch.cuda.device(x.device):
        index = torch.cuda.current_device()
        head = (x.data_ptr(), (wt if bf16 else w).data_ptr(), None if b is None else b.data_ptr(),
                gamma_t.data_ptr() if gdn_on else None, beta.data_ptr() if gdn_on else None,
                out.data_ptr())
        tail = (n, h, wd, cin, ho, wo, cout, k, stride, pad_h, pad_w,
                int(gdn_on), int(inverse), torch.cuda.current_stream().cuda_stream)
        if bf16:
            err = lib.iclr17c_conv_gdn_bf16(*head, tile_bf16(p, k * k * cin, cout, sm_count(index)), ldw,
                                            *tail)
        else:
            splits = plan_splits(p, k * k, block_slots(index, cout))
            partials = None
            if splits > 1:
                partials = torch.empty((splits, p, cout), device=x.device, dtype=torch.float32)
            err = lib.iclr17c_conv_gdn(
                *head, None if partials is None else partials.data_ptr(), splits, *tail)
    _build.check_launch(err, "conv_gdn")
    conv_gdn.launches += 1  # forward launches only: the backward runs plain PyTorch
    conv_gdn.launches_bf16 += bf16
    return out


conv_gdn.launches = 0
conv_gdn.launches_bf16 = 0


def conv_gdn_module(x: torch.Tensor, conv, gdn=None, padding=None) -> torch.Tensor:
    """A ``TorchConv`` module followed by a ``GDN`` module (or none) as one
    ``conv_gdn`` call, with the conv's stride and padding (``padding``, an
    (above and below, left and right) pair, where given: a tile that carries
    its neighbours' columns) and the GDN's direction; a conv with
    ``input_block`` > 1 as the 3×3 stride-1 blocked conv. The gradient
    reaches the OIHW weight through the ``oihw_to_hwio``
    permute (and ``block_conv_weight``) and the stored GDN parameters
    through ``gdn_reparam``, all outside the Function. As the Pallas
    wrapper, it hands the kernel the weight in x's element type and the
    bias, γᵀ and β in fp32 (no-ops on fp32 storage; fp64 on the CPU's fp64
    input); a bf16 weight is copied once, into the kernel's K-major rows
    (``k_major_hwio``), as an fp32 one is into HWIO order."""
    acc = torch.promote_types(x.dtype, torch.float32)
    gamma_t = beta = None
    if gdn is not None:
        beta, gamma = gdn_reparam(gdn.params())
        gamma_t, beta = gamma.t().contiguous().to(acc), beta.to(acc)
    if getattr(conv, "input_block", 1) > 1:
        w, stride, own = conv.blocked_weight(), 1, 1
    else:
        w, stride, own = oihw_to_hwio(conv.weight), conv.stride[0], conv.padding[0]
    b = None if conv.bias is None else conv.bias.to(acc)
    w = w.to(x.dtype)
    w = k_major_hwio(w) if x.dtype == torch.bfloat16 else w.contiguous()
    return conv_gdn(x, w, b, gamma_t, beta, stride,
                    own if padding is None else padding, gdn is not None and gdn.inverse)


def analysis17_fused(encoder, x: torch.Tensor) -> torch.Tensor:
    """The Ballé-17 analysis transform as three ``conv_gdn`` calls, driven
    from an ``Analysis17`` module: conv1 9×9 s4 + GDN (3×3 s1 over 48
    channels when the input comes blocked), conv2 5×5 s2 + GDN, conv3 5×5
    s2 (no bias, no GDN). NHWC in, NHWC latent out."""
    y = conv_gdn_module(x, encoder.conv1, encoder.gdn1)
    y = conv_gdn_module(y, encoder.conv2, encoder.gdn2)
    return conv_gdn_module(y, encoder.conv3)
