"""CompressAI-style building blocks, NHWC, for the DSC models.

Counterpart of ``iclr_17_compression_tpu/nn/blocks.py``. The modules are laid
out as CompressAI lays them out, so a stack's ``state_dict()`` keys are the
reference PyTorch keys that ``_import_block_params``
(``iclr_17_compression_tpu/train/torch_import.py``) maps:

- ResidualBlock:           conv1, conv2 (3×3, act after each), skip (1×1,
                           when the channels change)
- ResidualBlockWithStride: conv1 (3×3, stride s), conv2 (3×3), gdn, skip
- ResidualBlockUpsample:   subpel_conv.0 (3×3 to C·r², pixel shuffle), conv
                           (3×3), igdn, upsample.0 (the subpel skip)
- AttentionBlock:          conv_a.{0,1,2} and conv_b.{0,1,2} residual units,
                           each conv.{0,2,4} = 1×1 (C→C/2), k×k, 1×1 (C/2→C);
                           conv_b.3 the 1×1 gate; out = x + a·σ(b)

Each 3×3 stride-1 conv followed by a GDN (conv2 + gdn of
ResidualBlockWithStride) or an IGDN (conv + igdn of ResidualBlockUpsample)
runs as one ``conv_gdn`` call: the K2 kernel on CUDA, conv + plain GDN on
the CPU. The other convs are ``F.conv2d`` (cuDNN on the card), as the JAX
package leaves them to XLA.

``init_dsc_(module, generator)`` draws the JAX package's DSC init: torch's
default U(±1/√fan_in) for every conv weight and bias, the identity init for
every GDN.
"""

from typing import Callable

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.conv import pixel_shuffle
from ..ops.kernels.conv_gdn_kernel import conv_gdn_module
from .layers import GDN, TorchConv, torch_default_init_


class _LeakyReLU(torch.autograd.Function):
    """``F.leaky_relu`` whose derivative at 0 is 1, as ``jax.nn.leaky_relu``'s
    (``where(x >= 0, x, s·x)``); torch's own is the slope there. A conv
    output lands on exactly 0 now and then in fp32, and there the two
    packages' gradients would differ by 0.99 of the upstream gradient."""

    @staticmethod
    def forward(ctx, x, slope):
        ctx.save_for_backward(x)
        ctx.slope = slope
        return F.leaky_relu(x, slope)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return torch.where(x >= 0, g, g * ctx.slope), None


def _act(name: str) -> Callable:
    if name == "leaky_relu":
        return lambda x: _LeakyReLU.apply(x, 0.01)
    if name == "relu":
        return F.relu
    if name == "gelu":
        # the tanh form: the JAX package calls jax.nn.gelu, whose default is
        # approximate=True, although its comment names torch's exact erf form
        return lambda x: F.gelu(x, approximate="tanh")
    raise ValueError(f"unknown activation {name!r}")


class _Act(nn.Module):
    """An activation as a module, for the indexed ``nn.Sequential``s whose
    keys the reference uses (no parameters)."""

    def __init__(self, name: str):
        super().__init__()
        self.name = name
        self.fn = _act(name)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fn(x)


def conv3x3(cin: int, cout: int, stride: int = 1) -> TorchConv:
    return TorchConv(cin, cout, 3, stride=stride, padding=1)


def conv1x1(cin: int, cout: int, stride: int = 1) -> TorchConv:
    return TorchConv(cin, cout, 1, stride=stride, padding=0)


class PixelShuffle(nn.Module):
    """NHWC ``nn.PixelShuffle``."""

    def __init__(self, r: int):
        super().__init__()
        self.r = r

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return pixel_shuffle(x, self.r)


class SubpelConv(nn.Sequential):
    """3×3 conv to C·r² channels, then pixel shuffle by r (CompressAI's
    ``subpel_conv3x3``; keys ``0.weight``, ``0.bias``)."""

    def __init__(self, cin: int, cout: int, r: int = 1):
        super().__init__(TorchConv(cin, cout * r * r, 3, padding=1), PixelShuffle(r))


class ResidualBlock(nn.Module):
    def __init__(self, cin: int, cout: int, act: str = "leaky_relu"):
        super().__init__()
        self.act = _act(act)
        self.conv1 = conv3x3(cin, cout)
        self.conv2 = conv3x3(cout, cout)
        self.skip = conv1x1(cin, cout) if cin != cout else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.act(self.conv2(self.act(self.conv1(x))))
        return out + (x if self.skip is None else self.skip(x))


class ResidualBlockWithStride(nn.Module):
    def __init__(self, cin: int, cout: int, stride: int = 2, act: str = "leaky_relu"):
        super().__init__()
        self.act = _act(act)
        self.conv1 = conv3x3(cin, cout, stride)
        self.conv2 = conv3x3(cout, cout)
        self.gdn = GDN(cout)
        self.skip = conv1x1(cin, cout, stride) if stride != 1 or cin != cout else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = conv_gdn_module(self.act(self.conv1(x)), self.conv2, self.gdn)
        return out + (x if self.skip is None else self.skip(x))


class ResidualBlockUpsample(nn.Module):
    def __init__(self, cin: int, cout: int, upsample: int = 2, act: str = "leaky_relu"):
        super().__init__()
        self.act = _act(act)
        self.subpel_conv = SubpelConv(cin, cout, upsample)
        self.conv = conv3x3(cout, cout)
        self.igdn = GDN(cout, inverse=True)
        self.upsample = SubpelConv(cin, cout, upsample)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = conv_gdn_module(self.act(self.subpel_conv(x)), self.conv, self.igdn)
        return out + self.upsample(x)


class _ResidualUnit(nn.Module):
    """1×1 (C→C/2) → act → k×k → act → 1×1 (C/2→C), plus the input, then
    act (CompressAI's ``ResidualUnit`` inside ``AttentionBlock``)."""

    def __init__(self, ch: int, unit_act: str = "relu", unit_kernel: int = 3):
        super().__init__()
        half = ch // 2
        self.conv = nn.Sequential(
            conv1x1(ch, half), _Act(unit_act),
            TorchConv(half, half, unit_kernel, padding=unit_kernel // 2), _Act(unit_act),
            conv1x1(half, ch),
        )
        self.act = _act(unit_act)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.act(self.conv(x) + x)


class AttentionBlock(nn.Module):
    """Cheng-2020 simplified attention: x + a(x)·σ(b(x)). ``unit_kernel=7``
    with ``unit_act="gelu"`` is the reference's ``AttentionBlock_7``."""

    def __init__(self, ch: int, unit_act: str = "relu", unit_kernel: int = 3):
        super().__init__()
        self.conv_a = nn.Sequential(*(_ResidualUnit(ch, unit_act, unit_kernel)
                                      for _ in range(3)))
        self.conv_b = nn.Sequential(*(_ResidualUnit(ch, unit_act, unit_kernel)
                                      for _ in range(3)), conv1x1(ch, ch))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.conv_a(x) * torch.sigmoid(self.conv_b(x))


def init_dsc_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """The JAX package's DSC init, in place, drawn from ``generator`` in
    module order: U(±1/√fan_in) for every conv weight and bias, the
    identity init for every GDN."""
    for m in module.modules():
        if isinstance(m, TorchConv):
            torch_default_init_(m, generator)
        elif isinstance(m, GDN):
            m.init_()
    return module
