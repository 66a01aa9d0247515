"""Plain fp32 building blocks of the references: NCHW convolutions whose
operands go through a ``Cast``, GDN with its reparameterization and gated
lower bound, the factorized rate model.

Frozen copies of the port's plain code (``ops/gdn.py``, ``ops/math.py``,
``ops/entropy.py``); nothing here imports the port.

``Cast`` is the precision a reference computes in. ``fp32`` leaves every
operand as it is; the flags it sets (``fp32_flags``) keep cuDNN and cuBLAS
off TF32, so a product on the card is an fp32 product. The two lower
precisions are the controls that ``How correct is decided`` asks for:
``tf32`` rounds both operands of every convolution and matrix product to
TF32 (10 mantissa bits, round to nearest), what the card's TF32 tensor
cores take in, and ``fp8`` rounds them to float8 e4m3 under a per-tensor
power-of-two scale (the step below bf16 storage). Both emulate the
rounding on either device, so the control reads the same on the CPU tests
and on the card.
"""

import math

import torch
import torch.nn.functional as F

REPARAM_OFFSET = 2.0 ** -18
PEDESTAL = REPARAM_OFFSET ** 2
BETA_BOUND = (1e-6 + PEDESTAL) ** 0.5
GAMMA_BOUND = REPARAM_OFFSET
LOG2 = math.log(2.0)
FP8_MAX = 448.0
PRECISIONS = ("fp32", "tf32", "fp8")


def fp32_flags() -> None:
    """cuDNN and cuBLAS fp32 products in fp32 (TF32 off)."""
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


class Cast:
    """The rounding applied to both operands of every product, and the
    products' multiply-accumulates counted as they pass (``macs``)."""

    def __init__(self, precision: str = "fp32"):
        if precision not in PRECISIONS:
            raise ValueError(f"precision must be one of {PRECISIONS}, got {precision!r}")
        self.precision = precision
        self.macs = 0

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if self.precision == "fp32":
            return x
        with torch.no_grad():
            r = self.round(x.detach().float())
        # the rounding is the forward's; the gradient passes it unchanged
        return x + (r - x).detach() if x.requires_grad else r

    def round(self, x: torch.Tensor) -> torch.Tensor:
        if self.precision == "tf32":
            bits = x.contiguous().view(torch.int32)
            return ((bits + 0x1000) & -0x2000).view(torch.float32)
        amax = x.abs().max().clamp_min(1e-30)
        scale = torch.exp2(torch.floor(torch.log2(FP8_MAX / amax)))
        return (x * scale).to(torch.float8_e4m3fn).float() / scale


class _LowerBound(torch.autograd.Function):
    """max(x, bound) whose gradient passes where x is at or above the bound
    or the upstream gradient is negative (the port's ``ops/math.py``)."""

    @staticmethod
    def forward(ctx, x, bound):
        ctx.save_for_backward(x >= bound)
        return torch.clamp(x, min=bound)

    @staticmethod
    def backward(ctx, g):
        (above,) = ctx.saved_tensors
        return torch.where(above | (g < 0), g, torch.zeros_like(g)), None


def gdn_effective(beta: torch.Tensor, gamma: torch.Tensor):
    """The stored sqrt(value + pedestal) parameters → (β, γ)."""
    beta = _LowerBound.apply(beta, BETA_BOUND)
    gamma = _LowerBound.apply(gamma, GAMMA_BOUND)
    return beta * beta - PEDESTAL, gamma * gamma - PEDESTAL


def gdn(x: torch.Tensor, beta: torch.Tensor, gamma: torch.Tensor, inverse: bool,
        cast: Cast) -> torch.Tensor:
    """(I)GDN of an NCHW tensor: y_i = x_i / sqrt(β_i + Σ_j γ_ij x_j²)
    (inverse: times)."""
    b, g = gdn_effective(beta, gamma)
    cast.macs += x.numel() * x.shape[1]
    norm = F.conv2d(cast(x * x), cast(g)[:, :, None, None], b)
    return x * torch.sqrt(norm) if inverse else x / torch.sqrt(norm)


def conv(x, w, b, cast: Cast, stride: int = 1, padding: int = 0) -> torch.Tensor:
    """A conv (OIHW weight); each output element takes Cin·k·k products."""
    y = F.conv2d(cast(x), cast(w), b, stride=stride, padding=padding)
    cast.macs += y.numel() * w[0].numel()
    return y


def deconv(x, w, b, cast: Cast, stride: int, padding: int, output_padding: int):
    """A transposed conv ((Cin, Cout, k, k) weight); each input element
    takes Cout·k·k products."""
    cast.macs += x.numel() * w[0].numel()
    return F.conv_transpose2d(cast(x), cast(w), b, stride=stride, padding=padding,
                              output_padding=output_padding)


def bitparm(x, h, b, a):
    u = x * F.softplus(h)[:, None, None] + b[:, None, None]
    if a is None:
        return torch.sigmoid(u)
    return u + torch.tanh(u) * torch.tanh(a)[:, None, None]


def factorized_cdf(x: torch.Tensor, layers) -> torch.Tensor:
    """The factorized prior's per-channel CDF of an NCHW tensor; ``layers``
    is four (h, b, a) triples, the last with a = None."""
    for h, b, a in layers:
        x = bitparm(x, h, b, a)
    return x


def total_bits(z: torch.Tensor, layers) -> torch.Tensor:
    """Σ clip(-log2(C(z+½) − C(z−½) + 1e-10), 0, 50) over an NCHW latent."""
    prob = factorized_cdf(z + 0.5, layers) - factorized_cdf(z - 0.5, layers)
    return torch.sum(torch.clamp(-torch.log(prob + 1e-10) / LOG2, 0.0, 50.0))


def nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2).float().contiguous()


def nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1).contiguous()
