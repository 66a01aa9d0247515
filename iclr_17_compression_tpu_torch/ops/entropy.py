"""Factorized entropy model: the BitEstimator cumulative CDF.

Counterpart of ``iclr_17_compression_tpu/ops/entropy.py``. A per-channel
monotone CDF of 4 elementwise layers over (..., C):

    layer k<4 : u = x * softplus(h_k) + b_k;  x' = u + tanh(u) * tanh(a_k)
    layer 4   : C(x) = sigmoid(x * softplus(h_4) + b_4)

bits(z) = sum(clip(-log2(C(z+0.5) - C(z-0.5) + 1e-10), 0, 50)). Callers
evaluate it in fp32 (see models/balle17.py).
"""

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

LOG2 = 0.6931471805599453  # ln(2)


class BitparmParams(NamedTuple):
    h: torch.Tensor  # (C,)
    b: torch.Tensor  # (C,)
    a: Optional[torch.Tensor]  # (C,); None for the final layer


class BitEstimatorParams(NamedTuple):
    f1: BitparmParams
    f2: BitparmParams
    f3: BitparmParams
    f4: BitparmParams


def bitparm_cdf(x: torch.Tensor, p: BitparmParams, final: bool) -> torch.Tensor:
    u = x * F.softplus(p.h) + p.b
    if final:
        return torch.sigmoid(u)
    return u + torch.tanh(u) * torch.tanh(p.a)


def bit_estimator_cdf(x: torch.Tensor, params: BitEstimatorParams) -> torch.Tensor:
    """Cumulative CDF C(x) in (0, 1), monotone in x per channel."""
    x = bitparm_cdf(x, params.f1, final=False)
    x = bitparm_cdf(x, params.f2, final=False)
    x = bitparm_cdf(x, params.f3, final=False)
    return bitparm_cdf(x, params.f4, final=True)


def estimate_bits(z: torch.Tensor, params: BitEstimatorParams):
    """Total estimated bits for quantized latents ``z`` (..., C), and the
    per-element probability."""
    prob = bit_estimator_cdf(z + 0.5, params) - bit_estimator_cdf(z - 0.5, params)
    bits = torch.clamp(-torch.log(prob + 1e-10) / LOG2, 0.0, 50.0)
    return torch.sum(bits), prob
