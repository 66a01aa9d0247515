"""Generalized Divisive Normalization, functional core.

    y_i = x_i / sqrt(beta_i + sum_j gamma_ij * x_j^2)      (GDN)
    y_i = x_i * sqrt(beta_i + sum_j gamma_ij * x_j^2)      (IGDN)

Counterpart of ``iclr_17_compression_tpu/ops/gdn.py``. Parameters are stored
reparameterized as ``sqrt(value + pedestal)`` and clamped from below through
the gated-gradient ``lower_bound`` before being squared back.

``gdn`` dispatches by the tensor's device: a CPU tensor takes the plain
version, a CUDA tensor the K1 kernel (``kernels/gdn_kernel.py``). There is no
switch and no fallback. As the Pallas wrapper does, it hands the kernel γᵀ
in x's element type and β in fp32 (no-ops on fp32 storage; under bf16
storage the reparameterization itself runs in bf16, as in JAX).
"""

from typing import NamedTuple

import torch

from .kernels.gdn_kernel import gdn_fused, gdn_fused_plain
from .math import lower_bound

REPARAM_OFFSET = 2.0 ** -18
PEDESTAL = REPARAM_OFFSET ** 2
BETA_MIN = 1e-6
GAMMA_INIT = 0.1

BETA_BOUND = (BETA_MIN + PEDESTAL) ** 0.5
GAMMA_BOUND = REPARAM_OFFSET


class GDNParams(NamedTuple):
    """Reparameterized GDN parameters: beta (C,) stores sqrt(beta + pedestal),
    gamma (C, C) stores sqrt(gamma + pedestal); gamma[i, j] couples output
    channel i to input channel j."""

    beta: torch.Tensor
    gamma: torch.Tensor


def gdn_param_init(ch: int, dtype=torch.float32) -> GDNParams:
    """Identity-like init (reference models/GDN.py:46-62)."""
    beta = torch.sqrt(torch.ones(ch, dtype=dtype) + PEDESTAL)
    gamma = torch.sqrt(GAMMA_INIT * torch.eye(ch, dtype=dtype) + PEDESTAL)
    return GDNParams(beta=beta, gamma=gamma)


def gdn_reparam(params: GDNParams):
    """Clamp (gated gradient) and un-reparameterize: (beta, gamma) effective."""
    beta = lower_bound(params.beta, BETA_BOUND)
    beta = beta * beta - PEDESTAL
    gamma = lower_bound(params.gamma, GAMMA_BOUND)
    gamma = gamma * gamma - PEDESTAL
    return beta, gamma


def gdn_plain(x: torch.Tensor, params: GDNParams, inverse: bool = False) -> torch.Tensor:
    """The plain PyTorch version (the twin of ``gdn_xla``)."""
    beta, gamma = gdn_reparam(params)
    return gdn_fused_plain(x, gamma.t().to(x.dtype), beta.float(), inverse)


def gdn(x: torch.Tensor, params: GDNParams, inverse: bool = False) -> torch.Tensor:
    """(I)GDN over the last axis of a (..., C) tensor, dispatched by device."""
    beta, gamma = gdn_reparam(params)
    return gdn_fused(x, gamma.t().contiguous().to(x.dtype), beta.float(), inverse)
