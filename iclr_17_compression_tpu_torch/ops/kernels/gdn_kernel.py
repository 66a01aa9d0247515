"""K1: fused (I)GDN, the CUDA kernel ``csrc/gdn.cu`` and its plain version.

Counterpart of ``iclr_17_compression_tpu/ops/pallas/gdn_kernel.py``
(``_gdn_kernel`` / ``_gdn_pallas_raw``). The contract is the raw one: the
parameters are the effective ``gamma_t`` = gamma.T (C, C) and ``beta`` (C,),
already un-reparameterized by ``ops.gdn.gdn_reparam``:

    norm = beta + (x*x) @ gamma_t ;  y = x / sqrt(norm)   (inverse: x * sqrt(norm))

``gdn_fused`` takes a tensor of any leading shape (..., C). A CPU tensor goes
to ``gdn_fused_plain``; a CUDA tensor launches the kernel or raises.
"""

import torch

from . import _build


def gdn_fused_plain(x: torch.Tensor, gamma_t: torch.Tensor, beta: torch.Tensor,
                    inverse: bool = False) -> torch.Tensor:
    """The plain PyTorch version (the twin of ``gdn_xla`` after reparam)."""
    norm = torch.sqrt(torch.matmul(x * x, gamma_t) + beta)
    return x * norm if inverse else x / norm


def gdn_fused(x: torch.Tensor, gamma_t: torch.Tensor, beta: torch.Tensor,
              inverse: bool = False) -> torch.Tensor:
    """(I)GDN over the last axis: the kernel on CUDA, the plain version on CPU."""
    if x.device.type == "cpu":
        return gdn_fused_plain(x, gamma_t, beta, inverse)
    _build.forward_only("gdn_fused", x, gamma_t, beta)
    c = x.shape[-1]
    if c % 32 or c > 256:
        raise ValueError(f"gdn_fused: the kernel takes C % 32 == 0 and C <= 256, got C={c}")
    _build.check_tensor("x", x)
    _build.check_tensor("gamma_t", gamma_t, (c, c))
    _build.check_tensor("beta", beta, (c,))
    out = torch.empty_like(x)
    lib = _build.kernels()
    with torch.cuda.device(x.device):
        err = lib.iclr17c_gdn(
            x.data_ptr(), gamma_t.data_ptr(), beta.data_ptr(), out.data_ptr(),
            x.numel() // c, c, int(inverse), torch.cuda.current_stream().cuda_stream,
        )
    _build.check_launch(err, "gdn_fused")
    gdn_fused.launches += 1
    return out


gdn_fused.launches = 0
