"""K3: quantize + clamp + pack into coder symbols, the CUDA kernel
``csrc/quant_pack.cu`` and its plain version.

Counterpart of ``iclr_17_compression_tpu/ops/pallas/quant_pack_kernel.py``
(``_qp_kernel`` / ``quantize_pack_pallas``; plain twin ``quantize_pack_xla``).
Both return ``(symbols, dequantized)``:

    sym = clip(round(x / step), -lim, lim)      (round half to even)
    symbols = uint8(sym + lim),  dequantized = sym * step

with ``lim = round(clip / step)``. A CPU tensor goes to
``quantize_pack_plain``; a CUDA tensor launches the kernel or raises.
"""

from typing import Tuple

import torch

from . import _build


def lim_of(step: float, clip: float) -> int:
    """Clip limit in symbol units; 2*lim+1 symbols must fit a byte."""
    lim = int(round(clip / step))
    if 2 * lim + 1 > 256:
        raise ValueError(
            f"clip/step = {lim}: {2 * lim + 1} symbol values exceed uint8; "
            "use a coarser step or smaller clip"
        )
    return lim


def quantize_pack_plain(x: torch.Tensor, step: float, clip: float
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version (the twin of ``quantize_pack_xla``)."""
    lim = lim_of(step, clip)
    sym = torch.clamp(torch.round(x / step), -lim, lim)
    return (sym + lim).to(torch.uint8), sym * step


def quantize_pack(x: torch.Tensor, step: float, clip: float
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Quantize-pack: the kernel on CUDA, the plain version on CPU."""
    if x.device.type == "cpu":
        return quantize_pack_plain(x, step, clip)
    _build.forward_only("quantize_pack", x)
    lim = lim_of(step, clip)
    _build.check_tensor("x", x)
    sym = torch.empty(x.shape, device=x.device, dtype=torch.uint8)
    deq = torch.empty_like(x)
    lib = _build.kernels()
    with torch.cuda.device(x.device):
        err = lib.iclr17c_quant_pack(
            x.data_ptr(), sym.data_ptr(), deq.data_ptr(), x.numel(), float(step), lim,
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check_launch(err, "quantize_pack")
    quantize_pack.launches += 1
    return sym, deq


quantize_pack.launches = 0
