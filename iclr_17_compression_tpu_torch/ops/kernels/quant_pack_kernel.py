"""K3: quantize + clamp + pack into coder symbols, the CUDA kernel
``csrc/quant_pack.cu`` and its plain version.

Counterpart of ``iclr_17_compression_tpu/ops/pallas/quant_pack_kernel.py``
(``_qp_kernel`` / ``quantize_pack_pallas``; plain twin ``quantize_pack_xla``).
Both return ``(symbols, dequantized)``:

    sym = clip(round(x / step), -lim, lim)      (round half to even)
    symbols = uint8(sym + lim),  dequantized = sym * step

with ``lim = round(clip / step)``. ``bits=16`` stores uint16 symbols instead
(2·lim+1 ≤ 65536): the file codec's symbols, beyond the Pallas kernel's
byte contract. A CPU tensor goes to ``quantize_pack_plain``; a CUDA tensor
launches the kernel or raises.
"""

from typing import Tuple

import torch

from . import _build


SYMBOL_DTYPES = {8: torch.uint8, 16: torch.uint16}


def lim_of(step: float, clip: float, bits: int = 8) -> int:
    """Clip limit in symbol units; 2*lim+1 symbols must fit ``bits`` bits."""
    lim = int(round(clip / step))
    if 2 * lim + 1 > 1 << bits:
        raise ValueError(
            f"clip/step = {lim}: {2 * lim + 1} symbol values exceed {bits} bits; "
            "use a coarser step or smaller clip"
        )
    return lim


def quantize_pack_plain(x: torch.Tensor, step: float, clip: float, bits: int = 8
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version (the twin of ``quantize_pack_xla``)."""
    lim = lim_of(step, clip, bits)
    sym = torch.clamp(torch.round(x / step), -lim, lim)
    return (sym + lim).to(SYMBOL_DTYPES[bits]), sym * step


def quantize_pack(x: torch.Tensor, step: float, clip: float, bits: int = 8
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Quantize-pack into ``bits``-bit symbols (8 or 16): the kernel on CUDA,
    the plain version on CPU."""
    if x.device.type == "cpu":
        return quantize_pack_plain(x, step, clip, bits)
    _build.forward_only("quantize_pack", x)
    lim = lim_of(step, clip, bits)
    _build.check_tensor("x", x)
    sym = torch.empty(x.shape, device=x.device, dtype=SYMBOL_DTYPES[bits])
    deq = torch.empty_like(x)
    lib = _build.kernels()
    launch = lib.iclr17c_quant_pack if bits == 8 else lib.iclr17c_quant_pack16
    with torch.cuda.device(x.device):
        err = launch(
            x.data_ptr(), sym.data_ptr(), deq.data_ptr(), x.numel(), float(step), lim,
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check_launch(err, "quantize_pack")
    quantize_pack.launches += 1
    return sym, deq


quantize_pack.launches = 0
