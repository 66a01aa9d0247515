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

On bf16 ``x`` (the kernel's bf16 variant) the rounding points are
``_qp_kernel``'s, where the Python floats are weakly typed: x·bf16(1/step)
is rounded to bf16 before the round, and ``dequantized`` is
bf16(sym·bf16(step)); the clamp takes the integer ``lim`` (exact in bf16
up to the byte contract's 127) and the symbols are as in fp32. Launches
count in ``quantize_pack.launches``, the bf16 ones also in
``launches_bf16``.
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


def bf16_scalars(step: float) -> Tuple[float, float]:
    """(bf16(1/step), bf16(step)) as floats: a Python float meets a bf16
    array as bf16 in the Pallas kernel."""
    pair = torch.tensor([1.0 / step, step], dtype=torch.bfloat16).float()
    return float(pair[0]), float(pair[1])


def quantize_pack_plain(x: torch.Tensor, step: float, clip: float, bits: int = 8
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version (the twin of ``quantize_pack_xla``; on bf16
    ``x`` that of ``_qp_kernel``'s bf16 arithmetic)."""
    lim = lim_of(step, clip, bits)
    if x.dtype == torch.bfloat16:
        inv, stp = bf16_scalars(step)
        v = (x.float() * inv).to(torch.bfloat16).float()
        sym = torch.clamp(torch.round(v), -lim, lim)
        return (sym + lim).to(SYMBOL_DTYPES[bits]), (sym * stp).to(torch.bfloat16)
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
    dtype = _build.kernel_dtype("quantize_pack", x)
    _build.check_tensor("x", x, dtype=dtype)
    sym = torch.empty(x.shape, device=x.device, dtype=SYMBOL_DTYPES[bits])
    deq = torch.empty_like(x)
    lib = _build.kernels()
    bf16 = dtype == torch.bfloat16
    if bf16:
        launch = lib.iclr17c_quant_pack_bf16 if bits == 8 else lib.iclr17c_quant_pack16_bf16
        scalars = bf16_scalars(step)
    else:
        launch = lib.iclr17c_quant_pack if bits == 8 else lib.iclr17c_quant_pack16
        scalars = (float(step),)
    with torch.cuda.device(x.device):
        err = launch(
            x.data_ptr(), sym.data_ptr(), deq.data_ptr(), x.numel(), *scalars, lim,
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check_launch(err, "quantize_pack")
    quantize_pack.launches += 1
    quantize_pack.launches_bf16 += bf16
    return sym, deq


quantize_pack.launches = 0
quantize_pack.launches_bf16 = 0
