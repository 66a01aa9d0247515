"""The yardstick's arithmetic: the H100's published peaks, the least time
of a kernel call from the work its shapes need, and the kernels' names in
a trace.

Frozen copies of ``chip_smoke.py``'s ``bound_ms``, ``bound_3xtf32_ms``,
``bound_bf16_ms``, ``k2_work``, ``k2_work_bf16`` and ``k1_work`` (and the
bf16 K1 work and the K3 work its precision phase counts), taking shapes
instead of tensors. The work is what the call's inputs need: each input byte read
once, each output byte written once; K2's products are its conv's (as
called: the blocked conv1 with its zero taps) and its GDN norm's.
"""

from dataclasses import dataclass
from typing import Optional, Tuple

# NVIDIA H100 SXM data sheet, dense, at the 700 W limit
PEAK_FP32_FLOPS = 67e12    # fp32 outside the tensor cores
PEAK_TF32_FLOPS = 495e12   # TF32 on the tensor cores
PEAK_BF16_FLOPS = 989e12   # bf16 on the tensor cores
PEAK_HBM_BYTES = 3.35e12
# the model's FLOPs against the dense peak of the storage dtype (mfu)
MODEL_PEAK = {"float32": PEAK_TF32_FLOPS, "bfloat16": PEAK_BF16_FLOPS}


def bound_ms(flops: float, nbytes: float) -> float:
    """The least time of an fp32 route on the CUDA cores."""
    return 1e3 * max(flops / PEAK_FP32_FLOPS, nbytes / PEAK_HBM_BYTES)


def bound_3xtf32_ms(mma_flops: float, elementwise_flops: float, nbytes: float) -> float:
    """The least time of the fp32 kernels' route: the products as three TF32
    products on the tensor cores, the elementwise work in fp32."""
    t_ops = 3.0 * mma_flops / PEAK_TF32_FLOPS + elementwise_flops / PEAK_FP32_FLOPS
    return 1e3 * max(t_ops, nbytes / PEAK_HBM_BYTES)


def bound_bf16_ms(bf16_flops: float, tf32x3_flops: float, elementwise_flops: float,
                  nbytes: float) -> float:
    """The least time of a bf16-storage kernel: its bf16 products at the
    bf16 peak, its fp32-accurate products (K2's GDN norm) as three TF32
    products, the elementwise work in fp32, against its bytes."""
    t_ops = (bf16_flops / PEAK_BF16_FLOPS + 3.0 * tf32x3_flops / PEAK_TF32_FLOPS
             + elementwise_flops / PEAK_FP32_FLOPS)
    return 1e3 * max(t_ops, nbytes / PEAK_HBM_BYTES)


@dataclass(frozen=True)
class KernelCall:
    """One launch of one of the port's kernels: ``kernel`` K1, K2 or K3,
    the storage dtype, the NHWC input shape; for K2 the HWIO weight shape,
    stride, padding, and whether it adds a bias and runs the GDN."""

    kernel: str
    dtype: str
    x: Tuple[int, int, int, int]
    w: Optional[Tuple[int, int, int, int]] = None
    stride: int = 1
    pad: int = 0
    bias: bool = True
    gdn: bool = True

    def out(self) -> Tuple[int, int, int, int]:
        n, h, w, _ = self.x
        k, s, p = self.w[0], self.stride, self.pad
        return n, (h + 2 * p - k) // s + 1, (w + 2 * p - k) // s + 1, self.w[3]


def _numel(shape) -> int:
    out = 1
    for d in shape:
        out *= d
    return out


def k2_work(call: KernelCall):
    """(product flops, elementwise flops, bytes) of an fp32 K2 call."""
    n, ho, wo, cout = call.out()
    kk, cin = call.w[0], call.w[2]
    p = n * ho * wo
    mma = 2.0 * p * kk * kk * cin * cout
    elementwise = p * cout if call.bias else 0.0
    nbytes = 4.0 * (_numel(call.x) + _numel(call.w) + p * cout + (cout if call.bias else 0))
    if call.gdn:
        mma += 2.0 * p * cout * cout
        elementwise += 4.0 * p * cout
        nbytes += 4.0 * (cout * cout + cout)
    return mma, elementwise, nbytes


def k2_work_bf16(call: KernelCall):
    """(conv product flops, GDN product flops, elementwise flops, bytes) of a
    bf16 K2 call: x, the weight and the output 2 bytes an element, the
    bias and the GDN parameters 4."""
    n, ho, wo, cout = call.out()
    kk, cin = call.w[0], call.w[2]
    p = n * ho * wo
    conv = 2.0 * p * kk * kk * cin * cout
    gdn = 2.0 * p * cout * cout if call.gdn else 0.0
    elementwise = (p * cout if call.bias else 0.0) + (4.0 * p * cout if call.gdn else 0.0)
    nbytes = 2.0 * (_numel(call.x) + _numel(call.w) + p * cout) + 4.0 * (
        (cout if call.bias else 0) + (cout * cout + cout if call.gdn else 0))
    return conv, gdn, elementwise, nbytes


def k1_work(call: KernelCall):
    """(product flops, elementwise flops, bytes) of an fp32 K1 call."""
    c = call.x[-1]
    p = _numel(call.x) // c
    return 2.0 * p * c * c, 4.0 * p * c, 4.0 * (2 * _numel(call.x) + c * c + c)


def k1_work_bf16(call: KernelCall):
    """(bf16 product flops, elementwise flops, bytes) of a bf16 K1 call: x,
    y and γᵀ 2 bytes an element, β 4."""
    c = call.x[-1]
    p = _numel(call.x) // c
    return 2.0 * p * c * c, 4.0 * p * c, 2.0 * 2 * _numel(call.x) + 2.0 * c * c + 4.0 * c


def k3_work(call: KernelCall):
    """(flops, bytes) of a K3 call with 8-bit symbols: x read, the symbols
    and the dequantized code written."""
    n = _numel(call.x)
    e = 2.0 if call.dtype == "bfloat16" else 4.0
    return 5.0 * n, (2.0 * e + 1.0) * n


def bound_of(call: KernelCall) -> float:
    """The least time, in ms, of a K1, K2 or K3 call on the card."""
    bf16 = call.dtype == "bfloat16"
    if call.kernel == "K2":
        if bf16:
            return bound_bf16_ms(*k2_work_bf16(call))
        return bound_3xtf32_ms(*k2_work(call))
    if call.kernel == "K1":
        if bf16:
            flops, elementwise, nbytes = k1_work_bf16(call)
            return bound_bf16_ms(flops, 0.0, elementwise, nbytes)
        return bound_3xtf32_ms(*k1_work(call))
    if call.kernel == "K3":
        return bound_ms(*k3_work(call))
    raise ValueError(f"no bound for {call.kernel}")


def kernel_of(name: str) -> Optional[str]:
    """Which of the port's kernels a device event's name is: K2 (its conv
    kernels), K2-reduce (its split-K reduction, part of a K2 call), K1, K3,
    or None for any other."""
    if "conv_gdn_reduce_kernel" in name:
        return "K2-reduce"
    if "conv_gdn_kernel" in name or "conv_gdn_bf16_kernel" in name:
        return "K2"
    if "gdn_rows_kernel" in name or "gdn_rows_bf16_kernel" in name:
        return "K1"
    if "quant_pack_kernel" in name or "quant_pack_bf16_kernel" in name:
        return "K3"
    return None
