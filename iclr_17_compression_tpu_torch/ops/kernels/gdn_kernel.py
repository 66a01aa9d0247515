"""K1: fused (I)GDN, the CUDA kernel ``csrc/gdn.cu`` and its plain version.

Counterpart of ``iclr_17_compression_tpu/ops/pallas/gdn_kernel.py``
(``_gdn_kernel`` / ``_gdn_pallas_raw``). The contract is the raw one: the
parameters are the effective ``gamma_t`` = gamma.T (C, C) and ``beta`` (C,),
already un-reparameterized by ``ops.gdn.gdn_reparam``:

    norm = beta + (x*x) @ gamma_t ;  y = x / sqrt(norm)   (inverse: x * sqrt(norm))

``gdn_fused`` takes a tensor of any leading shape (..., C). A CPU tensor goes
to ``gdn_fused_plain``; a CUDA tensor launches the kernel or raises.

Two element types, as the Pallas kernel takes any (its wrapper casts γᵀ to
x's type and β to fp32): fp32 x, γᵀ and β (products in 3xTF32), or bf16 x
and γᵀ with fp32 β, where x² is rounded to bf16, the norm product runs as
one bf16 tensor-core pass accumulating in fp32, and y is computed in fp32
and rounded to bf16 once (``_gdn_kernel``'s rounding points). Launches
count in ``gdn_fused.launches``, the bf16 ones also in ``launches_bf16``.

Gradients: ``gdn_fused`` is a ``torch.autograd.Function`` on both devices.
Its backward is the counterpart of ``_gdn_fused_bwd``, which the JAX package
writes as the XLA VJP of ``gdn_xla`` (there is no Pallas backward): it
recomputes ``gdn_fused_plain`` from the saved inputs and differentiates it.
The gradient reaches the stored GDN parameters through ``gdn_reparam``'s
``lower_bound`` gate, which the caller applies outside the Function.
"""

import torch

from . import _build


def gdn_fused_plain(x: torch.Tensor, gamma_t: torch.Tensor, beta: torch.Tensor,
                    inverse: bool = False) -> torch.Tensor:
    """The plain PyTorch version (the twin of ``gdn_xla`` after reparam); on
    bf16 ``x``, ``gdn_bf16_plain``."""
    if x.dtype == torch.bfloat16:
        return gdn_bf16_plain(x, gamma_t, beta, inverse)
    norm = torch.sqrt(torch.matmul(x * x, gamma_t) + beta)
    return x * norm if inverse else x / norm


def gdn_bf16_plain(x: torch.Tensor, gamma_t: torch.Tensor, beta: torch.Tensor,
                   inverse: bool = False) -> torch.Tensor:
    """The bf16 variant at the Pallas kernel's rounding points: x² rounded to
    bf16, γᵀ cast to bf16, the product accumulated in fp32, β in fp32, y in
    fp32 rounded to bf16 once."""
    x2 = (x * x).float()
    norm = torch.matmul(x2, gamma_t.to(torch.bfloat16).float()) + beta.float()
    r = torch.sqrt(norm) if inverse else torch.rsqrt(norm)
    return (x.float() * r).to(torch.bfloat16)


def plain_vjp(plain, inputs, needs_grad, grad_out):
    """The gradients of ``plain(*inputs)`` against ``grad_out``, one for each
    input (None where ``needs_grad`` says none is wanted): the backward of the
    kernels' Functions, recomputed from their saved inputs as the JAX
    package's VJPs recompute through XLA."""
    with torch.enable_grad():
        leaves = [None if t is None else t.detach().requires_grad_(bool(need))
                  for t, need in zip(inputs, needs_grad)]
        wanted = [t for t in leaves if t is not None and t.requires_grad]
        grads = iter(torch.autograd.grad(plain(*leaves), wanted, grad_out))
        return tuple(next(grads) if t is not None and t.requires_grad else None
                     for t in leaves)


class _GDN(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, gamma_t, beta, inverse):
        ctx.save_for_backward(x, gamma_t, beta)
        ctx.inverse = inverse
        if x.device.type == "cpu":
            return gdn_fused_plain(x, gamma_t, beta, inverse)
        return _launch(x, gamma_t, beta, inverse)

    @staticmethod
    def backward(ctx, g):
        with torch.profiler.record_function("iclr17c::gdn_backward"):
            grads = plain_vjp(lambda *a: gdn_fused_plain(*a, ctx.inverse),
                              ctx.saved_tensors, ctx.needs_input_grad, g)
        return grads + (None,)


def gdn_fused(x: torch.Tensor, gamma_t: torch.Tensor, beta: torch.Tensor,
              inverse: bool = False) -> torch.Tensor:
    """(I)GDN over the last axis: the kernel on CUDA, the plain version on CPU;
    differentiable in ``x``, ``gamma_t`` and ``beta`` on both."""
    return _GDN.apply(x, gamma_t, beta, inverse)


def _launch(x, gamma_t, beta, inverse):
    c = x.shape[-1]
    if c % 32 or c > 512:
        raise ValueError(f"gdn_fused: the kernel takes C % 32 == 0 and C <= 512, got C={c}")
    dtype = _build.kernel_dtype("gdn_fused", x)
    _build.check_tensor("x", x, dtype=dtype)
    _build.check_tensor("gamma_t", gamma_t, (c, c), dtype=dtype)
    _build.check_tensor("beta", beta, (c,))
    out = torch.empty_like(x)
    lib = _build.kernels()
    bf16 = dtype == torch.bfloat16
    launch = lib.iclr17c_gdn_bf16 if bf16 else lib.iclr17c_gdn
    with torch.cuda.device(x.device):
        err = launch(
            x.data_ptr(), gamma_t.data_ptr(), beta.data_ptr(), out.data_ptr(),
            x.numel() // c, c, int(inverse), torch.cuda.current_stream().cuda_stream,
        )
    _build.check_launch(err, "gdn_fused")
    gdn_fused.launches += 1  # forward launches only: the backward runs plain PyTorch
    gdn_fused.launches_bf16 += bf16
    return out


gdn_fused.launches = 0
gdn_fused.launches_bf16 = 0
