"""Matmul / conv precision policy and bf16 storage.

Counterpart of ``iclr_17_compression_tpu/ops/precision.py``. The JAX package
threads a ``lax.Precision`` into every matmul-class op; on the card the same
choice is made by PyTorch's global flags for cuDNN convolutions and cuBLAS
fp32 matmuls. The names and their meaning are the JAX package's:

  highest / float32        fp32 products: TF32 off in cuDNN and cuBLAS (the
                           default, and what the port ran before the policy)
  high / tensorfloat32     TF32 in cuDNN and cuBLAS
  default / bfloat16       TF32 in cuDNN, bf16 passes for cuBLAS fp32 matmuls
                           (``torch.set_float32_matmul_precision("medium")``)

``ICLR17C_PRECISION`` picks the default at import, as in JAX (an unknown
name reads as ``highest``); ``set_default_precision`` changes it, and
``apply_precision`` sets the flags of the current policy (every port
model's CUDA forward calls it, through ``utils.device.precision_on_cuda``).
``precision_scope`` sets a policy for the enclosed calls and puts policy
and flags back after.

The policy does not reach the hand-written kernels: K1 and K2 on fp32
storage compute their products in 3xTF32 whatever it says, as the Pallas
kernels' dots take no ``precision=`` argument.

``cast_storage`` is the knob for bf16 *storage* inference: params and
inputs cast once, so that every activation lives in device memory as bf16
and K1, K2 and K3 run their bf16 variants. Keep training in fp32 (the JAX
package's policy: bf16 gradients diverge).

``promoted`` is what the file codecs of the hyperprior and joint models run
on bf16-stored weights. Their stages pass fp32 host arrays to each other;
the JAX functions (``compress`` / ``decompress``) hand those to convs with
bf16 weights, which ``lax.conv_general_dilated`` refuses (it requires equal
dtypes, whatever the image's dtype). The port computes what dtype
promotion would: fp32 with the bf16-rounded weights, held in the tests
against the JAX functions on the same weights upcast to fp32.
"""

import contextlib
import copy
import os
from typing import Optional

import torch

_NAMES = {
    "default": "default",
    "bfloat16": "default",
    "high": "high",
    "tensorfloat32": "high",
    "highest": "highest",
    "float32": "highest",
}

# name -> (cuDNN allow_tf32, torch.set_float32_matmul_precision argument)
_FLAGS = {
    "highest": (False, "highest"),
    "high": (True, "high"),
    "default": (True, "medium"),
}

_default = _NAMES.get(os.environ.get("ICLR17C_PRECISION", "highest"), "highest")


def set_default_precision(name: str) -> None:
    """Make ``name`` the policy from now on (a KeyError for an unknown name).
    The flags change at the next ``apply_precision``."""
    global _default
    _default = _NAMES[name]


def get_precision(override: Optional[str] = None) -> str:
    """The canonical policy name: ``override`` where given, else the default."""
    return _default if override is None else _NAMES[override]


def apply_precision(name: Optional[str] = None) -> None:
    """Set cuDNN's and cuBLAS's fp32 flags to the policy ``name`` (the
    current one when None). Only the legacy flag API is used, so that
    ``torch.get_float32_matmul_precision`` keeps working."""
    cudnn_tf32, matmul = _FLAGS[get_precision(name)]
    torch.backends.cudnn.allow_tf32 = cudnn_tf32
    torch.set_float32_matmul_precision(matmul)


def current_flags() -> tuple:
    """(cuDNN allow_tf32, cuBLAS fp32 matmul precision) as they stand."""
    try:
        matmul = torch.get_float32_matmul_precision()
    except RuntimeError:  # set through both flag APIs: read the legacy bit
        matmul = "high" if torch.backends.cuda.matmul.allow_tf32 else "highest"
    return torch.backends.cudnn.allow_tf32, matmul


@contextlib.contextmanager
def precision_scope(name: str):
    """Run the enclosed calls under policy ``name``; the previous policy and
    flags are restored after."""
    saved_policy, (saved_cudnn, saved_matmul) = _default, current_flags()
    set_default_precision(name)
    apply_precision()
    try:
        yield
    finally:
        set_default_precision(saved_policy)
        torch.backends.cudnn.allow_tf32 = saved_cudnn
        torch.set_float32_matmul_precision(saved_matmul)


def cast_storage(obj, dtype: torch.dtype):
    """Cast every floating-point parameter and buffer of an ``nn.Module`` (in
    place; the module is returned), or every floating-point tensor of a
    dict / list / tuple tree (a new tree), to ``dtype``. Integer leaves
    (step counters, symbol tables) pass through untouched."""
    if isinstance(obj, torch.nn.Module):
        return obj.to(dtype)  # casts floating-point parameters and buffers only
    if isinstance(obj, torch.Tensor):
        return obj.to(dtype) if obj.is_floating_point() else obj
    if isinstance(obj, dict):
        return type(obj)((k, cast_storage(v, dtype)) for k, v in obj.items())
    if isinstance(obj, (list, tuple)):
        items = [cast_storage(v, dtype) for v in obj]
        return type(obj)(*items) if hasattr(obj, "_fields") else type(obj)(items)
    return obj


def promoted(module: torch.nn.Module) -> torch.nn.Module:
    """``module`` itself where every floating-point parameter and buffer is
    fp32; else a copy with each of them upcast to fp32 (exact), so that the
    computation runs in the promotion of fp32 inputs and the stored
    weights."""
    tensors = list(module.parameters()) + list(module.buffers())
    if all(t.dtype == torch.float32 for t in tensors if t.is_floating_point()):
        return module
    return copy.deepcopy(module).float()
