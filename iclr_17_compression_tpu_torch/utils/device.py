"""Where the port runs.

Entry points run on the card unless the caller asks for the CPU: with no
CUDA device and no explicit ``device="cpu"`` they raise, and never drift to
the CPU.

The JAX package computes in fp32 at precision HIGHEST unless its policy
says otherwise (``ops/precision.py``). On an H100, PyTorch runs fp32
convolutions through cuDNN in TF32 unless told otherwise, which moves the
decoder about 1e-3 away from the reference. ``apply_precision`` sets cuDNN's
and cuBLAS's flags to the policy (at the default, ``highest``: TF32 off) for
the whole process; ``resolve_device`` calls it, and so does every port
model's forward on a CUDA tensor (``precision_on_cuda``). The flags are global
on purpose: autograd runs a model's cuDNN backward after its forward has
returned, under whatever flags hold then, so a context manager around the
forward alone would leave the backward in TF32.

``cudnn_deterministic`` is a context manager for a computation whose
encoder and decoder must give the same floats (the hyperprior's σ): cuDNN
may otherwise run a transposed conv through an algorithm that sums with
atomics, whose result changes from call to call in the last bits. It is
not for the large 3×3 convs: cuDNN's deterministic choice there is an FFT
and GEMV path 100× slower with 18 GiB of workspace (H100, cuDNN of
torch 2.11).

``cudnn_autotune`` is a context manager for training steps: cuDNN picks
each convolution's algorithm by timing it (``benchmark``), among the
deterministic ones, as XLA autotunes its GPU convolutions. Without it
cuDNN's heuristic takes an FFT route for the joint-AR model's fp32 3×3
convs at C = 192 (``PERF.md``).
"""

import contextlib
from typing import Optional, Union

import numpy as np
import torch

from ..ops.precision import apply_precision


def precision_on_cuda(x: torch.Tensor) -> None:
    """Apply the precision policy's flags where ``x`` lies on the card."""
    if x.device.type == "cuda":
        apply_precision()


def image_batch(model: torch.nn.Module, img: np.ndarray) -> torch.Tensor:
    """An HWC image as a (1, H, W, C) float32 tensor on ``model``'s device."""
    dev = next(model.parameters()).device
    return torch.from_numpy(np.ascontiguousarray(img, np.float32)[None]).to(dev)


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless given."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the port runs on the GPU; pass device='cpu' "
                "to run the plain PyTorch path on the CPU"
            )
        apply_precision()
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


@contextlib.contextmanager
def cudnn_deterministic():
    """cuDNN restricted to deterministic algorithms, and not choosing them
    by timing, for the enclosed calls; the flags are restored after."""
    saved = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved


@contextlib.contextmanager
def cudnn_autotune():
    """cuDNN choosing its algorithms by timing, among the deterministic
    ones, for the enclosed calls; the flags are restored after."""
    saved = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved
