"""Where the port runs.

Entry points run on the card unless the caller asks for the CPU: with no
CUDA device and no explicit ``device="cpu"`` they raise, and never drift to
the CPU.

The JAX package computes in fp32 at precision HIGHEST. On an H100, PyTorch
runs fp32 convolutions through cuDNN in TF32 unless told otherwise, which
moves the decoder about 1e-3 away from the reference. ``resolve_device``
therefore turns TF32 off, for cuDNN and for matmuls, for the whole process.
"""

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless given."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the port runs on the GPU; pass device='cpu' "
                "to run the plain PyTorch path on the CPU"
            )
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev
