"""Image quality metrics. Counterpart of ``psnr`` in
``iclr_17_compression_tpu/ops/metrics.py``; SSIM and MS-SSIM wait for the
evaluation slice."""

import torch


def psnr(a: torch.Tensor, b: torch.Tensor, data_range: float = 1.0) -> torch.Tensor:
    """Peak signal-to-noise ratio, mean over the whole tensor."""
    mse = torch.mean((a.float() - b.float()) ** 2)
    return 10.0 * torch.log10(data_range * data_range / torch.clamp(mse, min=1e-20))
