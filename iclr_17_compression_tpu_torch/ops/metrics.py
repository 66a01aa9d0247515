"""Image quality metrics: PSNR, SSIM, MS-SSIM.

Counterpart of ``iclr_17_compression_tpu/ops/metrics.py`` (the reference's
torch msssim): a gaussian window of sigma 1.5 as a separable VALID
depthwise filter (``win_size`` = min(win, H, W)), the contrast term
``cs = mean(v1/v2)``, 5 levels with weights (0.0448, 0.2856, 0.3001,
0.2363, 0.1333), 2×2 average pooling between levels, and
``prod(cs_l^w_l for l < L) · ssim_L^w_L``. NHWC in, a scalar out.

The filters are ``F.conv2d(groups=C)`` in fp32, as the JAX package runs
them in XLA outside any Pallas kernel; on a CUDA tensor they set the
precision policy's flags first (``utils.device.apply_precision``: TF32 off
at the default, as the JAX package pins them to HIGHEST).
``ms_ssim_db`` is the reference's reporting scale -10·log10(1 - v).
``ms_ssim_sums`` / ``ms_ssim_of_sums``: the per-level sums a train step
split over a mesh pools into the whole batch's MS-SSIM (``train/state.py``).
"""

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.device import apply_precision

MSSSIM_WEIGHTS = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333)


def psnr(a: torch.Tensor, b: torch.Tensor, data_range: float = 1.0) -> torch.Tensor:
    """Peak signal-to-noise ratio, mean over the whole tensor."""
    mse = torch.mean((a.float() - b.float()) ** 2)
    return 10.0 * torch.log10(data_range * data_range / torch.clamp(mse, min=1e-20))


def _gaussian_window(win_size: int, sigma: float = 1.5) -> np.ndarray:
    x = np.arange(win_size, dtype=np.float64) - win_size // 2
    g = np.exp(-(x ** 2) / (2.0 * sigma ** 2))
    return (g / g.sum()).astype(np.float32)


def _window_filter(x: torch.Tensor, win: torch.Tensor) -> torch.Tensor:
    """Depthwise separable VALID gaussian filter of an NCHW tensor: the rows
    first, then the columns, as the JAX package."""
    c, k = x.shape[1], win.numel()
    x = F.conv2d(x, win.view(1, 1, k, 1).expand(c, 1, k, 1), groups=c)
    return F.conv2d(x, win.view(1, 1, 1, k).expand(c, 1, 1, k), groups=c)


def _ssim_maps(img1, img2, win_size, data_range):
    """The SSIM map and the contrast (cs) map of NCHW images."""
    win_size = min(win_size, img1.shape[2], img1.shape[3])
    win = torch.from_numpy(_gaussian_window(win_size)).to(img1.device, img1.dtype)
    mu1 = _window_filter(img1, win)
    mu2 = _window_filter(img2, win)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma1_sq = _window_filter(img1 * img1, win) - mu1_sq
    sigma2_sq = _window_filter(img2 * img2, win) - mu2_sq
    sigma12 = _window_filter(img1 * img2, win) - mu1_mu2
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    v1 = 2.0 * sigma12 + c2
    v2 = sigma1_sq + sigma2_sq + c2
    ssim_map = ((2.0 * mu1_mu2 + c1) * v1) / ((mu1_sq + mu2_sq + c1) * v2)
    return ssim_map, v1 / v2


def _ssim_nchw(img1, img2, win_size, data_range):
    ssim_map, cs_map = _ssim_maps(img1, img2, win_size, data_range)
    return torch.mean(ssim_map), torch.mean(cs_map)


def _nchw32(img: torch.Tensor) -> torch.Tensor:
    if img.device.type == "cuda":
        apply_precision()
    return img.float().permute(0, 3, 1, 2)


def ssim(img1: torch.Tensor, img2: torch.Tensor, win_size: int = 11,
         data_range: float = 1.0, full: bool = False):
    """SSIM over NHWC images: a scalar, or (ssim, cs) if ``full``."""
    s, cs = _ssim_nchw(_nchw32(img1), _nchw32(img2), win_size, data_range)
    return (s, cs) if full else s


def _safe_pow(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x**w where x > 0, else 0, with a zero (never NaN) gradient at x <= 0:
    cs and ssim dip negative early in training, and d/dx max(x, 0)**w is
    inf·0 there."""
    pos = x > 0.0
    safe = torch.where(pos, x, torch.ones_like(x))
    return torch.where(pos, safe ** w, torch.zeros_like(x))


def _levels(img1, img2, levels):
    """The NCHW image pairs of each MS-SSIM level (2×2 average pooling
    between levels)."""
    img1, img2 = _nchw32(img1), _nchw32(img2)
    for _ in range(levels):
        yield img1, img2
        img1 = F.avg_pool2d(img1, 2)
        img2 = F.avg_pool2d(img2, 2)


def _combine(mssim: torch.Tensor, mcs: torch.Tensor, levels: int) -> torch.Tensor:
    """prod(cs_l^w_l for l < L) · ssim_L^w_L of each level's means."""
    weights = torch.tensor(MSSSIM_WEIGHTS[:levels], device=mssim.device)
    pow_cs = _safe_pow(mcs, weights)
    pow_ssim = _safe_pow(mssim, weights)
    return torch.prod(pow_cs[:-1]) * pow_ssim[-1]


def ms_ssim(img1: torch.Tensor, img2: torch.Tensor, win_size: int = 11,
            data_range: float = 1.0, levels: int = 5) -> torch.Tensor:
    """Multi-scale SSIM over NHWC images (scalar)."""
    mssim, mcs = [], []
    for a, b in _levels(img1, img2, levels):
        s, cs = _ssim_nchw(a, b, win_size, data_range)
        mssim.append(s)
        mcs.append(cs)
    return _combine(torch.stack(mssim), torch.stack(mcs), levels)


def ms_ssim_sums(img1: torch.Tensor, img2: torch.Tensor, win_size: int = 11,
                 data_range: float = 1.0, levels: int = 5):
    """What ``ms_ssim`` takes the means of: per level the sums of the SSIM
    and cs maps, a (2, levels) tensor, and their element counts, a tuple.
    MS-SSIM is a global statistic: the sums of the parts of a batch split
    along N (each image whole) add up to the whole batch's, and
    ``ms_ssim_of_sums`` of them is its MS-SSIM, where the mean of the
    parts' MS-SSIMs is not."""
    sums, counts = [], []
    for a, b in _levels(img1, img2, levels):
        ssim_map, cs_map = _ssim_maps(a, b, win_size, data_range)
        sums.append(torch.stack([ssim_map.sum(), cs_map.sum()]))
        counts.append(ssim_map.numel())
    return torch.stack(sums, dim=1), tuple(counts)


def ms_ssim_of_sums(sums: torch.Tensor, counts) -> torch.Tensor:
    """MS-SSIM from ``ms_ssim_sums``'s (summed) sums and counts."""
    means = sums / torch.tensor(counts, dtype=sums.dtype, device=sums.device)
    return _combine(means[0], means[1], sums.shape[1])


def ms_ssim_db(v: torch.Tensor) -> torch.Tensor:
    """-10·log10(1 - ms_ssim), the reference's dB reporting scale."""
    return -10.0 * torch.log10(torch.clamp(1.0 - v, min=1e-20))
