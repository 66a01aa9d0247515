"""Loss library of the auxiliary experiments, NHWC (latents any (..., C)).

Counterpart of ``iclr_17_compression_tpu/train/losses.py`` (reference
losses.py, cited per function): plain tensor functions, no kernel.
``edge_loss`` blurs with the reference's 5-tap Gaussian as a depthwise
convolution with zero padding ("SAME"), as the JAX package does.
"""

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.conv import nchw, nhwc


def charbonnier_loss(x: torch.Tensor, y: torch.Tensor, eps: float = 1e-3) -> torch.Tensor:
    """mean(sqrt(diff² + eps²)) (reference losses.py:195-206)."""
    d = x - y
    return torch.mean(torch.sqrt(d * d + eps * eps))


def _pair_latent_mse(e1: torch.Tensor, e2: torch.Tensor) -> torch.Tensor:
    """Per-pair mean latent squared distance: (B, ...) → (B,)."""
    d = (e1 - e2).reshape(e1.shape[0], -1)
    return torch.mean(d * d, dim=1)


def contrastive_loss_pairs_only(e1: torch.Tensor, e2: torch.Tensor,
                                margin: float = 1.0) -> torch.Tensor:
    """Hinge on the per-pair latent MSE above ``margin`` (reference
    losses.py:6-26)."""
    return torch.mean(torch.clamp(_pair_latent_mse(e1, e2) - margin, min=0.0))


def contrastive_loss(e1: torch.Tensor, e2: torch.Tensor, margin: float = 1.0,
                     w_pos: float = 1.8, w_neg: float = 0.2) -> torch.Tensor:
    """Pos/neg pairwise hinge (reference losses.py:29-68): the pairs (i, i)
    pulled under ``margin``, the pairs (i, j ≠ i) pushed above it."""
    b = e1.shape[0]
    f1, f2 = e1.reshape(b, -1), e2.reshape(b, -1)
    d2 = torch.mean((f1[:, None, :] - f2[None, :, :]) ** 2, dim=-1)  # (B, B)
    eye = torch.eye(b, dtype=torch.bool, device=e1.device)
    pos = torch.mean(torch.clamp(torch.diagonal(d2) - margin, min=0.0))
    off = torch.where(eye, torch.zeros_like(d2), d2)
    neg = torch.mean(torch.clamp(margin - off, min=0.0) * (~eye)) * (b * b / max(b * b - b, 1))
    return w_pos * pos + w_neg * neg


def mse_and_pair_hamming_loss(recon, target, e1, e2, margin: float = 1.0,
                              w_latent: float = 1.0) -> torch.Tensor:
    """Recon MSE + hinged latent distance (reference losses.py:72-97)."""
    mse = torch.mean((recon - target) ** 2)
    return mse + w_latent * torch.mean(torch.clamp(_pair_latent_mse(e1, e2) - margin, min=0.0))


def l1_and_pair_hamming_loss(recon, target, e1, e2, margin: float = 1.0,
                             w_latent: float = 1.0, eps: float = 1e-3) -> torch.Tensor:
    """Charbonnier + hinged latent L1 (reference losses.py:99-117)."""
    d = torch.mean(torch.abs(e1 - e2).reshape(e1.shape[0], -1), dim=1)
    return charbonnier_loss(recon, target, eps) + w_latent * torch.mean(
        torch.clamp(d - margin, min=0.0))


def mse_and_contrastive_loss(recon, target, e1, e2, margin: float = 1.0,
                             w: float = 1.0) -> torch.Tensor:
    """(reference losses.py:119-136)"""
    return torch.mean((recon - target) ** 2) + w * contrastive_loss(e1, e2, margin)


def l1_and_contrastive_loss(recon, target, e1, e2, margin: float = 1.0,
                            w: float = 1.0) -> torch.Tensor:
    """(reference losses.py:138-155)"""
    return charbonnier_loss(recon, target) + w * contrastive_loss(e1, e2, margin)


def mse_and_blank_contrastive_loss(recon, target, e1, e2, w: float = 1.0) -> torch.Tensor:
    """Recon MSE + the symmetric KL between the softmaxed log10-latents of
    the pair (reference losses.py:158-188)."""
    mse = torch.mean((recon - target) ** 2)
    p = torch.log10(torch.abs(e1) + 1e-6)
    q = torch.log10(torch.abs(e2) + 1e-6)
    pn = torch.softmax(p.reshape(p.shape[0], -1), dim=-1)
    qn = torch.softmax(q.reshape(q.shape[0], -1), dim=-1)
    kl_pq = torch.sum(pn * (torch.log(pn + 1e-10) - torch.log(qn + 1e-10)), dim=-1)
    kl_qp = torch.sum(qn * (torch.log(qn + 1e-10) - torch.log(pn + 1e-10)), dim=-1)
    return mse + w * torch.mean(0.5 * (kl_pq + kl_qp))


def _gauss_kernel() -> np.ndarray:
    """The reference's 5×5 blur: the outer product of (.05, .25, .4, .25, .05)."""
    k = np.array([0.05, 0.25, 0.4, 0.25, 0.05], np.float32)
    return np.outer(k, k)


def edge_loss(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Laplacian-pyramid edge loss (reference losses.py:208-236): Charbonnier
    on img − blur(upsample(downsample(blur(img)))), the upsample putting
    4× each kept pixel at the even positions and zeros between."""
    c = x.shape[-1]
    k = torch.from_numpy(_gauss_kernel()).to(x.device, x.dtype)
    kernel = k[None, None].repeat(c, 1, 1, 1)  # depthwise (C, 1, 5, 5)

    def blur(img):
        return nhwc(F.conv2d(nchw(img).contiguous(), kernel, padding=2, groups=c))

    def lap(img):
        blurred = blur(img)
        up = torch.zeros_like(blurred)
        up[:, ::2, ::2, :] = blurred[:, ::2, ::2, :] * 4.0
        return img - blur(up)

    return charbonnier_loss(lap(x), lap(y))


def edge_and_charbonnier_loss(x: torch.Tensor, y: torch.Tensor,
                              w_edge: float = 0.05) -> torch.Tensor:
    """(reference losses.py:238-247)"""
    return charbonnier_loss(x, y) + w_edge * edge_loss(x, y)
