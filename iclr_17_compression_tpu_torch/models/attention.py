"""Cross-image attention modules of the DSC fusion presets, NHWC.

Counterpart of ``iclr_17_compression_tpu/models/attention.py``
(``bottleneck_attention``, ``_extract_patches``, ``PatchMatchAttention``):

- ``bottleneck_attention``: full cross-attention between the fused latent
  (queries) and the side-information latent (keys, which are also the
  values) over flattened spatial tokens, scale C^-½, no projections
  (preset ``att_0031bpp``);
- ``PatchMatchAttention``: queries are 9×9 non-overlapping patches of a
  conv + ReLU (``q_patches``), keys 9×9 patches at stride 3 (``k_patches``),
  similarity −‖q − k‖₂ times a learned ``scale_att``, and the output the
  attention-weighted raw 9×9 value patches folded back onto the query grid
  (preset ``bottleneck_att_1bpp``, module ``bot_mhsa``).

The −cdist is the JAX package's centered matmul expansion: the tokens are
centred on the mean key first, then ‖q‖² − 2q·kᵀ + ‖k‖² (clamped at 0).
ReLU features are positive and nearly parallel, so the expansion without
the centring cancels in fp32 and loses about 10× in accuracy.

The products are ``torch.matmul`` (cuBLAS on the card): the JAX package
computes them outside any Pallas kernel.
"""

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..nn.blocks import _Act
from ..nn.layers import TorchConv
from ..ops.conv import nchw


def bottleneck_attention(q_map: torch.Tensor, kv_map: torch.Tensor,
                         scale: Optional[float] = None) -> torch.Tensor:
    """softmax(q kᵀ · s) k over NHWC maps; ``s`` defaults to C^-½."""
    n, h, w, c = q_map.shape
    if scale is None:
        scale = float(c) ** -0.5
    q = q_map.reshape(n, h * w, c)
    k = kv_map.reshape(n, kv_map.shape[1] * kv_map.shape[2], c)
    att = torch.softmax(torch.matmul(q, k.transpose(1, 2)) * scale, dim=-1)
    return torch.matmul(att, k).reshape(n, h, w, c)


def _extract_patches(x: torch.Tensor, size: int, stride: int
                     ) -> Tuple[torch.Tensor, int, int]:
    """NHWC → ((N, nH, nW, C·size·size) sliding patches, nH, nW), each patch
    flattened channel-major as ``F.unfold`` orders it: (C, size, size)."""
    n, h, w, c = x.shape
    nh = (h - size) // stride + 1
    nw = (w - size) // stride + 1
    patches = F.unfold(nchw(x), size, stride=stride)  # (N, C·size·size, nH·nW)
    return patches.transpose(1, 2).reshape(n, nh, nw, c * size * size), nh, nw


class PatchMatchAttention(nn.Module):
    """Learned patch-match attention (q: the fused latent, k and v: the
    side-information latent). Keys ``q_patches.0``, ``k_patches.0`` and
    ``scale_att``, as the reference's ``BottleneckAttention_modified``.

    ``v_img``: an optional value image of ``v_scale`` = v_img.H / kv_img.H
    times the keys' size: value patches of ``p·v_scale`` px at stride
    ``stride_v·v_scale`` (as many as the keys), and an output ``v_scale``
    times larger. A map smaller than one patch gives no token, and the
    output then has no pixel, as in the JAX package.
    """

    def __init__(self, dim: int, dim_head: Optional[int] = None, patch_size: int = 9,
                 stride_v: int = 3):
        super().__init__()
        d = dim_head or dim
        self.dim_head, self.patch_size, self.stride_v = d, patch_size, stride_v
        self.q_patches = nn.Sequential(TorchConv(dim, d, patch_size, stride=patch_size),
                                       _Act("relu"))
        self.k_patches = nn.Sequential(TorchConv(dim, d, patch_size, stride=stride_v),
                                       _Act("relu"))
        self.scale_att = nn.Parameter(torch.ones(()))

    def forward(self, q_img: torch.Tensor, kv_img: torch.Tensor,
                v_img: Optional[torch.Tensor] = None) -> torch.Tensor:
        p, sv, d = self.patch_size, self.stride_v, self.dim_head
        if v_img is None:
            v_img = kv_img
        v_scale = v_img.shape[1] // kv_img.shape[1]
        if v_img.shape[1] != kv_img.shape[1] * v_scale:
            raise ValueError("v_img's size must be an integer multiple of kv_img's")
        pv, svv = p * v_scale, sv * v_scale
        n, cimg = q_img.shape[0], v_img.shape[-1]
        if min(q_img.shape[1:3]) < p or min(kv_img.shape[1:3]) < p:
            hq, wq = (max(0, (s - p) // p + 1) for s in q_img.shape[1:3])
            return v_img.new_zeros((n, hq * pv, wq * pv, cimg))

        q = self.q_patches(q_img)
        k = self.k_patches(kv_img)
        _, hq, wq, _ = q.shape
        qf = q.reshape(n, hq * wq, d)
        kf = k.reshape(n, -1, d)
        v_patches, _, _ = _extract_patches(v_img, pv, svv)
        vf = v_patches.reshape(n, -1, v_patches.shape[-1])  # (N, nk, C·pv·pv)

        mu = kf.mean(dim=1, keepdim=True)
        qf = qf - mu
        kf = kf - mu
        q2 = (qf * qf).sum(dim=-1, keepdim=True)
        k2 = (kf * kf).sum(dim=-1, keepdim=True)
        qk = torch.matmul(qf, kf.transpose(1, 2))
        dist2 = torch.clamp(q2 - 2.0 * qk + k2.transpose(1, 2), min=0.0)
        att = torch.softmax(-torch.sqrt(dist2 + 1e-12) * self.scale_att, dim=-1)
        out = torch.matmul(att, vf)
        # refold (N, hq·wq, C·pv·pv) → (N, hq·pv, wq·pv, C), channel-major patches
        out = out.reshape(n, hq, wq, cimg, pv, pv).permute(0, 1, 4, 2, 5, 3)
        return out.reshape(n, hq * pv, wq * pv, cimg)
