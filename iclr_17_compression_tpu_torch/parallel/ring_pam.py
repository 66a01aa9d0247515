"""Ring-attention PAM: W-tiled parallax attention over a list of tiles.

Counterpart of ``iclr_17_compression_tpu/parallel/ring_pam.py``. PAM
(``models/passr.py``, reference models/PASSRnet.py:124-136) computes a full
W×W attention per image row, so its K/V span the whole width. H-tiling
needs no attention communication (``make_tiled_dsc(..., axis='height')``);
this module is the W-tiled alternative, the ring-attention construction on
one process driving the tiles' devices:

- the residual block's convs run per tile on one overlap of its radius
  (``halo.stack_tiles``), the 1×1 convs per tile;
- K/V segments rotate around the ring of tiles (tile i receives tile
  i−1's, a copy to its device) while each tile folds them into a
  flash-attention-style online softmax (running max, denominator,
  numerator), so no tile ever holds the full W×W score matrix or the
  gathered K/V;
- the validity mask needs COLUMN sums of the opposite direction's attention
  (Σ over queries of the softmax mass landing on each key position,
  reference PASSRnet.py:141-146): a second ring rotates (query, max,
  denominator) so each tile accumulates the mass its own keys receive;
- the mask's morphology runs per tile on one overlap of its radius (12
  columns), the fusion conv per tile.

Numerics match the replicated PAM up to fp32 associativity.
"""

from fractions import Fraction
from typing import List, Optional, Sequence

import torch

from ..utils.device import precision_on_cuda
from .halo import local_tiles, stack_tiles
from .mesh import replicated, split_tiles
from .tiled import PAM_MASK_RADIUS


def _rotate(tiles: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """One ring step: tile i takes tile i−1's tensor onto its device."""
    n = len(tiles)
    return [tiles[(i - 1) % n].to(tiles[i].device) for i in range(n)]


def _scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """(n, h, i, c) × (n, h, j, c) → fp32 (n, h, i, j)."""
    return torch.matmul(q.float(), k.float().transpose(-1, -2))


def _ring_softmax_apply(q: Sequence[torch.Tensor], k: Sequence[torch.Tensor],
                        v: Optional[Sequence[torch.Tensor]]):
    """Online-softmax ring: per tile (softmax(q·kᵀ) @ v or None without
    ``v``, running max, denominator) over the FULL (ring-gathered) key
    axis; q stays local."""
    n = len(q)
    m = [torch.full(t.shape[:3], -1e30, dtype=torch.float32, device=t.device) for t in q]
    l = [torch.zeros(t.shape[:3], dtype=torch.float32, device=t.device) for t in q]
    acc = ([torch.zeros(t.shape[:3] + v[0].shape[3:], dtype=torch.float32, device=t.device)
            for t in q] if v is not None else None)
    k_cur, v_cur = list(k), (list(v) if v is not None else None)
    for step in range(n):
        for i in range(n):
            s = _scores(q[i], k_cur[i])
            m_new = torch.maximum(m[i], s.amax(dim=-1))
            scale = torch.exp(m[i] - m_new)
            p = torch.exp(s - m_new[..., None])
            l[i] = l[i] * scale + p.sum(dim=-1)
            if acc is not None:
                acc[i] = acc[i] * scale[..., None] + torch.matmul(p, v_cur[i].float())
            m[i] = m_new
        if step < n - 1:
            k_cur = _rotate(k_cur)
            if v_cur is not None:
                v_cur = _rotate(v_cur)
    out = [a / d[..., None] for a, d in zip(acc, l)] if acc is not None else None
    return out, m, l


def _ring_column_mass(q: Sequence[torch.Tensor], k: Sequence[torch.Tensor],
                      m: Sequence[torch.Tensor], l: Sequence[torch.Tensor]):
    """Σ_i softmax(q·kᵀ)[i, j] for each tile's LOCAL keys j, ring-rotating
    the (query, max, denominator) of a prior ring pass."""
    n = len(k)
    col = [torch.zeros(t.shape[:3], dtype=torch.float32, device=t.device) for t in k]
    q_cur, m_cur, l_cur = list(q), list(m), list(l)
    for step in range(n):
        for i in range(n):
            s = _scores(q_cur[i], k[i])  # (n, h, i, j_local)
            col[i] = col[i] + (torch.exp(s - m_cur[i][..., None]) / l_cur[i][..., None]).sum(
                dim=2)
        if step < n - 1:
            q_cur, m_cur, l_cur = _rotate(q_cur), _rotate(m_cur), _rotate(l_cur)
    return col


def pam_eval_ring(pam, x_left, x_right, mesh) -> List[torch.Tensor]:
    """The W-tiled PAM eval forward (``models.passr.PAM``, ``train=False``)
    of ``pam`` on NHWC feature maps (tensors split over ``mesh``'s tile
    devices along W, or lists of tiles): the fused left features, one tile
    a tile device."""
    from ..models.passr import clean_mask

    xl = x_left if isinstance(x_left, (list, tuple)) else split_tiles(x_left, mesh)
    xr = x_right if isinstance(x_right, (list, tuple)) else split_tiles(x_right, mesh)
    precision_on_cuda(xl[0])
    pams = replicated(pam, mesh)
    rbs = [p.rb for p in pams]
    buf_l, buf_r = stack_tiles(rbs, xl), stack_tiles(rbs, xr)
    q_l, k_l = [p.b1(t) for p, t in zip(pams, buf_l)], [p.b2(t) for p, t in zip(pams, buf_l)]
    q_r, k_r = [p.b1(t) for p, t in zip(pams, buf_r)], [p.b2(t) for p, t in zip(pams, buf_r)]
    val = [p.b3(t) for p, t in zip(pams, xr)]
    fused, _, _ = _ring_softmax_apply(q_l, k_r, val)
    # the mask's direction: right queries over left keys; the column mass is
    # the attention each left position receives
    _, m, l = _ring_softmax_apply(q_r, k_l, None)
    col = _ring_column_mass(q_r, k_l, m, l)
    mask = [(c > 0.1).to(torch.float32)[..., None] for c in col]
    mask = local_tiles([clean_mask] * len(mask), [mask],
                       (Fraction(PAM_MASK_RADIUS), Fraction(1)))
    return [p.fusion(torch.cat([f.to(x.dtype), x, v.to(x.dtype)], dim=-1))
            for p, f, x, v in zip(pams, fused, xl, mask)]

