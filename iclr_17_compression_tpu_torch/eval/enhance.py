"""Enhancement-net evaluation (``FinalEnhanceNet``'s residual refinement).

Counterpart of ``iclr_17_compression_tpu/eval/enhance.py`` (reference
fast_image_filters/test_FIF_enhance.py:40-85): for each triplet (warped SI,
reconstruction, original), the net's residual over cat(reconstruction,
warped SI) added to the reconstruction and clipped; PSNR and MS-SSIM of
that and of the reconstruction alone against the original.
"""

from typing import Dict, Iterable, Optional, Tuple

import numpy as np
import torch

from ..ops.metrics import ms_ssim, ms_ssim_db
from ..utils.device import resolve_device
from .passr import _psnr


def eval_enhance(model, triplets: Iterable[Tuple[np.ndarray, np.ndarray, np.ndarray]],
                 msssim_win: int = 7, device: Optional[str] = None) -> Dict[str, float]:
    """``triplets``: (warped SI, reconstruction, original) HWC float arrays
    (``FIFEnhanceDataset`` items). ``model`` is moved to ``device`` (default
    ``cuda``). Returns the means of psnr, ms_ssim, ms_ssim_db,
    psnr_unenhanced and ms_ssim_unenhanced, and ``per_image`` rows."""
    dev = resolve_device(device)
    model = model.to(dev)
    per_image = []
    for si, rec, orig in triplets:
        s, r, o = (torch.from_numpy(np.ascontiguousarray(a, np.float32)[None]).to(dev)
                   for a in (si, rec, orig))
        with torch.no_grad():
            enhanced = torch.clamp(r + model(torch.cat([r, s], dim=-1)), 0.0, 1.0)
            ms = float(ms_ssim(enhanced, o, win_size=msssim_win))
            ms0 = float(ms_ssim(r, o, win_size=msssim_win))
        per_image.append({
            "psnr": _psnr(float(torch.mean((enhanced - o) ** 2))),
            "psnr_unenhanced": _psnr(float(torch.mean((r - o) ** 2))),
            "ms_ssim": ms,
            "ms_ssim_unenhanced": ms0,
            "ms_ssim_db": float(ms_ssim_db(torch.tensor(ms, dtype=torch.float32))),
        })
    out = {k: sum(row[k] for row in per_image) / len(per_image)
           for k in ("psnr", "ms_ssim", "ms_ssim_db", "psnr_unenhanced", "ms_ssim_unenhanced")}
    out["per_image"] = per_image
    return out
