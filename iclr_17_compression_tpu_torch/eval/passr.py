"""PASSRnet stereo-SR evaluation.

Counterpart of ``iclr_17_compression_tpu/eval/passr.py`` (reference
NewTests/test_passrNet.py:98-160): for each test triplet (LR left, HR
right, HR left), the net's SR left eye clipped to [0, 1]; PSNR and MS-SSIM
against the HR left eye, and the PSNR of the blurred input itself, so that
the SR gain shows.
"""

from typing import Dict, Iterable, Optional, Tuple

import numpy as np
import torch

from ..ops.metrics import ms_ssim, ms_ssim_db
from ..utils.device import resolve_device


def _psnr(mse: float) -> float:
    return 10.0 * np.log10(1.0 / max(mse, 1e-12))


def eval_passr(model, triplets: Iterable[Tuple[np.ndarray, np.ndarray, np.ndarray]],
               msssim_win: int = 7, device: Optional[str] = None) -> Dict[str, float]:
    """``triplets``: (blurry left, HR right, HR left) HWC float arrays
    (``StereoPassrDataset`` items). ``model`` (a ``PASSRnet``) is moved to
    ``device`` (default ``cuda``). Returns the means of psnr, psnr_input,
    ms_ssim and ms_ssim_db, and ``per_image`` rows of the same keys."""
    dev = resolve_device(device)
    model = model.to(dev)
    per_image = []
    for blurry, right, left in triplets:
        b, r, hr = (torch.from_numpy(np.ascontiguousarray(a, np.float32)[None]).to(dev)
                    for a in (blurry, right, left))
        with torch.no_grad():
            sr = torch.clamp(model(b, r, train=False), 0.0, 1.0)
            tgt = hr[:, : sr.shape[1], : sr.shape[2]]
            blr = b[:, : sr.shape[1], : sr.shape[2]]
            ms = float(ms_ssim(sr, tgt, win_size=msssim_win))
        per_image.append({
            "psnr": _psnr(float(torch.mean((sr - tgt) ** 2))),
            "psnr_input": _psnr(float(torch.mean((blr - tgt) ** 2))),
            "ms_ssim": ms,
            "ms_ssim_db": float(ms_ssim_db(torch.tensor(ms, dtype=torch.float32))),
        })
    out = {k: sum(row[k] for row in per_image) / len(per_image)
           for k in ("psnr", "ms_ssim", "ms_ssim_db", "psnr_input")}
    out["per_image"] = per_image
    return out
