"""Kodak-style eval: per-image and mean bpp / PSNR / MS-SSIM(-dB).

Counterpart of ``iclr_17_compression_tpu/eval/kodak.py`` (the reference's
periodic testKodak loop, train.py:157-198). The model's eval forward runs
under ``torch.no_grad()`` on the model's device: on CUDA through K2 and
K1. It takes a Ballé-17, hyperprior or joint-AR model (the metrics need
only ``recon``, ``latent`` and ``bpp``). ``use_rans`` (Ballé-17 only, as in
the JAX package) codes each latent with the port's rANS coder
(``coding/api.py``) and reports the measured stream size instead of the
estimate.
"""

from typing import Dict, Iterable, Optional, Tuple

import numpy as np
import torch

from ..coding.api import build_cdf_tables_from_bit_estimator, encode_latent
from ..ops.metrics import ms_ssim, ms_ssim_db


def eval_kodak(
    model,
    images: Iterable[np.ndarray],
    use_rans: bool = False,
    rans_bounds: Optional[Tuple[int, int]] = None,
) -> Dict[str, float]:
    """images: HWC float arrays in [0, 1] (whole frames). Symbol bounds for
    ``use_rans`` default to the latent range over the set (two passes);
    explicit ``rans_bounds`` raise if a latent falls outside them, never
    clip (a clipped symbol would decode to another latent than the one the
    metrics were computed from)."""
    if use_rans and not hasattr(model, "bitEstimator"):
        raise ValueError("use_rans codes a Ballé-17 latent against its factorized prior; "
                         f"{type(model).__name__} has none")
    device = next(model.parameters()).device

    def forward(img):
        x = torch.from_numpy(np.ascontiguousarray(img, np.float32)[None]).to(device)
        with torch.no_grad():
            out = model(x)
            mse = torch.mean((out["recon"] - x) ** 2)
        return x, out, mse

    images = list(images)
    if use_rans and rans_bounds is None:
        lo, hi = 0, 0
        for img in images:
            lat = forward(img)[1]["latent"]
            lo = min(lo, int(torch.floor(lat.min())))
            hi = max(hi, int(torch.ceil(lat.max())))
        rans_bounds = (lo, hi)

    codec = None
    per_image = []
    for img in images:
        x, out, mse = forward(img)
        p = 10.0 * np.log10(1.0 / max(float(mse), 1e-12))
        with torch.no_grad():
            ms_t = ms_ssim(out["recon"], x)
        ms = float(ms_t)
        msdb = float(ms_ssim_db(ms_t))
        bpp = float(out["bpp"])
        if use_rans:
            if codec is None:
                codec = build_cdf_tables_from_bit_estimator(
                    model.bitEstimator.params(), rans_bounds[0], rans_bounds[1])
            lat = torch.round(out["latent"][0]).cpu().numpy().astype(np.int64)
            if lat.min() < rans_bounds[0] or lat.max() > rans_bounds[1]:
                raise ValueError(
                    f"latent range [{lat.min()}, {lat.max()}] exceeds rANS bounds "
                    f"{rans_bounds}; widen rans_bounds (clipping would corrupt the "
                    "decoded latent)")
            bpp = len(encode_latent(codec, lat)) * 8.0 / (x.shape[1] * x.shape[2])
        per_image.append({"bpp": bpp, "psnr": p, "ms_ssim": ms, "ms_ssim_db": msdb})

    n = len(per_image)
    mean = {k: sum(r[k] for r in per_image) / n for k in ("bpp", "psnr", "ms_ssim", "ms_ssim_db")}
    return {**mean, "per_image": per_image}
