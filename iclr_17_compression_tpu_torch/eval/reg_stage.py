"""Two-stage (base + rate-regression) evaluation at the 0.0625-bpp point.

Counterpart of ``iclr_17_compression_tpu/eval/reg_stage.py`` (reference
NewTests/test_regModel_0_0625.py:98-135): a frozen 0.031-bpp base model
reconstructs im1 from its coarse code and the side information; the
regression stage sends a second code whose decoded, unclipped output is a
residual added onto the base reconstruction; the rate is the sum of both
codes.
"""

from typing import Dict, Iterable, Tuple

import numpy as np
import torch

from ..coding.api import build_cdf_tables_from_histogram, encode_latent, gzip_bpp
from ..ops.metrics import ms_ssim, ms_ssim_db


def compose_recon(base_recon: torch.Tensor, reg_recon_raw: torch.Tensor) -> torch.Tensor:
    """final = clip(base + residual) (reference test_regModel_0_0625.py:113)."""
    return torch.clamp(base_recon + reg_recon_raw, 0.0, 1.0)


def _rans_bpp(code: np.ndarray, step: float, n_pix: int) -> float:
    """Measured rate of one coarse code: rANS stream + in-band table cost."""
    sym = np.round(code / step).astype(np.int64)
    codec = build_cdf_tables_from_histogram(sym)
    stream = encode_latent(codec, sym)
    table_bytes = codec.ntables * codec.nsym * 2 + 8
    return (len(stream) + table_bytes) * 8.0 / n_pix


def eval_reg_stage(base_model, reg_model, pairs: Iterable[Tuple[np.ndarray, np.ndarray]],
                   msssim_win: int = 7) -> Dict[str, float]:
    """PSNR / MS-SSIM of the composed reconstruction and the summed two-code
    rate, per image and mean. ``base_model``/``reg_model``: ``DSCStereoModel``s
    (temp_0031bpp and reg_0_0625 in the reference workflow) on one device."""
    device = next(base_model.parameters()).device
    b_step = float(base_model.config.coarse_step)
    r_step = float(reg_model.config.coarse_step)
    keys = ("psnr", "ms_ssim", "ms_ssim_db", "bpp_gzip", "bpp_rans", "bpp_base", "bpp_reg")
    per_image = []
    for a, b in pairs:
        im1 = torch.from_numpy(np.ascontiguousarray(a, np.float32)[None]).to(device)
        im2 = torch.from_numpy(np.ascontiguousarray(b, np.float32)[None]).to(device)
        with torch.no_grad():
            base = base_model(im1, im2)
            reg = reg_model(im1, im2)
            final = compose_recon(base["recon"], reg["recon_raw"])
            mse = float(torch.mean((final - im1) ** 2))
            ms_t = ms_ssim(final, im1, win_size=msssim_win)
        n_pix = im1.shape[1] * im1.shape[2]
        bc = base["code"][0].cpu().numpy()
        rc = reg["code"][0].cpu().numpy()
        # the reference gzips both codes' byte strings together
        both = np.concatenate([bc.reshape(-1) / b_step, rc.reshape(-1) / r_step])
        bb = _rans_bpp(bc, b_step, n_pix)
        br = _rans_bpp(rc, r_step, n_pix)
        per_image.append({
            "psnr": 10.0 * np.log10(1.0 / max(mse, 1e-12)),
            "ms_ssim": float(ms_t),
            "ms_ssim_db": float(ms_ssim_db(torch.tensor(float(ms_t), dtype=torch.float32))),
            "bpp_gzip": gzip_bpp(both * 16.0, n_pix),
            "bpp_base": bb, "bpp_reg": br, "bpp_rans": bb + br,
        })
    out = {k: sum(r[k] for r in per_image) / len(per_image) for k in keys}
    out["per_image"] = per_image
    return out
