"""Checkpoint mix-and-match evaluations.

Counterpart of ``iclr_17_compression_tpu/eval/mix.py``:

- ``mix_encoder_decoder``: a codec's state_dict with the encoder's weights
  from one checkpoint and the rest from another (reference
  NewTests/testReconSeperateEandD.py);
- ``eval_single_image``: PSNR / MS-SSIM of a single-image codec over a
  dataset, with its best and worst images (reference
  NewTests/testModelRecon.py:120-171);
- ``average_two_models``: the same with the recons of two models averaged
  (reference NewTests/testAverage2Models.py).

They work on the port's ``state_dict``s and models (any single-image codec
whose forward gives ``recon``), on the model's device: on CUDA through the
kernels.
"""

import os
from typing import Dict, Iterable, Sequence

import numpy as np
import torch

from ..data.datasets import write_png
from ..ops.metrics import ms_ssim
from ..utils.device import image_batch


def mix_encoder_decoder(state_a: Dict[str, torch.Tensor], state_b: Dict[str, torch.Tensor],
                        encoder_keys: Sequence[str] = ("Encoder",)) -> Dict[str, torch.Tensor]:
    """A state_dict taking the entries under ``encoder_keys`` (top-level
    module names) from A, the rest from B."""
    mixed = dict(state_b)
    for top in encoder_keys:
        taken = {k: v for k, v in state_a.items() if k.split(".", 1)[0] == top}
        if not taken:
            tops = sorted({k.split(".", 1)[0] for k in state_a})
            raise KeyError(f"{top!r} not in checkpoint A (has {tops})")
        mixed.update(taken)
    return mixed


def _psnr(mse: torch.Tensor) -> float:
    return 10.0 * float(np.log10(1.0 / max(float(mse), 1e-12)))


def eval_single_image(model, images: Iterable[np.ndarray], dump_dir: str = "") -> Dict:
    """PSNR / MS-SSIM of ``model`` over ``images`` (HWC in [0, 1]).

    ``dump_dir``: when set, the best- and worst-PSNR originals and
    reconstructions are written there as PNGs (``best_recon_<i>.png``, …).
    The result carries ``best``/``worst`` (index and PSNR) either way."""
    n, psnr_sum, ms_sum = 0, 0.0, 0.0
    best = (-np.inf, -1, None)  # (psnr, index, recon)
    worst = (np.inf, -1, None)
    originals = []
    for a in images:
        im = image_batch(model, a)
        with torch.no_grad():
            recon = model(im)["recon"]
            p = _psnr(torch.mean((recon - im) ** 2))
            ms_sum += float(ms_ssim(recon, im))
        psnr_sum += p
        if p > best[0]:
            best = (p, n, recon[0].cpu().numpy())
        if p < worst[0]:
            worst = (p, n, recon[0].cpu().numpy())
        originals.append(a if dump_dir else None)
        n += 1

    if dump_dir and n:
        os.makedirs(dump_dir, exist_ok=True)
        for tag, (_, idx, rec) in (("best", best), ("worst", worst)):
            for name, arr in ((f"{tag}_recon", rec), (f"{tag}_original", originals[idx])):
                u8 = np.clip(np.asarray(arr) * 255.0 + 0.5, 0, 255).astype(np.uint8)
                write_png(os.path.join(dump_dir, f"{name}_{idx}.png"), u8)

    return {"psnr": psnr_sum / n, "ms_ssim": ms_sum / n, "n_images": n,
            "best": {"index": best[1], "psnr": best[0]},
            "worst": {"index": worst[1], "psnr": worst[0]}}


def average_two_models(model_a, model_b, images: Iterable[np.ndarray]) -> Dict[str, float]:
    """PSNR / MS-SSIM with recon = (recon_A + recon_B) / 2 (reference
    NewTests/testAverage2Models.py); both models on one device."""
    n, psnr_sum, ms_sum = 0, 0.0, 0.0
    for a in images:
        im = image_batch(model_a, a)
        with torch.no_grad():
            recon = 0.5 * (model_a(im)["recon"] + model_b(im)["recon"])
            psnr_sum += _psnr(torch.mean((recon - im) ** 2))
            ms_sum += float(ms_ssim(recon, im))
        n += 1
    return {"psnr": psnr_sum / n, "ms_ssim": ms_sum / n, "n_images": n}
