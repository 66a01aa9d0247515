"""Ablation tools for the DSC models.

Counterpart of ``iclr_17_compression_tpu/eval/ablation.py``, on the port's
``DSCStereoModel`` (its device: on CUDA through K2 and K3):

- ``greedy_channel_mask_search``: greedy search for the least useful code
  channels, masking one more channel at a time and keeping the one whose
  loss raises the MSE least (reference NewTests/test_channel_mask.py:59-108);
  ``masked_mses`` is one step of it;
- ``si_only_recon`` / ``code_only_recon``: the reconstruction from the side
  information alone (the SI image fed as both eyes, reference
  NewTests/testAblationNetwork.py:112-114) or from the code alone (the SI
  latent zeroed, the cat ablation of reference models/temp.py:274-275);
  ``zero_si_model`` is the latter's model, sharing the caller's weights;
- ``two_level_recon``: residual two-level coding, base recon + a coded diff
  image, final = rec + diff − 127/255 (reference
  NewTests/test2LevelReconstruction.py:62-63).
"""

import dataclasses
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from ..models.dsc import DSCStereoModel
from ..utils.device import image_batch


def masked_mses(model: DSCStereoModel, pairs: Sequence[Tuple[np.ndarray, np.ndarray]],
                chosen: Sequence[int]) -> Dict[int, float]:
    """For each code channel not in ``chosen``: the MSE of the recon, summed
    over ``pairs``, with ``chosen`` and that channel masked."""
    n_ch = model.config.code_channels
    ims = [(image_batch(model, a), image_batch(model, b)) for a, b in pairs]
    out = {}
    for ch in range(n_ch):
        if ch in chosen:
            continue
        mask = torch.zeros(n_ch, device=ims[0][0].device)
        mask[list(chosen) + [ch]] = 1.0
        total = 0.0
        with torch.no_grad():
            for im1, im2 in ims:
                recon = model(im1, im2, mask_channels=mask)["recon"]
                total += float(torch.mean((recon - im1) ** 2))
        out[ch] = total
    return out


def greedy_channel_mask_search(model: DSCStereoModel,
                               pairs: Sequence[Tuple[np.ndarray, np.ndarray]],
                               n_mask: int) -> List[int]:
    """Channel indices in the order they were chosen for masking (the first
    of equal MSEs wins, as in the JAX package)."""
    chosen: List[int] = []
    for _ in range(n_mask):
        mses = masked_mses(model, pairs, chosen)
        best_ch, best_mse = None, float("inf")
        for ch, total in mses.items():
            if total < best_mse:
                best_mse, best_ch = total, ch
        chosen.append(best_ch)
    return chosen


def si_only_recon(model: DSCStereoModel, im2: np.ndarray) -> np.ndarray:
    """The reconstruction from side information alone: the SI image fed as
    both eyes (reference NewTests/testAblationNetwork.py:113:
    model(input2, input2))."""
    x = image_batch(model, im2)
    with torch.no_grad():
        return model(x, x)["recon"][0].cpu().numpy()


def zero_si_model(model: DSCStereoModel) -> DSCStereoModel:
    """``model`` with ``si_mode="zero_si"``, in eval mode, sharing its
    parameters and buffers (no copy); ``model`` is left as it was."""
    cfg = dataclasses.replace(model.config, si_mode="zero_si")
    with torch.device("meta"):
        ablated = DSCStereoModel(cfg)
    ablated.load_state_dict(model.state_dict(), assign=True)
    return ablated.eval()


def code_only_recon(model: DSCStereoModel, im1: np.ndarray) -> np.ndarray:
    """The reconstruction with the SI latent zeroed (the cat ablation,
    models/temp.py:275)."""
    x = image_batch(model, im1)
    with torch.no_grad():
        return zero_si_model(model)(x, x)["recon"][0].cpu().numpy()


def two_level_recon(base_recon: np.ndarray, orig: np.ndarray, diff_codec_fn) -> np.ndarray:
    """Residual second level: code diff = clip(orig − rec + 127/255), decode
    it with ``diff_codec_fn`` and compose final = rec + diff̂ − 127/255."""
    offset = 127.0 / 255.0
    diff = np.clip(orig - base_recon + offset, 0.0, 1.0)
    diff_hat = diff_codec_fn(diff)
    return np.clip(base_recon + diff_hat - offset, 0.0, 1.0)
