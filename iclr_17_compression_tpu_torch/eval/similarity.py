"""Latent-similarity and code-distribution analyses.

Counterpart of ``iclr_17_compression_tpu/eval/similarity.py``, the
reference's encoder-introspection scripts, on the model's device:

- ``encoder_similarity``: reference NewTests/testEncoderSimilarity.py: the
  normalized Hamming distance between the two eyes' (quantized) latents,
  their conditional entropy and uncertainty coefficient (:131-134), the
  code's global range, and optionally per-channel side-by-side latent
  images (:111-122, ``save_channel_images``, PNGs written with ``zlib``);
- ``code_distribution``: reference NewTests/testCodeDistribution.py: the
  per-channel latent variance over a dataset (:118-125), a histogram of the
  flattened code and its gzip compression factor (:110-111, ``gzip_factor``);
- ``encoder_distances``: reference NewTests/testEncoderDistances.py: the
  mean L1 / L2 distance between the two eyes' latents.
"""

import gzip
import os
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from ..data.datasets import write_png
from ..utils.analysis import conditional_entropy, uncertainty_coefficient
from ..utils.device import image_batch


def _encode_pair(model, a: np.ndarray, b: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """A DSC model's two encoder latents (z1 of ``a``, z2 of ``b``), HWC."""
    with torch.no_grad():
        out = model(image_batch(model, a), image_batch(model, b))
    return out["z1"][0].cpu().numpy(), out["z2"][0].cpu().numpy()


def save_channel_images(z1: np.ndarray, z2: np.ndarray, out_dir: str) -> List[str]:
    """Per-channel [z1; z2] stacked grayscale PNGs ``<c:04d>.png``, each
    stretched to its own range (reference testEncoderSimilarity.py:111-122)."""
    os.makedirs(out_dir, exist_ok=True)
    paths = []
    for c in range(z1.shape[-1]):
        cat = np.concatenate([z1[..., c], z2[..., c]], axis=0)
        rng = cat.max() - cat.min()
        cat = (cat - cat.min()) / (rng if rng > 0 else 1.0)
        p = os.path.join(out_dir, f"{c:04d}.png")
        write_png(p, (cat * 255).astype(np.uint8))
        paths.append(p)
    return paths


def encoder_similarity(model, pairs: Iterable[Tuple[np.ndarray, np.ndarray]],
                       quant_step: float = 1.0, dump_channels_dir: Optional[str] = None,
                       bins: int = 100) -> Dict[str, float]:
    """Latent-similarity statistics of a DSC model, averaged over stereo
    pairs; ``dump_channels_dir``: the first pair's channel images."""
    n = 0
    ham_sum = unc_sum = hcond_sum = 0.0
    c_min, c_max = np.inf, -np.inf
    for i, (a, b) in enumerate(pairs):
        z1, z2 = _encode_pair(model, a, b)
        ham_sum += float(np.mean(np.round(z1 / quant_step) != np.round(z2 / quant_step)))
        _, h2, h12 = conditional_entropy(z1.reshape(-1), z2.reshape(-1), bins)
        hcond_sum += h12 - h2  # H(z1 | z2)
        unc_sum += uncertainty_coefficient(z1.reshape(-1), z2.reshape(-1), bins)
        c_min = min(c_min, float(z1.min()), float(z2.min()))
        c_max = max(c_max, float(z1.max()), float(z2.max()))
        if dump_channels_dir is not None and i == 0:
            save_channel_images(z1, z2, dump_channels_dir)
        n += 1
    return {"normalized_hamming": ham_sum / n, "uncertainty_coefficient": unc_sum / n,
            "conditional_entropy": hcond_sum / n, "code_min": c_min, "code_max": c_max,
            "n_pairs": n}


def encoder_distances(model, pairs: Iterable[Tuple[np.ndarray, np.ndarray]]
                      ) -> Dict[str, float]:
    """Mean latent L1 / L2 (RMS) distances between the two eyes
    (reference NewTests/testEncoderDistances.py)."""
    n = 0
    l1 = l2 = 0.0
    for a, b in pairs:
        z1, z2 = _encode_pair(model, a, b)
        d = z1 - z2
        l1 += float(np.abs(d).mean())
        l2 += float(np.sqrt((d ** 2).mean()))
        n += 1
    return {"latent_l1": l1 / n, "latent_l2": l2 / n, "n_pairs": n}


def gzip_factor(code: np.ndarray, binary: bool = False) -> float:
    """The reference's compression-factor probe: element count over gzip'ed
    bits (reference testCodeDistribution.py:110-111 packs binary codes into
    bits; byte codes take the +128 uint8 layout)."""
    if binary:
        payload = np.packbits(np.asarray(code) == 0)
    else:
        payload = np.clip(np.asarray(code) + 128, 0, 255).astype(np.uint8)
    n_bits = len(gzip.compress(payload.tobytes())) * 8
    return code.size / max(n_bits, 1)


def code_distribution(model, images: Iterable[np.ndarray], code_key: str = "latent",
                      hist_bins: int = 64) -> Dict[str, np.ndarray]:
    """Per-channel variance and histogram of a single-image model's code
    (its forward's ``code_key``) over a dataset (reference
    NewTests/testCodeDistribution.py)."""
    var_sum = None
    values = []
    n = 0
    for a in images:
        with torch.no_grad():
            code = model(image_batch(model, a))[code_key][0].cpu().numpy()
        v = code.var(axis=(0, 1))  # per-channel spatial variance
        var_sum = v if var_sum is None else var_sum + v
        values.append(code.reshape(-1))
        n += 1
    flat = np.concatenate(values)
    hist, edges = np.histogram(flat, bins=hist_bins)
    return {"per_channel_variance": var_sum / n, "histogram": hist, "bin_edges": edges,
            "gzip_factor": gzip_factor(flat), "n_images": n}
