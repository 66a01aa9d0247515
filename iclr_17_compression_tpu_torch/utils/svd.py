"""SVD low-rank re-quantization of the DSC coarse code.

Counterpart of ``iclr_17_compression_tpu/utils/svd.py`` (reference
svd_experiment/svd_utils.py:9-25), numpy only: flatten the (h, w, c) code to
an (h·w, c) matrix, keep the top-i singular triples, recompose, and snap back
onto the transmission grid (round(x/16)·16). The experiment (hooked at
reference models/temp.py:263-268) measures how much rate the low-rank
structure can shed before the reconstruction's quality collapses.
"""

from typing import Tuple

import numpy as np


def decompose_top_i(code: np.ndarray, i: int):
    """Top-i SVD factors of the flattened code.

    code: (h, w, c) or (1, h, w, c). Returns (U, S, Vt, (h, w, c))."""
    z = np.asarray(code)
    if z.ndim == 4:
        z = z[0]
    h, w, c = z.shape
    u, s, vt = np.linalg.svd(z.reshape(h * w, c).astype(np.float64), full_matrices=False)
    return u[:, :i], s[:i], vt[:i, :], (h, w, c)


def compose_requantized(
    u: np.ndarray, s: np.ndarray, vt: np.ndarray, shape: Tuple[int, int, int],
    step: float = 16.0,
) -> np.ndarray:
    """Recompose and snap back to the transmission grid."""
    h, w, c = shape
    recon = np.round((u * s) @ vt / step) * step
    return recon.reshape(h, w, c).astype(np.float32)


def low_rank_code(code: np.ndarray, rank: int, step: float = 16.0) -> np.ndarray:
    """One call: code → its rank-``rank`` requantized code, same rank of array."""
    u, s, vt, shape = decompose_top_i(code, rank)
    out = compose_requantized(u, s, vt, shape, step)
    return out[None] if np.asarray(code).ndim == 4 else out


def rank_rate_bits(shape: Tuple[int, int, int], rank: int, bits_per_value: float = 8.0) -> float:
    """Rate of shipping the factors instead of the full code:
    (h·w + c + 1)·rank values."""
    h, w, c = shape
    return (h * w + c + 1) * rank * bits_per_value
