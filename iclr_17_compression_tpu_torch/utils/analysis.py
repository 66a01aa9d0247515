"""Latent-statistics analysis tools.

Counterpart of ``iclr_17_compression_tpu/utils/analysis.py`` (reference
utils/Conditional_Entropy.py:4-33), numpy only: a 2-D histogram of paired
latents → H(z1), H(z2), H(z1, z2) and the uncertainty coefficient
U = 2(H1 + H2 − H12)/(H1 + H2).
"""

from typing import Tuple

import numpy as np


def conditional_entropy(
    z1: np.ndarray, z2: np.ndarray, bins: int = 100
) -> Tuple[float, float, float]:
    """Returns (H(z1), H(z2), H(z1, z2)) in bits from a joint histogram."""
    a = np.asarray(z1).reshape(-1)
    b = np.asarray(z2).reshape(-1)
    joint, _, _ = np.histogram2d(a, b, bins=bins)
    pj = joint / max(joint.sum(), 1)

    def h(p):
        p = p[p > 0]
        return float(-np.sum(p * np.log2(p)))

    return h(pj.sum(axis=1)), h(pj.sum(axis=0)), h(pj.reshape(-1))


def uncertainty_coefficient(z1: np.ndarray, z2: np.ndarray, bins: int = 100) -> float:
    """Symmetric uncertainty U = 2(H1 + H2 − H12)/(H1 + H2)."""
    h1, h2, h12 = conditional_entropy(z1, z2, bins)
    denom = h1 + h2
    return 2.0 * (h1 + h2 - h12) / denom if denom > 0 else 0.0
