"""Scale-indexed rANS tables for the hyperprior and joint-AR codecs.

Counterpart of ``iclr_17_compression_tpu/coding/gaussian.py``, the same
numpy and ``scipy.special.erf`` arithmetic, so its tables equal the JAX
package's entry for entry. The joint-autoregressive codec
(``models/cheng2020.py``) codes ``sym = round(y - mu)`` against N(0, sigma);
the scale hyperprior (``models/hyperprior.py``) codes ``round(y)`` against
Laplace(0, sigma), or ``round(y / sigma)`` against one unit-Laplace row. A
continuous sigma cannot index a static table, so it is snapped to a fixed
log-spaced scale table, and each level gets one quantized CDF row. Encoder
and decoder derive the same indices because both compute sigma from the
same network outputs.
"""

import functools
import math

import numpy as np

from .api import RansCodec, _quantize_pmf

SCALES_MIN = 0.11
SCALES_MAX = 256.0
SCALES_LEVELS = 64


def default_scale_table(smin: float = SCALES_MIN, smax: float = SCALES_MAX,
                        levels: int = SCALES_LEVELS) -> np.ndarray:
    """Log-spaced scale grid over [smin, smax], ``levels`` entries."""
    return np.exp(np.linspace(math.log(smin), math.log(smax), levels)).astype(np.float64)


def scale_indices(sigma: np.ndarray, table: np.ndarray) -> np.ndarray:
    """The index of the smallest table entry >= sigma, clipped to the last
    level (int32)."""
    idx = np.searchsorted(table, np.asarray(sigma, np.float64), side="left")
    return np.clip(idx, 0, len(table) - 1).astype(np.int32)


def _normal_cdf(x: np.ndarray) -> np.ndarray:
    from scipy.special import erf

    return 0.5 * (1.0 + erf(x / math.sqrt(2.0)))


def _laplace_cdf(x: np.ndarray, b: float) -> np.ndarray:
    return 0.5 - 0.5 * np.sign(x) * np.expm1(-np.abs(x) / b)


def _build(cdf, scale_table: np.ndarray, max_value: int, scale_bits: int,
           tail_mass: float) -> RansCodec:
    """One CDF row per scale over the symbols [-max_value, max_value]: the
    probability of k is cdf(k + ½) − cdf(k − ½), the two end bins take the
    tails, and every bin holds at least ``tail_mass``."""
    grid = np.arange(-max_value, max_value + 1, dtype=np.float64)
    rows = []
    for s in np.asarray(scale_table, np.float64):
        upper = cdf(grid + 0.5, s)
        lower = cdf(grid - 0.5, s)
        pmf = upper - lower
        pmf[0] += lower[0]
        pmf[-1] += 1.0 - upper[-1]
        rows.append(_quantize_pmf(np.maximum(pmf, tail_mass), scale_bits))
    return RansCodec(np.stack(rows), offset=-max_value, scale_bits=scale_bits)


def build_gaussian_codec(scale_table: np.ndarray, max_value: int, scale_bits: int = 14,
                         tail_mass: float = 1e-9) -> RansCodec:
    """N(0, sigma) rows, one per entry of ``scale_table``."""
    return _build(lambda x, s: _normal_cdf(x / s), scale_table, max_value, scale_bits,
                  tail_mass)


def build_laplace_codec(scale_table: np.ndarray, max_value: int, scale_bits: int = 14,
                        tail_mass: float = 1e-9) -> RansCodec:
    """Laplace(0, b) rows, one per entry of ``scale_table``:
    F(x) = ½ + sign(x)·(1 − exp(−|x|/b))/2."""
    return _build(_laplace_cdf, scale_table, max_value, scale_bits, tail_mass)


@functools.lru_cache(maxsize=64)
def default_laplace_codec(max_value: int, scale_bits: int = 14) -> RansCodec:
    """The default-table Laplace codec, memoized (callers must not mutate
    it)."""
    return build_laplace_codec(default_scale_table(), max_value, scale_bits)


@functools.lru_cache(maxsize=8)
def unit_laplace_codec(max_value: int, scale_bits: int = 14) -> RansCodec:
    """One Laplace(0, 1) row, for the σ-normalized symbols ``round(y/σ)``."""
    return build_laplace_codec(np.ones((1,)), max_value, scale_bits)


@functools.lru_cache(maxsize=64)
def default_gaussian_codec(max_value: int, scale_bits: int = 14) -> RansCodec:
    """The default-table Gaussian codec, memoized (callers must not mutate
    it)."""
    return build_gaussian_codec(default_scale_table(), max_value, scale_bits)
