"""ctypes wrapper of the native joint-AR host context library (``src/ar_ctx.cc``).

Counterpart of ``iclr_17_compression_tpu/coding/ar_native.py``. The context
pass runs on the host so that encoder and decoder compute bit-identical
mu/sigma (``models/cheng2020.py``); this library moves its per-wavefront
math (the tap gather, four SGEMMs, the activations) from numpy into C++
with scratch allocated once. It is built with ``g++`` into the port's build
directory on first use (``ops/kernels/_build.py``), and calls the LP64
OpenBLAS that the scipy wheel bundles (``scipy.libs/libscipy_openblas*.so``,
found at run time).

There is no silent fallback: ``NativeAR.create`` raises when the library
does not build or the BLAS is not found. The numpy path gives other floats
in the last bits, so the backend is an explicit choice of the caller, and a
file must be decoded with the backend that encoded it.
"""

import ctypes
import functools
import glob
import os

import numpy as np

from ..ops.kernels import _build

_f32p = ctypes.POINTER(ctypes.c_float)
_i64p = ctypes.POINTER(ctypes.c_int64)


def find_blas() -> str:
    """The path of scipy's bundled LP64 OpenBLAS (its cblas symbols are
    prefixed ``scipy_``). numpy's bundle is ILP64, unusable with int32
    arguments, so it is not searched."""
    import scipy

    libs = os.path.join(os.path.dirname(os.path.dirname(scipy.__file__)), "scipy.libs")
    hits = sorted(glob.glob(os.path.join(libs, "libscipy_openblas*.so")))
    if not hits:
        raise RuntimeError(f"native AR host backend: no libscipy_openblas*.so under {libs}")
    return hits[0]


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.ar_ctx()
    lib.ar_create.restype = ctypes.c_void_p
    lib.ar_create.argtypes = [ctypes.c_char_p] + [_f32p] * 6 + [_i64p] * 2 + [ctypes.c_int] * 5
    lib.ar_destroy.restype = None
    lib.ar_destroy.argtypes = [ctypes.c_void_p]
    lib.ar_mu_sigma.restype = None
    lib.ar_mu_sigma.argtypes = [ctypes.c_void_p, _f32p, ctypes.c_int, _f32p, ctypes.c_int,
                                _i64p, _i64p, ctypes.c_int, ctypes.c_float, _f32p, _f32p]
    return lib


def _fp(a: np.ndarray):
    return a.ctypes.data_as(_f32p)


def _ip(a: np.ndarray):
    return a.ctypes.data_as(_i64p)


class NativeAR:
    """Owns one ``ar_ctx`` handle; ``mu_sigma`` is
    ``_HostARContext.mu_sigma_batch`` in C++."""

    def __init__(self, handle: int, m: int, keep: tuple):
        self._h = handle
        self._m = m
        self._keep = keep

    @classmethod
    def create(cls, w_taps: np.ndarray, w0_c: np.ndarray, ep1: tuple, ep2: tuple,
               off_r: np.ndarray, off_c: np.ndarray, m: int) -> "NativeAR":
        """``w_taps`` (n_taps·m, 2m), ``w0_c`` (2m, c0), ``ep1`` = (w1 (c0, c1),
        b1), ``ep2`` = (w2 (c1, 2m), b2), the taps' row and column offsets."""
        lib = _lib()
        blas = find_blas()
        (w1, b1), (w2, b2) = ep1, ep2
        arrs = tuple(np.ascontiguousarray(a, np.float32) for a in (w_taps, w0_c, w1, b1, w2, b2))
        offs = tuple(np.ascontiguousarray(o, np.int64) for o in (off_r, off_c))
        n_taps = offs[0].shape[0]
        if arrs[0].shape != (n_taps * m, 2 * m):
            raise ValueError(f"w_taps {arrs[0].shape}, expected {(n_taps * m, 2 * m)}")
        c0, c1, c2 = arrs[1].shape[1], arrs[2].shape[1], arrs[4].shape[1]
        if c2 != 2 * m:
            raise ValueError("entropy_parameters must output (sigma, mu): 2M channels")
        handle = lib.ar_create(blas.encode(), *(_fp(a) for a in arrs), *(_ip(o) for o in offs),
                               m, n_taps, c0, c1, c2)
        if not handle:
            raise RuntimeError(f"native AR host backend: no sgemm in {blas}")
        return cls(handle, m, (lib,))

    def mu_sigma(self, y_hat_pad: np.ndarray, base: np.ndarray, ii: np.ndarray,
                 jj: np.ndarray, scale_bound: float):
        p = int(ii.shape[0])
        mu = np.empty((p, self._m), np.float32)
        sigma = np.empty((p, self._m), np.float32)
        y_hat_pad = np.ascontiguousarray(y_hat_pad, np.float32)
        base = np.ascontiguousarray(base, np.float32)
        _lib().ar_mu_sigma(self._h, _fp(y_hat_pad), int(y_hat_pad.shape[1]), _fp(base),
                           int(base.shape[1]), _ip(np.ascontiguousarray(ii, np.int64)),
                           _ip(np.ascontiguousarray(jj, np.int64)), p, float(scale_bound),
                           _fp(mu), _fp(sigma))
        return mu, sigma

    def __del__(self):
        if getattr(self, "_h", None):
            self._keep[0].ar_destroy(self._h)
            self._h = None
