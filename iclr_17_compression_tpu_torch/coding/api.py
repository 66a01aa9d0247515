"""Entropy coding: CDF tables → host C++ rANS bitstreams.

Counterpart of ``iclr_17_compression_tpu/coding/api.py`` for the factorized
prior and the DSC code: ``_quantize_pmf``, ``RansCodec``,
``build_cdf_tables_from_bit_estimator``, ``build_cdf_tables_from_histogram``
(the DSC code's in-band tables), ``encode_latent``, ``decode_latent``,
``StreamingDecoder`` (the joint-AR codec's symbol-by-symbol decode) and
``gzip_bpp`` (the reference's rate proxy). The coder is the port's own copy of
``rans.cc`` (``coding/src/``), built with g++ into the port's build directory
on first use (``ops/kernels/_build.py``).

The CDF tables are always evaluated on the CPU in fp32, whatever device the
model is on, so a file encoded on the GPU decodes with identical tables on
any host. They can differ from the JAX package's tables by ±1 count where
XLA's and PyTorch's float32 tanh/softplus differ by an ulp; given the same
tables and latent, the stream is byte-identical to the JAX coder's.
"""

import ctypes
import functools
import gzip
from typing import Optional, Tuple

import numpy as np
import torch

from ..ops.entropy import BitEstimatorParams, BitparmParams, bit_estimator_cdf
from ..ops.kernels import _build

_u8p = ctypes.POINTER(ctypes.c_uint8)
_i32p = ctypes.POINTER(ctypes.c_int32)
_u32p = ctypes.POINTER(ctypes.c_uint32)


@functools.lru_cache(maxsize=None)
def _get_lib() -> ctypes.CDLL:
    lib = _build.rans()
    lib.rans_encode_indexed.restype = ctypes.c_int
    lib.rans_encode_indexed.argtypes = [
        _i32p, _i32p, ctypes.c_int64, _u32p, _u32p,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, _u8p, ctypes.c_int64,
    ]
    lib.rans_decode_indexed.restype = ctypes.c_int
    lib.rans_decode_indexed.argtypes = [
        _u8p, ctypes.c_int64, _i32p, ctypes.c_int64, _u32p, _u32p,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, _i32p,
    ]
    lib.rans_dec_create.restype = ctypes.c_void_p
    lib.rans_dec_create.argtypes = [
        _u8p, ctypes.c_int64, _u32p, _u32p, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
    ]
    lib.rans_dec_step.restype = ctypes.c_int
    lib.rans_dec_step.argtypes = [ctypes.c_void_p, _i32p, ctypes.c_int64, _i32p]
    lib.rans_dec_free.restype = None
    lib.rans_dec_free.argtypes = [ctypes.c_void_p]
    return lib


def _quantize_pmf(pmf: np.ndarray, scale_bits: int) -> np.ndarray:
    """Quantize a pmf row to integers summing to 1<<scale_bits, all > 0.
    Deterministic (largest-remainder after floor with min-1 floor)."""
    total = 1 << scale_bits
    pmf = np.maximum(pmf.astype(np.float64), 1e-12)
    pmf = pmf / pmf.sum()
    f = np.floor(pmf * total).astype(np.int64)
    f = np.maximum(f, 1)
    diff = total - int(f.sum())
    if diff > 0:
        order = np.argsort(-(pmf * total - np.floor(pmf * total)), kind="stable")
        f[order[:diff]] += 1
    elif diff < 0:
        order = np.argsort(-f, kind="stable")
        i = 0
        while diff < 0:
            j = order[i % len(order)]
            if f[j] > 1:
                f[j] -= 1
                diff += 1
            i += 1
    return f.astype(np.uint32)


class RansCodec:
    """Per-channel static-table rANS codec over integer symbols."""

    def __init__(self, freqs: np.ndarray, offset: int, scale_bits: int = 14):
        """freqs: (ntables, nsym) uint32 rows summing to 1<<scale_bits.
        offset: symbol = int_value - offset."""
        if freqs.ndim != 2:
            raise ValueError(f"freqs must be (ntables, nsym), got shape {freqs.shape}")
        self.freqs = np.ascontiguousarray(freqs, np.uint32)
        self.cums = np.ascontiguousarray(
            np.concatenate(
                [np.zeros((freqs.shape[0], 1), np.uint32),
                 np.cumsum(freqs, axis=1)[:, :-1].astype(np.uint32)],
                axis=1,
            )
        )
        self.offset = int(offset)
        self.scale_bits = int(scale_bits)
        self.nsym = freqs.shape[1]
        self.ntables = freqs.shape[0]

    def encode(self, values: np.ndarray, table_ids: np.ndarray) -> bytes:
        lib = _get_lib()
        sym = np.ascontiguousarray(values.reshape(-1) - self.offset, np.int32)
        tid = np.ascontiguousarray(table_ids.reshape(-1), np.int32)
        if sym.shape != tid.shape:
            raise ValueError("values and table_ids differ in size")
        if sym.size and (sym.min() < 0 or sym.max() >= self.nsym):
            raise ValueError(
                f"symbol out of range [{self.offset}, {self.offset + self.nsym})"
            )
        cap = sym.size * 4 + 64
        out = np.empty(cap, np.uint8)
        n = lib.rans_encode_indexed(
            sym.ctypes.data_as(_i32p), tid.ctypes.data_as(_i32p), sym.size,
            self.freqs.ctypes.data_as(_u32p), self.cums.ctypes.data_as(_u32p),
            self.nsym, self.ntables, self.scale_bits, out.ctypes.data_as(_u8p), cap,
        )
        if n < 0:
            raise RuntimeError("rANS encode failed")
        return bytes(out[:n].tobytes())

    def decode(self, stream: bytes, table_ids: np.ndarray) -> np.ndarray:
        lib = _get_lib()
        tid = np.ascontiguousarray(table_ids.reshape(-1), np.int32)
        buf = np.frombuffer(stream, np.uint8)
        sym = np.empty(tid.size, np.int32)
        rc = lib.rans_decode_indexed(
            buf.ctypes.data_as(_u8p), buf.size, tid.ctypes.data_as(_i32p), tid.size,
            self.freqs.ctypes.data_as(_u32p), self.cums.ctypes.data_as(_u32p),
            self.nsym, self.ntables, self.scale_bits, sym.ctypes.data_as(_i32p),
        )
        if rc != 0:
            raise RuntimeError("rANS decode failed")
        return sym + self.offset


class StreamingDecoder:
    """A stateful rANS decoder over a codec's tables, for a stream whose
    table ids are not known up front (the joint-AR codec: symbol i's scale
    index comes from the symbols before it). ``step(table_ids)`` decodes the
    next ``len(table_ids)`` symbols in forward order. A context manager;
    ``close`` frees the native decoder."""

    def __init__(self, codec: RansCodec, stream: bytes):
        self._lib = _get_lib()
        self._codec = codec
        buf = np.frombuffer(stream, np.uint8)
        self._handle = self._lib.rans_dec_create(
            buf.ctypes.data_as(_u8p), buf.size, codec.freqs.ctypes.data_as(_u32p),
            codec.cums.ctypes.data_as(_u32p), codec.nsym, codec.ntables, codec.scale_bits,
        )
        if not self._handle:
            raise RuntimeError("rANS streaming decoder: create failed")

    def step(self, table_ids: np.ndarray) -> np.ndarray:
        if not self._handle:
            raise RuntimeError("rANS streaming decoder: closed")
        tid = np.ascontiguousarray(np.asarray(table_ids).reshape(-1), np.int32)
        sym = np.empty(tid.size, np.int32)
        if self._lib.rans_dec_step(self._handle, tid.ctypes.data_as(_i32p), tid.size,
                                   sym.ctypes.data_as(_i32p)) != 0:
            raise RuntimeError("rANS streaming decode failed")
        return sym + self._codec.offset

    def close(self) -> None:
        if getattr(self, "_handle", None):
            self._lib.rans_dec_free(self._handle)
            self._handle = None

    def __enter__(self) -> "StreamingDecoder":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __del__(self):
        self.close()


def _cpu_params(params: BitEstimatorParams) -> BitEstimatorParams:
    def cpu(t):
        return None if t is None else t.detach().to("cpu", torch.float32)

    return BitEstimatorParams(*(BitparmParams(*(cpu(t) for t in p)) for p in params))


def build_cdf_tables_from_bit_estimator(
    params: BitEstimatorParams, zmin: int, zmax: int, scale_bits: int = 14
) -> RansCodec:
    """Evaluate the BitEstimator CDF per channel on the integer grid
    [zmin, zmax] (on the CPU, fp32) and quantize to integer frequencies."""
    if zmax - zmin + 1 > 1 << scale_bits:
        # every symbol needs a count of at least 1 out of 1 << scale_bits
        raise ValueError(f"{zmax - zmin + 1} symbols in [{zmin}, {zmax}] do not fit "
                         f"{scale_bits}-bit tables")
    params = _cpu_params(params)
    ch = params.f1.h.shape[0]
    x = torch.arange(zmin, zmax + 1, dtype=torch.float32)[:, None].expand(-1, ch)
    with torch.no_grad():
        upper = bit_estimator_cdf(x + 0.5, params).numpy().astype(np.float64)
        lower = bit_estimator_cdf(x - 0.5, params).numpy().astype(np.float64)
    pmf = np.maximum(upper - lower, 0.0).T  # (C, nsym)
    freqs = np.stack([_quantize_pmf(row, scale_bits) for row in pmf])
    return RansCodec(freqs, offset=zmin, scale_bits=scale_bits)


def build_cdf_tables_from_histogram(
    values: np.ndarray,
    offset: Optional[int] = None,
    nsym: Optional[int] = None,
    scale_bits: int = 14,
) -> RansCodec:
    """Empirical per-channel tables of integer ``values`` (..., C) (the DSC
    code's): each channel's histogram over [offset, offset + nsym), plus 0.5
    a symbol, quantized to 1 << scale_bits."""
    v = np.asarray(values)
    c = v.shape[-1]
    v = v.reshape(-1, c).astype(np.int64)
    if offset is None:
        offset = int(v.min())
    if nsym is None:
        nsym = int(v.max()) - offset + 1
    if nsym > 1 << scale_bits:
        raise ValueError(f"{nsym} symbols do not fit {scale_bits}-bit tables")
    freqs = np.empty((c, nsym), np.uint32)
    for j in range(c):
        hist = np.bincount(v[:, j] - offset, minlength=nsym).astype(np.float64)
        freqs[j] = _quantize_pmf(hist + 0.5, scale_bits)
    return RansCodec(freqs, offset=offset, scale_bits=scale_bits)


def _channel_ids(shape: Tuple[int, ...]) -> np.ndarray:
    """Table id per element of an NHWC tensor: the channel index."""
    c = shape[-1]
    n = int(np.prod(shape[:-1]))
    return np.tile(np.arange(c, dtype=np.int32), n)


def encode_latent(codec: RansCodec, latent: np.ndarray) -> bytes:
    """Encode an NHWC integer latent, row-major, one table per channel."""
    lat = np.asarray(latent)
    return codec.encode(lat.astype(np.int64), _channel_ids(lat.shape))


def decode_latent(codec: RansCodec, stream: bytes, shape: Tuple[int, ...]) -> np.ndarray:
    out = codec.decode(stream, _channel_ids(tuple(shape)))
    return out.reshape(shape)


def gzip_bpp(code: np.ndarray, n_pixels: int) -> float:
    """The reference's rate proxy: gzip of the code + 128 as uint8 bytes, in
    bits per pixel (``len`` of the compressed bytes, as the JAX package
    counts them)."""
    u8 = np.clip(np.asarray(code + 128.0, np.float32), 0, 255).astype(np.uint8)
    return len(gzip.compress(u8.tobytes())) * 8.0 / float(n_pixels)
