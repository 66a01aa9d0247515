"""Port parity: the scale-indexed rANS tables (``coding/gaussian.py``) and the
streaming decoder (``coding/api.StreamingDecoder``) against the JAX
package's, on the CPU.

Stated tolerance: none. Both packages build the tables with the same numpy
and scipy arithmetic, so every table and every scale index is equal, and
the same symbols against the same tables give the same bytes.
"""

import numpy as np
import pytest

from iclr_17_compression_tpu.coding import api as japi
from iclr_17_compression_tpu.coding import gaussian as jg
from iclr_17_compression_tpu_torch.coding import api as tapi
from iclr_17_compression_tpu_torch.coding import gaussian as tg


def test_scale_table_and_indices_match_jax():
    table = tg.default_scale_table()
    np.testing.assert_array_equal(table, jg.default_scale_table())
    assert table.dtype == np.float64 and table.shape == (tg.SCALES_LEVELS,)
    rng = np.random.default_rng(0)
    sigma = np.concatenate([
        np.exp(rng.uniform(np.log(0.01), np.log(1000.0), 4000)).astype(np.float32),
        table.astype(np.float32), table, [0.0, 0.11, 256.0, 1e9]])
    idx = tg.scale_indices(sigma, table)
    np.testing.assert_array_equal(idx, jg.scale_indices(sigma, table))
    assert idx.dtype == np.int32 and idx.min() == 0 and idx.max() == len(table) - 1


CODECS = {
    "gaussian": (tg.build_gaussian_codec, jg.build_gaussian_codec, None),
    "laplace": (tg.build_laplace_codec, jg.build_laplace_codec, None),
    "unit_laplace": (tg.build_laplace_codec, jg.build_laplace_codec, np.ones((1,))),
}


@pytest.mark.parametrize("max_value", [1, 7, 60])
@pytest.mark.parametrize("kind", sorted(CODECS))
def test_tables_match_jax(kind, max_value):
    port, jax_build, table = CODECS[kind]
    table = tg.default_scale_table() if table is None else table
    ours, ref = port(table, max_value), jax_build(table, max_value)
    np.testing.assert_array_equal(ours.freqs, ref.freqs)
    np.testing.assert_array_equal(ours.cums, ref.cums)
    assert (ours.offset, ours.nsym, ours.ntables) == (ref.offset, ref.nsym, ref.ntables)
    assert np.all(ours.freqs.sum(axis=1) == 1 << 14) and ours.freqs.min() >= 1


def test_default_codecs_match_jax():
    for port, ref in ((tg.default_gaussian_codec(9), jg.default_gaussian_codec(9)),
                      (tg.default_laplace_codec(9), jg.default_laplace_codec(9)),
                      (tg.unit_laplace_codec(9), jg.unit_laplace_codec(9))):
        np.testing.assert_array_equal(port.freqs, ref.freqs)
    assert tg.default_gaussian_codec(9) is tg.default_gaussian_codec(9)  # memoized


def _symbols(seed: int, n: int = 5000, max_value: int = 20):
    rng = np.random.default_rng(seed)
    tids = rng.integers(0, tg.SCALES_LEVELS, n).astype(np.int32)
    sigma = tg.default_scale_table()[tids]
    syms = np.clip(np.round(rng.standard_normal(n) * sigma), -max_value, max_value)
    return syms.astype(np.int64), tids


def test_stream_bytes_match_jax():
    syms, tids = _symbols(1)
    ours = tg.default_gaussian_codec(20).encode(syms, tids)
    assert ours == jg.default_gaussian_codec(20).encode(syms, tids)
    np.testing.assert_array_equal(tg.default_gaussian_codec(20).decode(ours, tids), syms)


@pytest.mark.parametrize("chunks", [[5000], [1] * 40 + [4960], [7, 1, 300, 13, 4679]])
def test_streaming_decoder_matches_one_shot(chunks):
    syms, tids = _symbols(2)
    codec = tg.default_gaussian_codec(20)
    stream = codec.encode(syms, tids)
    one_shot = codec.decode(stream, tids)
    parts, at = [], 0
    with tapi.StreamingDecoder(codec, stream) as dec:
        for n in chunks:
            parts.append(dec.step(tids[at: at + n]))
            at += n
    np.testing.assert_array_equal(np.concatenate(parts), one_shot)
    np.testing.assert_array_equal(one_shot, syms)
    with japi.StreamingDecoder(jg.default_gaussian_codec(20), stream) as jdec:
        np.testing.assert_array_equal(jdec.step(tids), one_shot)


def test_streaming_decoder_refuses_bad_ids_and_closed_use():
    syms, tids = _symbols(3, n=50)
    codec = tg.default_laplace_codec(20)
    dec = tapi.StreamingDecoder(codec, codec.encode(syms, tids))
    with pytest.raises(RuntimeError, match="failed"):
        dec.step(np.array([tg.SCALES_LEVELS], np.int32))
    dec.close()
    with pytest.raises(RuntimeError, match="closed"):
        dec.step(tids[:1])
