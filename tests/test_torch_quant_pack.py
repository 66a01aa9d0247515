"""Port parity: quantize-pack (K3's plain path) and the eval quantizers
against the JAX package, bit-exact, including exact ±0.5 ties (round half
to even) and values beyond the clip."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iclr_17_compression_tpu.ops.pallas.quant_pack_kernel import (
    quantize_pack_pallas,
    quantize_pack_xla,
)
from iclr_17_compression_tpu_torch.ops import quant as tquant
from iclr_17_compression_tpu_torch.ops.kernels import quant_pack_kernel as tk3

jquant = importlib.import_module("iclr_17_compression_tpu.ops.quant")


def _latent(step, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, 8, 12, 128)).astype(np.float32) * 40 * step
    flat = x.reshape(-1)
    ties = (np.arange(-140, 140, dtype=np.float32) + 0.5) * step
    flat[: ties.size] = ties
    flat[ties.size: ties.size + 4] = np.array([1e6, -1e6, 0.0, -0.0], np.float32)
    return x


@pytest.mark.parametrize("step,clip", [(1.0, 127.0), (16.0, 128.0)])
def test_quantize_pack_bit_exact_vs_jax(step, clip):
    x = _latent(step, int(step))
    sp, dp = quantize_pack_pallas(jnp.asarray(x), step, clip, tile=64, interpret=True)
    sx, dx = quantize_pack_xla(jnp.asarray(x), step, clip)
    before = tk3.quantize_pack.launches
    st, dt = tk3.quantize_pack(torch.from_numpy(x), step, clip)
    assert tk3.quantize_pack.launches == before  # a CPU tensor takes the plain path
    assert st.dtype == torch.uint8 and dt.dtype == torch.float32
    for s, d in ((sp, dp), (sx, dx)):
        np.testing.assert_array_equal(st.numpy(), np.asarray(s))
        np.testing.assert_array_equal(dt.numpy(), np.asarray(d))
    # ties round half to even: 0.5 → 0, 1.5 → 2, -2.5 → -2
    lim = tk3.lim_of(step, clip)
    got = st.numpy().reshape(-1)[:6].astype(int) - lim
    want = np.clip(np.round(np.arange(-140, -134) + 0.5), -lim, lim)
    np.testing.assert_array_equal(got, want)


def test_lim_of_rejects_more_than_256_symbols():
    with pytest.raises(ValueError):
        tk3.lim_of(1.0, 200.0)
    assert tk3.lim_of(16.0, 128.0) == 8


def test_eval_quantizers_match_jax():
    x = _latent(16.0, 3)
    np.testing.assert_array_equal(
        tquant.quantize_coarse(torch.from_numpy(x)).numpy(),
        np.asarray(jquant.quantize_coarse(jnp.asarray(x))))
    np.testing.assert_array_equal(tquant.round(torch.from_numpy(x / 16)).numpy(),
                                  np.asarray(jnp.round(jnp.asarray(x / 16))))
