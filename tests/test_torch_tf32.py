"""The arithmetic and the split-K plan of the port's K1/K2 CUDA kernels, on the
CPU (the kernels themselves run only on the card).

The kernels compute their products in 3xTF32 on the tensor cores: each fp32
operand is split into hi = tf32(x) and lo = tf32(x - hi), rounded to nearest
with ties away from zero at 10 mantissa bits (as cvt.rna.tf32.f32), a
product is lo*hi + hi*lo + hi*hi, and each 32-deep K chunk is summed in fp32
before it is added to the accumulator. A numpy emulation of that arithmetic
must hold the kernels' tolerance against the JAX reference (rtol 1e-4,
atol 1e-5) at each Ballé-17 encoder stage's K and at the GDN's C x C
product; one TF32 product per term must not, which shows the test tells the
two apart.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest

from iclr_17_compression_tpu.ops.pallas import conv_gdn_kernel as jk2
from iclr_17_compression_tpu_torch.ops.kernels.conv_gdn_kernel import BM, plan_splits

jgdn = importlib.import_module("iclr_17_compression_tpu.ops.gdn")

RTOL, ATOL = 1e-4, 1e-5
CHUNK = 32  # K rows summed in fp32 before each add to the accumulator


def tf32_rna(x: np.ndarray) -> np.ndarray:
    """Round fp32 to tf32 (10 mantissa bits), to nearest, ties away from zero."""
    u = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    return ((u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def matmul_tf32(a: np.ndarray, b: np.ndarray, terms: int) -> np.ndarray:
    """a @ b with terms = 3 (3xTF32) or 1 (one TF32 product), chunk by chunk."""
    ah = tf32_rna(a)
    bh = tf32_rna(b)
    al = tf32_rna(a - ah)
    bl = tf32_rna(b - bh)
    acc = np.zeros((a.shape[0], b.shape[1]), np.float32)
    for k0 in range(0, a.shape[1], CHUNK):
        k = slice(k0, k0 + CHUNK)
        part = ah[:, k] @ bh[k]
        if terms == 3:
            part = al[:, k] @ bh[k] + ah[:, k] @ bl[k] + part
        acc = (acc + part.astype(np.float32)).astype(np.float32)
    return acc


def im2col(x: np.ndarray, k: int, s: int) -> tuple:
    """Torch-semantics patches of NHWC x (padding k // 2 each side), K in
    HWIO order (dy, dx, ci) to match the HWIO weight as a (K, Cout) matrix."""
    n, h, w, c = x.shape
    p = k // 2
    xp = np.pad(x, ((0, 0), (p, p), (p, p), (0, 0)))
    ho, wo = (h + 2 * p - k) // s + 1, (w + 2 * p - k) // s + 1
    cols = np.empty((n, ho, wo, k, k, c), np.float32)
    for dy in range(k):
        for dx in range(k):
            cols[:, :, :, dy, dx] = xp[:, dy:dy + s * ho:s, dx:dx + s * wo:s]
    return cols.reshape(n * ho * wo, k * k * c), (n, ho, wo)


def gdn_tf32(y: np.ndarray, gamma: np.ndarray, beta: np.ndarray, terms: int) -> np.ndarray:
    """The kernels' GDN epilogue on (P, C) rows, from the effective params."""
    norm = matmul_tf32(y * y, np.ascontiguousarray(gamma.T), terms) + beta
    return y / np.sqrt(norm)


def effective(beta, gamma):
    jb, jg = jgdn.gdn_reparam(jgdn.GDNParams(jnp.asarray(beta), jnp.asarray(gamma)))
    return np.asarray(jb), np.asarray(jg)


def within(out, ref):
    return bool(np.all(np.abs(out - ref) <= ATOL + RTOL * np.abs(ref)))


# (x shape, kernel, stride, Cout, gdn): the Ballé-17 encoder stages at small
# H x W, at their real K = k*k*Cin (243, 3200, 3200)
STAGES = {
    "conv1_9x9_s4_gdn": ((1, 32, 48, 3), 9, 4, 128, True),
    "conv2_5x5_s2_gdn": ((1, 16, 24, 128), 5, 2, 128, True),
    "conv3_5x5_s2": ((2, 8, 16, 128), 5, 2, 128, False),
}


def _stage(stage):
    shape, k, s, cout, gdn_on = STAGES[stage]
    rng = np.random.default_rng(20 + sorted(STAGES).index(stage))
    x = rng.standard_normal(shape).astype(np.float32) * 0.5
    w = (rng.standard_normal((k, k, shape[-1], cout)) / np.sqrt(k * k * shape[-1])).astype(np.float32)
    b = rng.standard_normal(cout).astype(np.float32) * 0.01 if gdn_on else None
    beta = np.abs(rng.standard_normal(cout)).astype(np.float32) * 0.5 + 0.5
    gamma = np.abs(rng.standard_normal((cout, cout))).astype(np.float32) * 0.03
    jp = jgdn.GDNParams(jnp.asarray(beta), jnp.asarray(gamma)) if gdn_on else None
    ref = np.asarray(jk2.conv_gdn(
        jnp.asarray(x), jnp.asarray(w), None if b is None else jnp.asarray(b), jp, s, s,
        False, True))
    return x, w, b, (effective(beta, gamma) if gdn_on else None), k, s, ref


def _conv_tf32(x, w, b, params, k, s, terms):
    cols, (n, ho, wo) = im2col(x, k, s)
    y = matmul_tf32(cols, w.reshape(-1, w.shape[-1]), terms)
    if b is not None:
        y = y + b
    if params is not None:
        y = gdn_tf32(y, params[1], params[0], terms)
    return y.reshape(n, ho, wo, -1)


@pytest.mark.parametrize("stage", sorted(STAGES))
def test_3xtf32_conv_gdn_matches_jax(stage):
    x, w, b, params, k, s, ref = _stage(stage)
    out = _conv_tf32(x, w, b, params, k, s, terms=3)
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("stage", sorted(STAGES))
def test_1xtf32_conv_gdn_misses_the_tolerance(stage):
    x, w, b, params, k, s, ref = _stage(stage)
    out = _conv_tf32(x, w, b, params, k, s, terms=1)
    assert not within(out, ref)


@pytest.mark.parametrize("inverse", [False, True])
def test_3xtf32_gdn_product_matches_jax(inverse):
    """K1's C x C norm at the main path's C = 128 against gdn_xla; one TF32
    product misses the tolerance there too."""
    rng = np.random.default_rng(30 + inverse)
    c = 128
    x = rng.standard_normal((2, 8, 12, c)).astype(np.float32)
    beta = np.abs(rng.standard_normal(c)).astype(np.float32) * 0.5 + 0.3
    gamma = np.abs(rng.standard_normal((c, c))).astype(np.float32) * 0.05
    ref = np.asarray(jgdn.gdn_xla(jnp.asarray(x), jgdn.GDNParams(jnp.asarray(beta),
                                                                jnp.asarray(gamma)),
                                  inverse=inverse))
    eb, eg = effective(beta, gamma)
    rows = x.reshape(-1, c)

    def run(terms):
        norm = np.sqrt(matmul_tf32(rows * rows, np.ascontiguousarray(eg.T), terms) + eb)
        return (rows * norm if inverse else rows / norm).reshape(x.shape)

    np.testing.assert_allclose(run(3), ref, rtol=RTOL, atol=ATOL)
    assert not within(run(1), ref)


def test_tf32_rounding_is_to_nearest_ties_away():
    one = np.float32(1.0)
    ulp = np.float32(2.0 ** -10)  # tf32 spacing at 1
    x = np.array([1 + ulp / 2, -(1 + ulp / 2), 1 + ulp / 2 - 2 ** -20, 1 + 1.5 * ulp],
                 np.float32)
    np.testing.assert_array_equal(tf32_rna(x), np.array([1 + ulp, -(1 + ulp), one, 1 + 2 * ulp],
                                                        np.float32))
    # hi + lo carries 22 significant bits: within 2^-22 relative of x
    v = np.random.default_rng(0).standard_normal(10000).astype(np.float32)
    hi = tf32_rna(v)
    lo = tf32_rna(v - hi)
    assert np.all(np.abs((hi.astype(np.float64) + lo) - v) <= 2.0 ** -22 * np.abs(v))


# ---- the split-K planner

# blocks an H100 (132 SMs) runs at once: two an SM at Cout = 128, one at 192
SLOTS_C128, SLOTS_C192 = 2 * 132, 132


def split_taps(taps: int, splits: int) -> list:
    """The [t0, t1) tap ranges of ``splits`` parts of ``taps`` taps, as
    csrc/conv_gdn.cu computes them from blockIdx.y (kbeg / kend)."""
    return [(s * taps // splits, (s + 1) * taps // splits) for s in range(splits)]


@pytest.mark.parametrize("taps,splits", [(25, 1), (25, 5), (25, 11), (25, 25), (81, 2), (9, 4)])
def test_split_taps_cover_each_tap_once(taps, splits):
    ranges = split_taps(taps, splits)
    assert len(ranges) == splits
    assert ranges[0][0] == 0 and ranges[-1][1] == taps
    for (a0, a1), (b0, b1) in zip(ranges, ranges[1:]):
        assert a1 == b0
    assert all(t1 > t0 for t0, t1 in ranges)
    covered = [t for t0, t1 in ranges for t in range(t0, t1)]
    assert covered == list(range(taps))


# the encoder's stages on one 768 x 512 image: output pixels and taps
MAIN_PATH = {"conv1": (192 * 128, 81), "conv2": (96 * 64, 25), "conv3": (48 * 32, 25)}


@pytest.mark.parametrize("stage", sorted(MAIN_PATH))
def test_plan_fills_the_card_on_the_main_path(stage):
    pixels, taps = MAIN_PATH[stage]
    splits = plan_splits(pixels, taps, SLOTS_C128)
    tiles = -(-pixels // BM)
    assert 1 <= splits <= taps
    assert tiles * splits >= SLOTS_C128
    # splits fall on tap boundaries and cover K (k*k*Cin) exactly once
    cin = 3 if stage == "conv1" else 128
    ks = [(t0 * cin, t1 * cin) for t0, t1 in split_taps(taps, splits)]
    assert ks[0][0] == 0 and ks[-1][1] == taps * cin
    assert all(a[1] == b[0] for a, b in zip(ks, ks[1:]))


def test_plan_needs_no_split_when_the_tiles_fill_the_card():
    assert plan_splits(64 * 264, 25, SLOTS_C128) == 1
    assert plan_splits(192 * 128, 81, SLOTS_C128) == 1
    # Cout = 192, one block an SM: chip_smoke.py's two off-path checks
    assert plan_splits(128 * 144, 25, SLOTS_C192) == 1
    assert plan_splits(64 * 96, 25, SLOTS_C192) > 1
