"""The Python side of the port's bf16 K2 kernel, on the CPU (the kernel
itself runs only on the card): its tile ``tile_bf16`` and its K-major
weight ``k_major_hwio`` / ``k_major_weight``.

- At every bf16 shape of ``chip_smoke.py``'s ``precision`` phase (the K2
  bf16 rows of PERF.md's kernel table) the tile is one the kernel is built
  for: 128 pixels where that grid reaches half the card's SMs and the conv
  is wide (Cout > 128) or deep (K >= 2048), else 64. The kernel
  never splits K, so no stage (Ballé conv3 at batch 8 included) writes
  partials.
- ``k_major_hwio`` holds the HWIO weight's columns as rows 16 bytes apart
  (the Cin = 3 stages' K padded in the stride, not in a copy), which
  ``k_major_weight`` reads without a copy; the conv on them, put back,
  gives the plain version's bits and stays within one bf16 ulp of the JAX
  package's Pallas kernel in bf16 (interpret mode).
- The fp32 planner ``plan_splits`` is not changed (its pins are also in
  ``test_torch_tf32.py``).
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iclr_17_compression_tpu.ops.pallas import conv_gdn_kernel as jk2
from iclr_17_compression_tpu_torch.ops.gdn import GDNParams, gdn_reparam
from iclr_17_compression_tpu_torch.ops.kernels import conv_gdn_kernel as tk2
from test_torch_precision import K2_DIFF_SHARE, _bf16_np, bf16_within_one_ulp

jgdn = importlib.import_module("iclr_17_compression_tpu.ops.gdn")

BF = torch.bfloat16
SMS = 132  # an H100's SMs

# (x shape NHWC, k, stride, Cout, the tile) of the precision phase's K2 bf16
# calls: 128 pixels where ceil(P / 128) reaches half the SMs and Cout > 128
# or K >= 2048, each the faster tile on an H100 where both were timed
BF16_SHAPES = {
    "balle_conv1_blocked": ((8, 128, 192, 48), 3, 1, 128, 64),  # K = 432
    "balle_conv2": ((8, 128, 192, 128), 5, 2, 128, 128),  # K = 3200
    "balle_conv3": ((8, 64, 96, 128), 5, 2, 128, 128),  # 96 tiles of 128
    "balle_conv1_unblocked": ((8, 512, 768, 3), 9, 4, 128, 64),  # K = 243
    "dsc_rbs_conv2": ((4, 160, 608, 128), 3, 1, 128, 64),  # K = 1152
    "dsc_rbu_conv": ((4, 160, 608, 128), 3, 1, 128, 64),
    "joint_g_a2": ((1, 128, 192, 192), 3, 1, 192, 128),
    "joint_g_s3": ((1, 128, 192, 192), 3, 1, 192, 128),
    "hyperprior_conv1": ((1, 512, 768, 3), 5, 2, 192, 128),
    "hyperprior_conv2": ((1, 256, 384, 192), 5, 2, 192, 128),
    "hyperprior_conv3": ((1, 128, 192, 192), 5, 2, 192, 64),  # 12 tiles of 128
    # the phase's checks off the main paths
    "off_cout192_256x288": ((1, 256, 288, 128), 5, 2, 192, 128),
    "off_cout192_128x192": ((1, 128, 192, 128), 5, 2, 192, 64),  # 48 tiles of 128
    "off_cout256_64x96": ((1, 64, 96, 128), 3, 1, 256, 64),  # 128 is built up to Cout 192
    # a deep conv to 64 channels on a full grid: 128 is not built below Cout 96
    "off_cout64_deep": ((1, 256, 288, 128), 5, 2, 64, 64),
}


def k_major_to_hwio(rows, ldw, k, cin):
    """``k_major_weight``'s inverse: the memory of Cout rows ``ldw`` apart
    back to a contiguous HWIO weight."""
    cout = rows.shape[0]
    flat = torch.as_strided(rows, (cout, k * k * cin), (ldw, 1))
    return flat.t().reshape(k, k, cin, cout).contiguous()


def out_hw(xs, k, s):
    p = k // 2
    return (xs[1] + 2 * p - k) // s + 1, (xs[2] + 2 * p - k) // s + 1


@pytest.mark.parametrize("name", sorted(BF16_SHAPES))
def test_bf16_tile_at_precision_shapes(name):
    xs, k, s, cout, want = BF16_SHAPES[name]
    ho, wo = out_hw(xs, k, s)
    pixels = xs[0] * ho * wo
    bm = tk2.tile_bf16(pixels, k * k * xs[3], cout, SMS)
    assert bm == want and bm in tk2.BF16_TILES
    # a 128-pixel tile (one block an SM) only where its grid reaches half
    # the SMs, and never past the Cout it is built for
    assert bm == 64 or (2 * -(-pixels // 128) >= SMS and 64 < cout <= 192)


# the fp32 planner's answers, unchanged (its cost: waves of blocks times
# taps a split)
FP32_PINS = [((192 * 128, 81, 264), 1), ((96 * 64, 25, 264), 5), ((48 * 32, 25, 264), 11),
             ((64 * 264, 25, 264), 1), ((128 * 144, 25, 132), 1), ((64 * 96, 25, 132), 25),
             ((8 * 32 * 48, 25, 264), 25), ((4 * 32 * 32, 81, 264), 41)]


@pytest.mark.parametrize("args,splits", FP32_PINS)
def test_fp32_plan_splits_unchanged(args, splits):
    assert tk2.plan_splits(*args) == splits


@pytest.mark.parametrize("k,cin,cout", [(9, 3, 128), (5, 3, 192), (3, 48, 128), (5, 128, 64)])
def test_k_major_weight_layout(k, cin, cout):
    rng = np.random.default_rng(k * cin + cout)
    w = torch.from_numpy(rng.standard_normal((k, k, cin, cout)).astype(np.float32)).to(BF)
    rows, ldw = tk2.k_major_weight(w)  # a copy: w is HWIO-contiguous
    kk = k * k * cin
    assert rows.dtype == BF and rows.shape == (cout, k, k, cin)
    assert ldw == -(-kk // 8) * 8 and rows.stride() == (ldw, k * cin, cin, 1)
    assert rows.data_ptr() % 16 == 0
    for dy, dx, ci, c in [(0, 0, 0, 0), (k - 1, 0, cin - 1, cout - 1), (k // 2, k - 1, 1, 7)]:
        assert rows[c, dy, dx, ci] == w[dy, dx, ci, c]
    assert torch.equal(k_major_to_hwio(rows, ldw, k, cin), w)


@pytest.mark.parametrize("k,cin,cout", [(9, 3, 128), (5, 3, 192), (3, 48, 128), (5, 128, 64)])
def test_k_major_hwio_is_read_without_a_copy(k, cin, cout):
    # what conv_gdn_module hands the kernel: one copy into K-major rows (K
    # padded to 8 by the row stride, no F.pad), which the wrapper reads in place
    rng = np.random.default_rng(k + cin * cout)
    w = torch.from_numpy(rng.standard_normal((k, k, cin, cout)).astype(np.float32)).to(BF)
    hw = tk2.k_major_hwio(w)
    assert hw.shape == w.shape and torch.equal(hw, w)
    rows, ldw = tk2.k_major_weight(hw)
    assert rows.data_ptr() == hw.data_ptr()
    assert ldw % 8 == 0 and k * k * cin <= ldw < k * k * cin + 8
    assert torch.equal(k_major_to_hwio(rows, ldw, k, cin), w)


# (x shape, k, stride, Cout, inverse): a Cin = 3 stage (K padded in the row stride), a
# blocked one, a DSC 3×3 site
ROUND_TRIP = {
    "conv1_9x9_s4_cin3": ((1, 32, 48, 3), 9, 4, 128, False),
    "conv1_blocked_3x3_s1": ((1, 16, 24, 48), 3, 1, 128, False),
    "dsc_3x3_s1_igdn": ((1, 8, 16, 64), 3, 1, 64, True),
}


@pytest.mark.parametrize("name", sorted(ROUND_TRIP))
def test_k_major_weight_put_back_matches_plain_and_pallas(name):
    xs, k, s, cout, inverse = ROUND_TRIP[name]
    rng = np.random.default_rng(sorted(ROUND_TRIP).index(name))
    x = _bf16_np(rng.uniform(0, 1, xs) if xs[-1] in (3, 48) else rng.standard_normal(xs) * 0.5)
    w = _bf16_np(rng.standard_normal((k, k, xs[-1], cout)) / np.sqrt(k * k * xs[-1]))
    b = _bf16_np(rng.standard_normal(cout) * 0.01)
    beta = (np.abs(rng.standard_normal(cout)) * 0.5 + 0.5).astype(np.float32)
    gamma = (np.abs(rng.standard_normal((cout, cout))) * 0.03).astype(np.float32)
    tb, tg = gdn_reparam(GDNParams(torch.from_numpy(beta), torch.from_numpy(gamma)))
    tw = torch.from_numpy(w).to(BF)
    back = k_major_to_hwio(*tk2.k_major_weight(tk2.k_major_hwio(tw)), k, xs[-1])
    args = (torch.from_numpy(x).to(BF), None, torch.from_numpy(b), tg.t().contiguous(), tb,
            s, k // 2, inverse)
    got = tk2.conv_gdn_plain(args[0], back, *args[2:])
    assert torch.equal(got, tk2.conv_gdn_plain(args[0], tw, *args[2:]))
    jp = jgdn.GDNParams(jnp.asarray(beta), jnp.asarray(gamma))
    ref = np.asarray(jk2.conv_gdn(jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16),
                                  jnp.asarray(b, jnp.bfloat16), jp, s, k // 2, inverse, True),
                     np.float32)
    ok, share = bf16_within_one_ulp(got.float().numpy(), ref)
    assert ok and share <= K2_DIFF_SHARE, share
