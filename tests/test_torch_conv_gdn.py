"""Port parity: conv+GDN (K2's plain path) and the fused Ballé-17 encoder
against the JAX package's Pallas kernel in interpret mode.

The three encoder stage shapes at small H×W. Tolerance rtol 1e-4, atol 1e-5:
both fp32, the convolution sums in another order.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iclr_17_compression_tpu.models.balle17 import Analysis17 as JAnalysis17
from iclr_17_compression_tpu.ops.pallas import conv_gdn_kernel as jk2
from iclr_17_compression_tpu_torch.models.balle17 import Analysis17
from iclr_17_compression_tpu_torch.ops import conv as tconv
from iclr_17_compression_tpu_torch.ops.gdn import GDNParams, gdn_reparam
from iclr_17_compression_tpu_torch.ops.kernels import conv_gdn_kernel as tk2
from iclr_17_compression_tpu_torch.ops.conv import hwio_to_oihw

jgdn = importlib.import_module("iclr_17_compression_tpu.ops.gdn")

RTOL, ATOL = 1e-4, 1e-5

# (x shape, kernel, stride/padding, Cout, gdn) of the Ballé-17 encoder stages
STAGES = {
    "conv1_9x9_s4_gdn": ((1, 32, 48, 3), 9, 4, 128, True),
    "conv2_5x5_s2_gdn": ((1, 16, 24, 128), 5, 2, 128, True),
    "conv3_5x5_s2": ((2, 8, 16, 128), 5, 2, 128, False),
}


@pytest.mark.parametrize("stage", sorted(STAGES))
def test_conv_gdn_matches_jax_pallas(stage):
    shape, k, s, cout, gdn_on = STAGES[stage]
    rng = np.random.default_rng(sorted(STAGES).index(stage))
    x = rng.standard_normal(shape).astype(np.float32) * 0.5
    w = (rng.standard_normal((k, k, shape[-1], cout)) / np.sqrt(k * k * shape[-1])).astype(np.float32)
    b = rng.standard_normal(cout).astype(np.float32) * 0.01 if gdn_on else None
    beta = np.abs(rng.standard_normal(cout)).astype(np.float32) * 0.5 + 0.5
    gamma = np.abs(rng.standard_normal((cout, cout))).astype(np.float32) * 0.03
    jp = jgdn.GDNParams(jnp.asarray(beta), jnp.asarray(gamma)) if gdn_on else None
    ref = np.asarray(jk2.conv_gdn(
        jnp.asarray(x), jnp.asarray(w), None if b is None else jnp.asarray(b), jp, s, s,
        False, True))
    if gdn_on:
        tb, tg = gdn_reparam(GDNParams(torch.from_numpy(beta), torch.from_numpy(gamma)))
        gamma_t, tb = tg.t().contiguous(), tb
    else:
        gamma_t = tb = None
    before = tk2.conv_gdn.launches
    out = tk2.conv_gdn(torch.from_numpy(x), torch.from_numpy(w),
                       None if b is None else torch.from_numpy(b), gamma_t, tb, s, s).numpy()
    assert tk2.conv_gdn.launches == before  # a CPU tensor takes the plain path
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=RTOL, atol=ATOL)


def test_conv_layouts_match_jax_conv():
    """ops.conv on NHWC with torch layouts equals the JAX torch-semantics
    convs, including the deconv un-flip of the pre-flipped HWIO weight."""
    from iclr_17_compression_tpu.ops.conv import conv2d as jconv, conv_transpose2d as jdeconv

    rng = np.random.default_rng(7)
    x = rng.standard_normal((1, 6, 10, 8)).astype(np.float32)
    w = rng.standard_normal((5, 5, 8, 4)).astype(np.float32) * 0.1
    b = rng.standard_normal(4).astype(np.float32)
    ref = np.asarray(jconv(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), stride=2, padding=2))
    out = tconv.conv2d(torch.from_numpy(x), torch.from_numpy(hwio_to_oihw(w).copy()),
                       torch.from_numpy(b), stride=2, padding=2).numpy()
    np.testing.assert_allclose(out, ref, rtol=RTOL, atol=ATOL)
    for k, s, p, op in ((5, 2, 2, 1), (9, 4, 4, 3)):
        wd = rng.standard_normal((k, k, 8, 4)).astype(np.float32) * 0.1
        ref = np.asarray(jdeconv(jnp.asarray(x), jnp.asarray(wd), jnp.asarray(b), stride=s,
                                 padding=p, output_padding=op))
        out = tconv.conv_transpose2d(
            torch.from_numpy(x), torch.from_numpy(tconv.deconv_hwio_to_torch(wd)),
            torch.from_numpy(b), stride=s, padding=p, output_padding=op).numpy()
        np.testing.assert_allclose(out, ref, rtol=RTOL, atol=ATOL)


def test_analysis17_fused_matches_jax():
    n = 16
    x = np.random.default_rng(8).uniform(0, 1, (1, 32, 48, 3)).astype(np.float32)
    variables = JAnalysis17(n).init(jax.random.PRNGKey(0), jnp.asarray(x))
    enc = jax.tree_util.tree_map(np.array, variables["params"])
    ref = np.asarray(jk2.analysis17_fused(enc, jnp.asarray(x), interpret=True))
    ref_module = np.asarray(JAnalysis17(n).apply(variables, jnp.asarray(x)))

    model = Analysis17(n)
    with torch.no_grad():
        for i in (1, 2, 3):
            conv = getattr(model, f"conv{i}")
            conv.weight.copy_(torch.from_numpy(hwio_to_oihw(enc[f"conv{i}"]["weight"]).copy()))
            if i < 3:
                conv.bias.copy_(torch.from_numpy(enc[f"conv{i}"]["bias"]))
                getattr(model, f"gdn{i}").beta.copy_(torch.from_numpy(enc[f"gdn{i}"]["beta"]))
                getattr(model, f"gdn{i}").gamma.copy_(torch.from_numpy(enc[f"gdn{i}"]["gamma"]))
        xt = torch.from_numpy(x)
        fused = tk2.analysis17_fused(model, xt).numpy()
        module = model(xt).numpy()
    np.testing.assert_allclose(fused, ref, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(module, ref_module, rtol=RTOL, atol=ATOL)
