"""Port parity: the precision policy, ``cast_storage`` and bf16 storage.

- ``cast_storage`` casts the floating-point parameters and buffers of a
  module, or the floating-point leaves of a tree, and leaves integer leaves
  as they are (the JAX function's contract).
- The policy names set cuDNN's and cuBLAS's fp32 flags and restore them;
  the default, ``highest``, leaves them where the port kept them before the
  policy (TF32 off in both).
- The bf16 plain versions of the three kernels against the Pallas kernels in
  interpret mode on the same bf16 inputs: K3 bit-equal; K1 and K2 within one
  bf16 ulp of each element (the ulp of the larger of the two values), or
  within the fp32 K2 checks' atol 1e-5 where an output sits near zero after
  the conv's sums cancel. Both sides sum in fp32 in another order, so a
  value that lands near a bf16 rounding boundary rounds the other way: the
  share of elements that differ at all is held under 0.5% (measured on a
  CPU: 0 for K1 at these inputs, at most 0.025% for K2).
- The Ballé-17 model (N = 8, both I/O layouts) and the DSC flagship
  (``temp_0031bpp``, n = 128, the archived weights, 128×256) under
  ``cast_storage(bf16)`` with bf16 images, against the JAX models under the
  JAX ``cast_storage(bf16)``. Each side meets the JAX bf16 test's criteria
  against its own fp32 output (``tests/test_precision.py``: recon MSE
  against fp32 under 5% of the fp32 recon's distortion, max |diff| under
  0.1, bpp within 5%). Port against JAX, both in bf16: the JAX model's
  default GDN rounds the conv output and the norm to bf16 before dividing,
  the port's K1 / K2 keep the norm in fp32 (the Pallas kernels' points), so
  latents and codes may differ where a value sits within bf16 rounding of a
  k + ½ boundary: at most 1% of the Ballé latent and of the DSC code
  (measured: none of the Ballé latent, 0.4% of the DSC code, one element of
  256), and the recons agree to 50 dB PSNR (Ballé; measured 61.3 dB) and
  40 dB (DSC; measured 46.6 dB).
"""

import importlib
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iclr_17_compression_tpu.models import Balle17Compressor as JBalle17
from iclr_17_compression_tpu.models import DSCStereoModel as JaxDSC
from iclr_17_compression_tpu.ops import conv as jconv
from iclr_17_compression_tpu.ops.pallas import conv_gdn_kernel as jk2
from iclr_17_compression_tpu.ops.pallas.gdn_kernel import _gdn_pallas_raw
from iclr_17_compression_tpu.ops.pallas.quant_pack_kernel import quantize_pack_pallas
from iclr_17_compression_tpu.ops.precision import cast_storage as jcast_storage
from iclr_17_compression_tpu_torch.models.balle17 import Balle17Compressor
from iclr_17_compression_tpu_torch.ops import precision
from iclr_17_compression_tpu_torch.ops.gdn import GDNParams, gdn_reparam
from iclr_17_compression_tpu_torch.ops.kernels import conv_gdn_kernel as tk2
from iclr_17_compression_tpu_torch.ops.kernels import gdn_kernel as tk1
from iclr_17_compression_tpu_torch.ops.kernels import quant_pack_kernel as tk3
from iclr_17_compression_tpu_torch.ops.precision import cast_storage
from iclr_17_compression_tpu_torch.train.weights import (dsc_params_to_jax, load_dsc,
                                                         params_from_jax)
from test_torch_dsc_model import _image

jgdn = importlib.import_module("iclr_17_compression_tpu.ops.gdn")

ROOT = os.path.join(os.path.dirname(__file__), "..")
FLAGSHIP = os.path.join(ROOT, "results", "ckpts", "dsc_flagship_params.msgpack")
BF = torch.bfloat16
NEAR_ZERO_ATOL = 1e-5
K1_DIFF_SHARE = K2_DIFF_SHARE = 0.005
BALLE_FLIP_SHARE = DSC_FLIP_SHARE = 0.01
BALLE_PSNR_DB, DSC_PSNR_DB = 50.0, 40.0


def bf16_within_one_ulp(out: np.ndarray, ref: np.ndarray) -> tuple:
    """(all elements within one bf16 ulp or NEAR_ZERO_ATOL, share that differ)
    for two fp32 arrays that hold bf16 values."""
    big = np.maximum(np.abs(out), np.abs(ref))
    ulp = np.exp2(np.floor(np.log2(np.maximum(big, np.finfo(np.float32).tiny))) - 7)
    diff = np.abs(out - ref)
    return bool(np.all((diff <= ulp) | (diff <= NEAR_ZERO_ATOL))), float(np.mean(diff > 0))


def _bf16_np(a: np.ndarray) -> np.ndarray:
    """``a`` rounded to bf16, as fp32."""
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(BF).float().numpy()


def test_cast_storage_module_and_tree():
    mod = torch.nn.Sequential(torch.nn.Conv2d(3, 4, 3), torch.nn.BatchNorm2d(4))
    assert cast_storage(mod, BF) is mod
    assert mod[0].weight.dtype == BF and mod[1].running_mean.dtype == BF
    assert mod[1].num_batches_tracked.dtype == torch.int64
    tree = {"a": torch.ones(3), "s": torch.arange(3, dtype=torch.int32),
            "l": [torch.zeros(2, dtype=torch.float64), 7, (torch.ones(1), "x")],
            "p": GDNParams(torch.ones(2), torch.ones(2, 2))}
    out = cast_storage(tree, BF)
    assert out["a"].dtype == BF and out["l"][0].dtype == BF and out["l"][2][0].dtype == BF
    assert out["s"].dtype == torch.int32 and out["l"][1] == 7 and out["l"][2][1] == "x"
    assert isinstance(out["p"], GDNParams) and out["p"].gamma.dtype == BF
    assert tree["a"].dtype == torch.float32  # a tree is copied, not cast in place


def test_precision_policy_sets_and_restores_flags():
    saved = precision.current_flags()
    assert precision.get_precision() == "highest"
    precision.apply_precision()
    assert precision.current_flags() == (False, "highest")
    assert not torch.backends.cuda.matmul.allow_tf32  # what no_tf32 left before the policy
    for name, flags in (("high", (True, "high")), ("tensorfloat32", (True, "high")),
                        ("default", (True, "medium")), ("bfloat16", (True, "medium")),
                        ("float32", (False, "highest"))):
        with precision.precision_scope(name):
            assert precision.current_flags() == flags, name
            assert precision.get_precision() == precision.get_precision(name)
        assert precision.current_flags() == (False, "highest")
        assert precision.get_precision() == "highest"
    with pytest.raises(KeyError):
        precision.set_default_precision("fastest")
    torch.backends.cudnn.allow_tf32 = saved[0]
    torch.set_float32_matmul_precision(saved[1])


@pytest.mark.parametrize("env,name", [("bfloat16", "default"), ("high", "high"),
                                      ("nonsense", "highest")])
def test_precision_env_is_read_as_in_jax(env, name):
    code = ("from iclr_17_compression_tpu_torch.ops import precision as p; "
            "print(p.get_precision())")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env={**os.environ, "ICLR17C_PRECISION": env}, cwd=ROOT, check=True)
    assert out.stdout.strip() == name


@pytest.mark.parametrize("c,inverse", [(128, False), (128, True), (64, True)])
def test_k1_bf16_plain_matches_pallas(c, inverse):
    rng = np.random.default_rng(c + inverse)
    x = _bf16_np(rng.standard_normal((2 * 8 * 16, c)) * 0.8)
    gamma_t = (np.abs(rng.standard_normal((c, c))) * 0.03).astype(np.float32)
    beta = (np.abs(rng.standard_normal(c)) * 0.5 + 0.5).astype(np.float32)
    ref = np.asarray(_gdn_pallas_raw(jnp.asarray(x, jnp.bfloat16),
                                     jnp.asarray(gamma_t).astype(jnp.bfloat16),
                                     jnp.asarray(beta).reshape(1, c), inverse, True),
                     np.float32)
    got = tk1.gdn_fused(torch.from_numpy(x).to(BF), torch.from_numpy(gamma_t),
                        torch.from_numpy(beta), inverse)
    assert got.dtype == BF
    ok, share = bf16_within_one_ulp(got.float().numpy(), ref)
    assert ok and share <= K1_DIFF_SHARE, share


# (x shape, kernel, stride/padding, Cout, gdn, inverse) at small H×W: the
# Ballé-17 stages (conv1 blocked and unblocked), a DSC 3×3 site
K2_SHAPES = {
    "balle_conv1_blocked_3x3_s1": ((1, 16, 24, 48), 3, 1, 128, True, False),
    "balle_conv1_9x9_s4": ((1, 32, 48, 3), 9, 4, 128, True, False),
    "balle_conv2_5x5_s2": ((1, 16, 24, 128), 5, 2, 128, True, False),
    "balle_conv3_5x5_s2": ((2, 8, 16, 128), 5, 2, 128, False, False),
    "dsc_3x3_s1_igdn": ((1, 8, 16, 64), 3, 1, 64, True, True),
}


@pytest.mark.parametrize("shape", sorted(K2_SHAPES))
def test_k2_bf16_plain_matches_pallas(shape):
    xs, k, s, cout, gdn_on, inverse = K2_SHAPES[shape]
    rng = np.random.default_rng(sorted(K2_SHAPES).index(shape))
    x = _bf16_np(rng.uniform(0, 1, xs) if xs[-1] in (3, 48) else rng.standard_normal(xs) * 0.5)
    w = _bf16_np(rng.standard_normal((k, k, xs[-1], cout)) / np.sqrt(k * k * xs[-1]))
    b = _bf16_np(rng.standard_normal(cout) * 0.01) if gdn_on else None
    beta = (np.abs(rng.standard_normal(cout)) * 0.5 + 0.5).astype(np.float32)
    gamma = (np.abs(rng.standard_normal((cout, cout))) * 0.03).astype(np.float32)
    jp = jgdn.GDNParams(jnp.asarray(beta), jnp.asarray(gamma)) if gdn_on else None
    pad = k // 2
    ref = np.asarray(jk2.conv_gdn(
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16),
        None if b is None else jnp.asarray(b, jnp.bfloat16), jp, s, pad, inverse, True),
        np.float32)
    if gdn_on:
        tb, tg = gdn_reparam(GDNParams(torch.from_numpy(beta), torch.from_numpy(gamma)))
        gamma_t, tb = tg.t().contiguous(), tb
    else:
        gamma_t = tb = None
    got = tk2.conv_gdn(torch.from_numpy(x).to(BF), torch.from_numpy(w).to(BF),
                       None if b is None else torch.from_numpy(b), gamma_t, tb, s, pad, inverse)
    assert got.dtype == BF and got.shape == ref.shape
    ok, share = bf16_within_one_ulp(got.float().numpy(), ref)
    assert ok and share <= K2_DIFF_SHARE, share


@pytest.mark.parametrize("step,clip,bits", [(1.0, 127.0, 8), (16.0, 128.0, 8),
                                            (3.0, 96.0, 8), (1.0, 127.0, 16)])
def test_k3_bf16_plain_bit_equal_pallas(step, clip, bits):
    rng = np.random.default_rng(int(step) + bits)
    x = rng.standard_normal((4, 8, 16, 8)) * clip * 0.6
    x.reshape(-1)[:64] = (np.arange(-32, 32) + 0.5) * step  # ties at k + ½ steps
    x = _bf16_np(x)
    sym, deq = tk3.quantize_pack_plain(torch.from_numpy(x).to(BF), step, clip, bits)
    assert sym.dtype == tk3.SYMBOL_DTYPES[bits] and deq.dtype == BF
    rsym, rdeq = quantize_pack_pallas(jnp.asarray(x, jnp.bfloat16), step, clip, tile=64,
                                      interpret=True)
    np.testing.assert_array_equal(sym.numpy().astype(np.int64), np.asarray(rsym, np.int64))
    np.testing.assert_array_equal(deq.float().numpy(), np.asarray(rdeq, np.float32))


def _recon_criteria(r32, rbf, x, b32=None, bbf=None):
    """The JAX bf16 test's criteria (tests/test_precision.py:25-33)."""
    assert np.mean((r32 - rbf) ** 2) < np.mean((r32 - x) ** 2) * 0.05
    assert np.max(np.abs(r32 - rbf)) < 0.1
    if b32 is not None:
        assert abs(b32 - bbf) / max(b32, 1e-9) < 0.05


def _psnr(a, b):
    return 10.0 * np.log10(1.0 / max(float(np.mean((a - b) ** 2)), 1e-20))


@pytest.mark.parametrize("io_block", [1, 4])
def test_balle17_bf16_storage_matches_jax(io_block):
    key = jax.random.PRNGKey(0)
    x = np.array(jax.random.uniform(key, (1, 64, 64, 3), jnp.float32))
    xin = np.ascontiguousarray(jconv.space_to_depth(x, io_block))
    jmodel = JBalle17(out_channel_n=8, io_block=io_block)
    params = jmodel.init({"params": key, "quant": key}, jnp.asarray(xin), train=False)
    fwd = jax.jit(lambda p, x: jmodel.apply(p, x, train=False))
    j32 = fwd(params, jnp.asarray(xin))
    jbf = fwd(jcast_storage(params, jnp.bfloat16), jnp.asarray(xin).astype(jnp.bfloat16))
    model = Balle17Compressor(8, io_block=io_block).eval()
    model.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, params["params"])))
    with torch.no_grad():
        t32 = model(torch.from_numpy(xin))
        tbf = cast_storage(model, BF)(torch.from_numpy(xin).to(BF))
    assert tbf["recon"].dtype == BF and tbf["bpp"].dtype == torch.float32
    jr32, jrbf = np.asarray(j32["recon"], np.float32), np.asarray(jbf["recon"], np.float32)
    tr32, trbf = t32["recon"].numpy(), tbf["recon"].float().numpy()
    _recon_criteria(jr32, jrbf, xin, float(j32["bpp"]), float(jbf["bpp"]))
    _recon_criteria(tr32, trbf, xin, float(t32["bpp"]), float(tbf["bpp"]))
    flips = np.mean(tbf["latent"].float().numpy() != np.asarray(jbf["latent"], np.float32))
    assert flips <= BALLE_FLIP_SHARE, flips
    assert _psnr(trbf, jrbf) >= BALLE_PSNR_DB


def test_dsc_flagship_bf16_storage_matches_jax():
    """The flagship's forward (and in it the serving split: g_a → g_a22 → K3,
    g_s22, fusion, g_s) under bf16 storage, with the archived weights."""
    model = load_dsc(FLAGSHIP, "temp_0031bpp", device="cpu")
    jparams = {"params": jax.tree_util.tree_map(
        jnp.asarray, dsc_params_to_jax(model.state_dict(), model.config))}
    im1 = _image(1, 128, 256)
    im2 = np.clip(np.roll(im1, 6, axis=2) * 1.02, 0, 1).astype(np.float32)
    jmodel = JaxDSC(model.config)
    fwd = jax.jit(lambda p, a, b: jmodel.apply(p, a, b, train=False))
    j32 = fwd(jparams, jnp.asarray(im1), jnp.asarray(im2))
    jbf = fwd(jcast_storage(jparams, jnp.bfloat16), jnp.asarray(im1).astype(jnp.bfloat16),
              jnp.asarray(im2).astype(jnp.bfloat16))
    with torch.no_grad():
        t32 = model(torch.from_numpy(im1), torch.from_numpy(im2))
        tbf = cast_storage(model, BF)(torch.from_numpy(im1).to(BF), torch.from_numpy(im2).to(BF))
    assert tbf["recon"].dtype == BF and tbf["code"].dtype == BF
    jr32, jrbf = np.asarray(j32["recon"], np.float32), np.asarray(jbf["recon"], np.float32)
    tr32, trbf = t32["recon"].numpy(), tbf["recon"].float().numpy()
    _recon_criteria(jr32, jrbf, im1)
    _recon_criteria(tr32, trbf, im1)
    flips = np.mean(tbf["code"].float().numpy() != np.asarray(jbf["code"], np.float32))
    assert flips <= DSC_FLIP_SHARE, flips
    assert _psnr(trbf, jrbf) >= DSC_PSNR_DB


@pytest.mark.parametrize("dtype", [torch.float16, torch.float64])
def test_kernels_refuse_other_element_types(dtype):
    """A tensor off the CPU of a type no kernel variant takes raises; it is
    never converted to fp32 or bf16, nor sent to the plain version."""
    def meta(*shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device="meta")

    with pytest.raises(ValueError, match="float32 or bfloat16"):
        tk1.gdn_fused(meta(1, 4, 4, 32), meta(32, 32), meta(32, dt=torch.float32))
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        tk2.conv_gdn(meta(1, 8, 8, 32), meta(3, 3, 32, 32), None, None, None, 1, 1)
    with torch.no_grad(), pytest.raises(ValueError, match="float32 or bfloat16"):
        tk3.quantize_pack(meta(1, 4, 4, 8), 16.0, 128.0)
