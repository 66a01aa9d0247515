"""Port parity: the scale-hyperprior and joint-AR codecs on bf16 storage
(``ops.precision.cast_storage``) against the JAX package, on the CPU.

Weights: the seeded models of ``test_torch_hyperprior`` (n = 32, m = 48)
and ``test_torch_joint`` (n = 32, y spread to a std of 2), carried to JAX
by the weight bridges; numpy-seeded images.

- The eval forward of a bf16 image on bf16 weights (JAX's ``bench_joint``
  configuration) runs in bf16 in both packages, rate terms included.
  Stated tolerances against JAX's: ẑ equal; ŷ differs on at most
  LATENT_FLIP_SHARE of its elements, by one; σ (hyperprior: a function of
  ẑ alone) within one bf16 ulp; bpp, bpp_y, bpp_z and mse within
  RATE_ULPS bf16 ulps; the recons at least RECON_PSNR_DB apart.
- bf16 against fp32 in each package: the JAX bf16 test's criteria (recon
  MSE under 5% of the fp32 recon's distortion, max |diff| under 0.1, bpp
  within 5%), the max on the decoder's arithmetic (the test's docstring).
- The file codecs: JAX's ``compress`` refuses bf16-stored weights (its
  convs get fp32 host arrays and bf16 weights, which
  ``lax.conv_general_dilated`` rejects). The port computes their dtype
  promotion, fp32 with the bf16-rounded weights, and its streams are
  byte-equal to JAX's ``compress`` on those weights upcast to fp32; its
  own round trip is exact in ŷ.
"""

import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iclr_17_compression_tpu.models import cheng2020 as jc
from iclr_17_compression_tpu.models import hyperprior as jh
from iclr_17_compression_tpu.ops.precision import cast_storage as jcast_storage
from iclr_17_compression_tpu_torch.models import cheng2020 as tc
from iclr_17_compression_tpu_torch.models import hyperprior as thp
from iclr_17_compression_tpu_torch.ops.precision import cast_storage, promoted
import test_torch_hyperprior as th
import test_torch_joint as tj

BF = torch.bfloat16
LATENT_FLIP_SHARE = 0.03
RATE_ULPS = 2
RECON_PSNR_DB = 25.0
FLIP_MAX_ABS = 0.2

SIGMA_BIAS = 2.5  # bench.py bench_joint_host_codec's realism fix of the joint's σ


def joint_model() -> tc.JointAutoregressive:
    """``test_torch_joint``'s model with σ calibrated to y's spread as
    ``bench_joint_host_codec`` calibrates it: at the seeded init σ sits at
    its floor (0.11) under symbols of ±6, and the rate of such a model is
    all far tail."""
    model = tj.port_model()
    with torch.no_grad():
        model.entropy_parameters[4].bias[: tj.N] += SIGMA_BIAS
    return model


# (port model, JAX model, JAX params) makers by case
CASES = {
    "hyperprior": (lambda: th.port_model("round"), lambda: jh.ScaleHyperprior(th.N, th.M),
                   lambda m: {"params": th.jax_tree(m)}),
    "hyperprior-sigma": (lambda: th.port_model("sigma-norm"),
                         lambda: jh.ScaleHyperprior(th.N, th.M, quant="sigma-norm"),
                         lambda m: {"params": th.jax_tree(m)}),
    "joint": (joint_model, lambda: jc.JointAutoregressive(tj.N), tj.jax_params),
}


def _bf16_ulp(v: np.ndarray) -> np.ndarray:
    return np.exp2(np.floor(np.log2(np.maximum(np.abs(v), np.finfo(np.float32).tiny))) - 7)


def _psnr(a, b):
    return 10.0 * np.log10(1.0 / max(float(np.mean((a - b) ** 2)), 1e-20))


def _f32(x) -> np.ndarray:
    return (x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32))


def _forwards(case):
    make, jmodel, jparams = CASES[case]
    model = make()
    params = jparams(model)
    x = np.stack([th.image(1), th.image(2)])
    j32 = jmodel().apply(params, jnp.asarray(x))
    jbf = jmodel().apply(jcast_storage(params, jnp.bfloat16), jnp.asarray(x).astype(jnp.bfloat16))
    with torch.no_grad():
        t32 = model(torch.from_numpy(x))
        tbf = cast_storage(copy.deepcopy(model), BF)(torch.from_numpy(x).to(BF))
    return x, j32, jbf, t32, tbf


@pytest.mark.parametrize("case", sorted(CASES))
def test_bf16_eval_forward_matches_jax(case):
    x, j32, jbf, t32, tbf = _forwards(case)
    assert set(tbf) == set(jbf)
    assert all(v.dtype == BF for v in tbf.values()), {k: v.dtype for k, v in tbf.items()}
    np.testing.assert_array_equal(_f32(tbf["hyper_latent"]), _f32(jbf["hyper_latent"]))
    lat, jlat = _f32(tbf["latent"]), _f32(jbf["latent"])
    if case == "hyperprior-sigma":  # ŷ = round(y/σ)·σ: compare the symbols
        lat, jlat = np.round(lat / _f32(tbf["sigma"])), np.round(jlat / _f32(jbf["sigma"]))
    flips = lat != jlat
    assert flips.mean() <= LATENT_FLIP_SHARE, flips.mean()
    assert np.abs(lat - jlat).max() <= 1
    if case.startswith("hyperprior"):
        sig, jsig = _f32(tbf["sigma"]), _f32(jbf["sigma"])
        assert np.all(np.abs(sig - jsig) <= _bf16_ulp(jsig))
    for key in ("bpp", "bpp_y", "bpp_z", "mse"):
        a, b = float(tbf[key]), float(jbf[key])
        assert abs(a - b) <= RATE_ULPS * _bf16_ulp(np.float32(b)), (key, a, b)
    assert _psnr(_f32(tbf["recon"]), _f32(jbf["recon"])) >= RECON_PSNR_DB


@pytest.mark.parametrize("case", sorted(CASES))
def test_bf16_against_fp32_criteria(case):
    """bf16 storage is a different rounding, not a different model: the JAX
    bf16 test's criteria, in both packages. The 0.1 bound on the largest
    recon difference is held on the decoder's bf16 arithmetic (the bf16
    decoder on the fp32 latent: at most 0.009 here): where bf16 rounds a
    latent element to the other integer, these seeded decoders move its
    patch by up to 0.13 in the port and 0.12 in JAX, so the whole forward's
    largest difference is held to FLIP_MAX_ABS."""
    x, j32, jbf, t32, tbf = _forwards(case)
    for r32, rbf in ((t32, tbf), (j32, jbf)):
        a, b = _f32(r32["recon"]), _f32(rbf["recon"])
        assert np.mean((a - b) ** 2) < 0.05 * np.mean((a - x) ** 2)
        assert np.abs(a - b).max() < FLIP_MAX_ABS
        b32, bbf = float(r32["bpp"]), float(rbf["bpp"])
        assert abs(b32 - bbf) / max(b32, 1e-9) < 0.05
    model = cast_storage(CASES[case][0](), BF)
    decoder = model.Decoder if case.startswith("hyperprior") else model.g_s
    with torch.no_grad():
        same = torch.clamp(decoder(t32["latent"].to(BF)), 0.0, 1.0)
    assert np.abs(_f32(same) - _f32(t32["recon"])).max() < 0.1


def _upcast(params):
    """JAX params stored in bf16, held in fp32: the weights the port's
    promotion computes with."""
    return jcast_storage(jcast_storage(params, jnp.bfloat16), jnp.float32)


@pytest.mark.parametrize("case", sorted(CASES))
def test_bf16_file_codec_round_trip_and_jax_bytes(case, monkeypatch):
    monkeypatch.setenv("ICLR17C_AR_HOST", "numpy")  # JAX's host AR: the port's numpy backend
    make, jmodel, jparams = CASES[case]
    model = make()
    params = jparams(model)
    mbf = cast_storage(copy.deepcopy(model), BF)
    assert promoted(model) is model and next(promoted(mbf).parameters()).dtype == torch.float32
    img = th.image(3, 64, 128)[None]
    x = torch.from_numpy(img)
    joint = case == "joint"
    kw = {"backend": "numpy"} if joint else {}
    codec = tc if joint else thp
    comp, y_hat = codec.compress(mbf, x, return_y_hat=True, **kw)
    recon, y_dec = codec.decompress(mbf, comp, return_y_hat=True, **kw)
    np.testing.assert_array_equal(y_dec, y_hat)
    assert next(mbf.parameters()).dtype == BF  # the caller's model keeps its storage
    assert recon.dtype == np.float32 and comp.num_bits > 0
    # a bf16 image codes as its fp32 upcast (the promotion)
    assert codec.compress(mbf, x.to(BF).float(), **kw) == codec.compress(mbf, x.to(BF), **kw)

    jm = jmodel()
    with pytest.raises(TypeError, match="same dtypes"):
        (jc if joint else jh).compress(jm, jcast_storage(params, jnp.bfloat16), img)
    up = _upcast(params)
    jcomp = (jc if joint else jh).compress(jm, up, img)
    assert comp.y_stream == jcomp.y_stream and comp.z_stream == jcomp.z_stream
    assert comp.y_shape == tuple(jcomp.y_shape) and comp.max_sym == jcomp.max_sym
    jrec = np.asarray((jc if joint else jh).decompress(jm, up, jcomp))
    np.testing.assert_allclose(recon, jrec, rtol=0, atol=th.ATOL)
