"""Port parity: the DSC stacks, model and decoder against the JAX package's
``models/dsc.py``, on the CPU in fp32.

The port's seeded init (GDN parameters moved off the identity, and the
last 3×3 conv of ``g_a22`` scaled so that the code spans many symbols and
the clip) is carried to the JAX tree by ``dsc_params_to_jax``; both run the
same numpy-seeded images. Stated tolerances:

- stacks of ``temp_0031bpp`` at n = 128 on a 64×64 image: atol 1e-4 (fp32
  sums in another order through up to 30 convolutions);
- whole model: ``code_pre / step`` (the quantity rounded) within atol 1e-4
  + rtol 2e-6 (the code is scaled to hundreds of steps, where 2e-6 is a few
  fp32 ulps); the code equal wherever code_pre/step lies farther than 1e-4
  from a k + ½ rounding boundary (elements nearer are reported, not
  avoided); the decoders fed JAX's own code, and every other output and
  loss of the full models, atol 1e-4 + rtol 1e-5 (a code that reaches the
  clamp drives the fused latent to tens, where fp32 through the fusion
  stack keeps about 5 digits).

The weight bridge's own tests are in ``test_torch_dsc_weights.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iclr_17_compression_tpu.models import DSC_PRESETS as JAX_PRESETS
from iclr_17_compression_tpu.models import DSCDecoder as JaxDecoder
from iclr_17_compression_tpu.models import DSCStereoModel as JaxModel
from iclr_17_compression_tpu.models.dsc import _Stack
from iclr_17_compression_tpu_torch.models.dsc import (DSC_PRESETS, DSCDecoder,
                                                      DSCStereoModel)
from iclr_17_compression_tpu_torch.nn.layers import GDN
from iclr_17_compression_tpu_torch.train.weights import dsc_params_to_jax

ATOL = 1e-4
CODE_RTOL = 2e-6
RTOL = 1e-5


def _image(seed, h=64, w=64):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.full((h, w, 3), 0.5, np.float32)
    for _ in range(4):
        f = rng.uniform(-3, 3, 2) / np.array([h, w])
        img += rng.uniform(0.05, 0.15, 3).astype(np.float32) * np.cos(
            2 * np.pi * (f[0] * yy + f[1] * xx) + rng.uniform(0, 6))[..., None]
    img += 0.05 * rng.standard_normal((h, w, 3)).astype(np.float32)
    return np.clip(img, 0, 1)[None]


def port_model(preset: str, seed: int = 0, spread: float = 0.0) -> DSCStereoModel:
    """A port model of ``preset`` from the seeded init, GDNs moved off the
    identity; ``spread`` > 0 scales the last 3×3 conv of g_a22 so that the
    code before quantization has about that standard deviation on
    ``_image(1)``."""
    gen = torch.Generator().manual_seed(seed)
    model = DSCStereoModel(DSC_PRESETS[preset]).init_(gen).eval()
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, GDN):
                c = m.beta.shape[0]
                m.beta.copy_(0.7 + 0.6 * torch.rand(c, generator=gen))
                m.gamma.copy_(0.3 * torch.eye(c) + 0.1 * torch.rand((c, c), generator=gen))
        if spread:
            cfg = model.config
            last = model.g_a22[max(i for i, s in enumerate(cfg.ga22) if s[0] == "conv3")]
            std = float(model.encode(torch.from_numpy(_image(1))).std())
            last.weight.mul_(spread / std)
            last.bias.mul_(spread / std)
    return model


def jax_params(model: DSCStereoModel) -> dict:
    return {"params": jax.tree_util.tree_map(
        jnp.asarray, dsc_params_to_jax(model.state_dict(), model.config))}


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


@pytest.fixture(scope="module")
def flagship():
    model = port_model("temp_0031bpp", spread=60.0)
    return model, dsc_params_to_jax(model.state_dict(), model.config)


@pytest.mark.parametrize("stack", ["g_a", "g_s", "g_a22", "g_s22", "g_z1hat_z2"])
def test_flagship_stack_matches_jax(flagship, stack):
    model, tree = flagship
    cfg = model.config
    specs, shape = {"g_a": (cfg.ga, (1, 64, 64, 3)), "g_s": (cfg.gs, (1, 4, 4, 128)),
                    "g_a22": (cfg.ga22, (1, 4, 4, 128)), "g_s22": (cfg.gs22, (1, 2, 2, 8)),
                    "g_z1hat_z2": (cfg.gz, (1, 4, 4, 256))}[stack]
    x = np.random.default_rng(5).standard_normal(shape).astype(np.float32)
    if stack == "g_a":
        x = _image(5)
    with torch.no_grad():
        out = getattr(model, stack)(torch.from_numpy(x)).numpy()
    ref = np.asarray(_Stack(specs).apply({"params": tree[stack]}, jnp.asarray(x)))
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=0, atol=ATOL)


# preset → the code's spread before quantization (in code units: at n = 128
# enough for the clamp at ±128 to act; the n = 16 decoders blow up to 1e7
# there, so a few steps), the receiver's clip, the image side: the flagship
# (msssim loss, step 16, 8-bit symbols), tiny (mse), add_zy_down (cat3
# fusion, step 1: 16-bit symbols), tiny_reg (no base branch, the unclipped
# residual decoder)
MODEL_CASES = {"temp_0031bpp": (200.0, True, 64), "tiny": (12.0, True, 128),
               "add_zy_down": (200.0, True, 64), "tiny_reg": (12.0, False, 128)}


@pytest.mark.parametrize("preset", sorted(MODEL_CASES))
def test_model_and_decoder_match_jax(preset):
    spread, clip, side = MODEL_CASES[preset]
    model = port_model(preset, spread=spread)
    cfg = model.config
    params = jax_params(model)
    im1, im2 = _image(1, side, side), _image(2, side, side)
    jmodel = JaxModel(JAX_PRESETS[preset])
    jout = jmodel.apply(params, jnp.asarray(im1), jnp.asarray(im2), train=False)
    with torch.no_grad():
        code_pre = model.encode(torch.from_numpy(im1)).numpy()
        out = model(torch.from_numpy(im1), torch.from_numpy(im2))
    jcode_pre = np.asarray(_Stack(cfg.ga22).apply({"params": params["params"]["g_a22"]},
                                                  jout["z1"]))
    step = cfg.coarse_step
    np.testing.assert_allclose(code_pre / step, jcode_pre / step, rtol=CODE_RTOL, atol=ATOL)
    frac = np.abs(jcode_pre / step - np.floor(jcode_pre / step) - 0.5)
    near = frac < 1e-4
    jcode = np.array(jout["code"])
    code = out["code"].numpy()
    assert len(np.unique(jcode)) >= 5, "the code uses too few symbols to test"
    assert np.array_equal(code[~near], jcode[~near]), "codes differ off the k + 1/2 boundaries"
    if near.any():
        print(f"{preset}: {int(near.sum())} code elements within 1e-4 of k + 1/2")
    if cfg.n == 128:
        assert np.abs(jcode).max() == cfg.code_clip, "the clamp did not act"

    # the receiver on JAX's own code
    dec = DSCDecoder(cfg, clip=clip, model=model)
    with torch.no_grad():
        recon = dec(torch.from_numpy(jcode), torch.from_numpy(im2)).numpy()
    jrecon = np.asarray(JaxDecoder(JAX_PRESETS[preset], clip=clip).apply(
        params, jnp.asarray(jcode), jnp.asarray(im2)))
    np.testing.assert_allclose(recon, jrecon, rtol=RTOL, atol=ATOL)

    # the full models, where they coded alike
    if not near.any():
        assert set(out) == set(jout)
        for key in out:
            np.testing.assert_allclose(_np(out[key]), np.asarray(jout[key]), rtol=RTOL,
                                       atol=ATOL, err_msg=key)


def test_unported_parts_raise():
    """The fusion presets build with their modules (their parity is in
    ``test_torch_fusion.py``); a fusion option the JAX package has not
    raises."""
    modules = {"fif_0031bpp": {"fif"}, "att_0031bpp": {"final_conv"},
               "bottleneck_att_1bpp": {"bot_mhsa", "final_conv"}, "pam_0031bpp": {"pam"}}
    for preset, names in modules.items():
        model = DSCStereoModel(DSC_PRESETS[preset])
        assert names <= {name for name, _ in model.named_children()}, preset
    for field in ("fusion_pre", "fusion_post"):
        cfg = dataclasses.replace(DSC_PRESETS["temp_0031bpp"], **{field: "nlblock"})
        with pytest.raises(ValueError, match="unknown fusion"):
            DSCStereoModel(cfg)


def test_presets_equal_the_jax_table():
    assert set(DSC_PRESETS) == set(JAX_PRESETS)
    for name, cfg in DSC_PRESETS.items():
        jcfg = JAX_PRESETS[name]
        for field in cfg.__dataclass_fields__:
            assert getattr(cfg, field) == getattr(jcfg, field), (name, field)
