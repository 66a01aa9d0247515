"""Port parity: the scale-hyperprior codec (``models/transforms18.py``,
``models/hyperprior.py``, kind 5 of ``coding/codec_cli.py``, the weight
bridges) and K2 / K1 at this model's configurations, against the JAX
package, on the CPU in fp32.

Weights: the port's seeded init at n = 32, m = 48, every GDN moved off the
identity (a full, non-symmetric γ), carried to JAX by
``hyperprior_params_to_jax``; numpy-seeded 64×64 images. Stated
tolerances: each transform atol 1e-4; K2 and K1 against the Pallas kernels
in interpret mode rtol 1e-4 / atol 1e-5; eval forward recon and σ atol
1e-4, bpp / bpp_y / bpp_z rtol 1e-4; a file round trip exact in its
symbols; a file of one package decodes in the other to ŷ within 1e-5 where
both packages derive the same tables and scale indices (checked first).
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iclr_17_compression_tpu.coding import codec_cli as jcli
from iclr_17_compression_tpu.models import transforms18 as j18
from iclr_17_compression_tpu.models.hyperprior import ScaleHyperprior as JaxHyperprior
from iclr_17_compression_tpu.ops.pallas import conv_gdn_kernel as jk2
from iclr_17_compression_tpu.ops.pallas.gdn_kernel import gdn_pallas
from iclr_17_compression_tpu.train.torch_import import import_hyperprior
from iclr_17_compression_tpu_torch.coding import codec_cli as tcli
from iclr_17_compression_tpu_torch.models import hyperprior as thp
from iclr_17_compression_tpu_torch.models import transforms18 as t18
from iclr_17_compression_tpu_torch.models.hyperprior import ScaleHyperprior
from iclr_17_compression_tpu_torch.ops.gdn import GDNParams, gdn, gdn_reparam
from iclr_17_compression_tpu_torch.ops.kernels import conv_gdn_kernel as tk2
from iclr_17_compression_tpu_torch.ops.kernels import gdn_kernel as tk1
from iclr_17_compression_tpu_torch.train.weights import (_flatten, hyperprior_params_from_jax,
                                                         hyperprior_params_to_jax, load_hyperprior,
                                                         msgpack_dumps)
from test_torch_dsc_blocks import perturb_gdn_

jgdn = importlib.import_module("iclr_17_compression_tpu.ops.gdn")

N, M = 32, 48
ATOL = 1e-4
KRTOL, KATOL = 1e-4, 1e-5
RATE_RTOL = 1e-4


def port_model(quant: str = "round", seed: int = 0) -> ScaleHyperprior:
    gen = torch.Generator().manual_seed(seed)
    model = ScaleHyperprior(N, M, quant=quant).init_(gen)
    perturb_gdn_(model, gen)
    return model.eval()


def image(seed: int, h: int = 64, w: int = 64) -> np.ndarray:
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    a = np.full((h, w, 3), 0.5, np.float32)
    for _ in range(4):
        f = rng.uniform(-3, 3, 2) / np.array([h, w])
        a += rng.uniform(0.05, 0.2, 3).astype(np.float32) * np.cos(
            2 * np.pi * (f[0] * yy + f[1] * xx) + rng.uniform(0, 6))[..., None]
    return np.clip(a + 0.05 * rng.standard_normal((h, w, 3)).astype(np.float32), 0, 1)


def jax_tree(model: ScaleHyperprior):
    return hyperprior_params_to_jax(model.state_dict(), N, M)


# (port module, JAX module, flax name, port attribute, input shape)
STAGES = {
    "Analysis18": (t18.Analysis18, j18.Analysis18, "g_a", "Encoder", (2, 64, 64, 3)),
    "Synthesis18": (t18.Synthesis18, j18.Synthesis18, "g_s", "Decoder", (2, 4, 4, M)),
    "AnalysisPrior": (t18.AnalysisPrior, j18.AnalysisPrior, "h_a", "priorEncoder",
                      (2, 4, 4, M)),
    "SynthesisPrior": (t18.SynthesisPrior, j18.SynthesisPrior, "h_s", "priorDecoder",
                       (2, 1, 1, N)),
}


@pytest.mark.parametrize("stage", sorted(STAGES))
def test_transform_matches_jax(stage):
    _, jmod, name, attr, shape = STAGES[stage]
    model = port_model()
    x = np.random.default_rng(sorted(STAGES).index(stage)).standard_normal(shape)
    x = x.astype(np.float32) * (1.0 if name != "g_a" else 0.3) + (0.5 if name == "g_a" else 0.0)
    with torch.no_grad():
        out = getattr(model, attr)(torch.from_numpy(x)).numpy()
    ref = np.asarray(jmod(N, M).apply({"params": jax_tree(model)[name]}, jnp.asarray(x)))
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=0, atol=ATOL)


def _gdn_params(rng, c):
    """Stored GDN parameters off the identity, γ full and not symmetric."""
    beta = (0.7 + 0.6 * rng.random(c)).astype(np.float32)
    gamma = (0.3 * np.eye(c) + 0.1 * rng.random((c, c))).astype(np.float32)
    assert not np.allclose(gamma, gamma.T)
    return beta, gamma


# the analysis transform's K2 stages at this slice's widths (5×5 stride 2)
K2_CASES = {"conv1_3to32_gdn": (3, True), "conv2_32to32_gdn": (32, True),
            "conv_3to32": (3, False), "conv_32to32": (32, False)}


@pytest.mark.parametrize("case", sorted(K2_CASES))
def test_k2_matches_pallas_interpret(case):
    cin, gdn_on = K2_CASES[case]
    rng = np.random.default_rng(20 + sorted(K2_CASES).index(case))
    x = (rng.standard_normal((1, 16, 24, cin)) * 0.5).astype(np.float32)
    w = (rng.standard_normal((5, 5, cin, N)) / np.sqrt(25 * cin)).astype(np.float32)
    b = (rng.standard_normal(N) * 0.01).astype(np.float32)
    beta, gamma = _gdn_params(rng, N)
    jp = jgdn.GDNParams(jnp.asarray(beta), jnp.asarray(gamma)) if gdn_on else None
    ref = np.asarray(jk2.conv_gdn(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), jp, 2, 2,
                                  False, True))
    gamma_t = tb = None
    if gdn_on:
        tb, tg = gdn_reparam(GDNParams(torch.from_numpy(beta), torch.from_numpy(gamma)))
        gamma_t = tg.t().contiguous()
    before = tk2.conv_gdn.launches
    out = tk2.conv_gdn(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b), gamma_t,
                       tb, 2, 2).numpy()
    assert tk2.conv_gdn.launches == before  # a CPU tensor takes the plain path
    assert out.shape == ref.shape == (1, 8, 12, N)
    np.testing.assert_allclose(out, ref, rtol=KRTOL, atol=KATOL)


def test_k1_igdn_matches_pallas_interpret():
    rng = np.random.default_rng(30)
    beta, gamma = _gdn_params(rng, N)
    x = rng.standard_normal((1, 8, 8, N)).astype(np.float32)
    ref = np.asarray(gdn_pallas(jnp.asarray(x), jgdn.GDNParams(jnp.asarray(beta),
                                                              jnp.asarray(gamma)),
                                inverse=True, interpret=True))
    before = tk1.gdn_fused.launches
    out = gdn(torch.from_numpy(x), GDNParams(torch.from_numpy(beta), torch.from_numpy(gamma)),
              inverse=True).numpy()
    assert tk1.gdn_fused.launches == before
    np.testing.assert_allclose(out, ref, rtol=KRTOL, atol=KATOL)


@pytest.mark.parametrize("quant", ["round", "sigma-norm"])
def test_eval_forward_matches_jax(quant):
    model = port_model(quant)
    x = np.stack([image(1), image(2)])
    with torch.no_grad():
        out = model(torch.from_numpy(x))
    ref = JaxHyperprior(N, M, quant=quant).apply({"params": jax_tree(model)}, jnp.asarray(x))
    assert set(out) == set(ref)
    for key in ("recon", "sigma", "latent", "hyper_latent", "mse"):
        np.testing.assert_allclose(out[key].numpy(), np.asarray(ref[key]), rtol=0, atol=ATOL,
                                   err_msg=key)
    for key in ("bpp", "bpp_y", "bpp_z"):
        np.testing.assert_allclose(float(out[key]), float(ref[key]), rtol=RATE_RTOL,
                                   err_msg=key)
    assert float(out["bpp_y"]) > 0.05  # y spreads over several symbols
    # the train forward (ported since; its parity is in test_torch_hyper_train.py)
    # gives the same keys, with noise where the eval forward rounds
    with torch.no_grad():
        noisy = model(torch.from_numpy(x), train=True, generator=torch.Generator().manual_seed(0))
    assert set(noisy) == set(out)
    assert not torch.equal(noisy["latent"], torch.round(noisy["latent"]))


@pytest.mark.parametrize("quant", ["round", "sigma-norm"])
def test_file_round_trip_exact(quant):
    model = port_model(quant)
    x = torch.from_numpy(image(3)[None])
    comp, y_hat = thp.compress(model, x, return_y_hat=True)
    recon, y_dec = thp.decompress(model, comp, return_y_hat=True)
    np.testing.assert_array_equal(y_dec, y_hat)
    with torch.no_grad():
        out = model(x)
    np.testing.assert_array_equal(y_hat, out["latent"][0].numpy())
    np.testing.assert_allclose(recon, out["recon"].numpy(), rtol=0, atol=1e-6)
    assert comp.quant == quant and comp.num_bits > 0 and comp.max_sym >= 2


def _jax_decode_parts(data: bytes, params):
    """The JAX decoder's z tables and σ scale indices for a kind-5 file."""
    from iclr_17_compression_tpu.coding.api import decode_latent
    from iclr_17_compression_tpu.coding.gaussian import default_scale_table, scale_indices
    from iclr_17_compression_tpu.models.cheng2020 import _bit_estimator_params, _z_codec
    from iclr_17_compression_tpu.models.hyperprior import _sigma_of

    comp, _, _, _, _, _ = tcli.read_hyperprior(data)
    codec = _z_codec(_bit_estimator_params(params, "bit_estimator_z"), comp.z_min, comp.z_max)
    z_hat = decode_latent(codec, comp.z_stream, comp.z_shape).astype(np.float32)
    sigma = _sigma_of(JaxHyperprior(N, M), params, z_hat)
    return codec.freqs, z_hat, scale_indices(sigma, default_scale_table())


def _port_decode_parts(data: bytes, model):
    from iclr_17_compression_tpu_torch.coding.gaussian import default_scale_table, scale_indices

    comp, _, _, _, _, _ = tcli.read_hyperprior(data)
    codec = thp.z_codec(model, comp.z_min, comp.z_max)
    z_hat = thp.decode_latent(codec, comp.z_stream, comp.z_shape).astype(np.float32)
    return codec.freqs, z_hat, scale_indices(thp.sigma_of(model, z_hat), default_scale_table())


@pytest.mark.parametrize("quant", ["round", "sigma-norm"])
def test_files_cross_packages(quant):
    """A kind-5 file of either package parses in the other, and decodes
    there to the encoder's ŷ where both derive the same ẑ tables and σ
    scale indices. On these inputs they do (asserted), so every file is
    decoded across."""
    spec = "hyperprior-sigma" if quant == "sigma-norm" else "hyperprior"
    model = port_model(quant, seed=5)
    params = {"params": jax_tree(model)}
    img = image(4, 64, 128)
    ours = tcli.encode_image(img, model, device="cpu")
    theirs = jcli.encode_image(img, spec, params, n=N, m=M)
    for data in (ours, theirs):
        pf, pz, pidx = _port_decode_parts(data, model)
        jf, jz, jidx = _jax_decode_parts(data, params)
        np.testing.assert_array_equal(pz, jz)
        np.testing.assert_array_equal(pf, jf)
        np.testing.assert_array_equal(pidx, jidx)
        port_rec = tcli.decode_image(data, model, device="cpu")
        jax_rec = jcli.decode_image(data, params)
        np.testing.assert_allclose(port_rec, jax_rec, rtol=0, atol=ATOL)
    # the same ŷ from both files: each package's decode of the other's file
    comp_o = tcli.read_hyperprior(ours)[0]
    comp_t = tcli.read_hyperprior(theirs)[0]
    _, yo = thp.decompress(model, comp_o, return_y_hat=True)
    _, yt = thp.decompress(model, comp_t, return_y_hat=True)
    np.testing.assert_allclose(yo, yt, rtol=0, atol=1e-5)
    assert ours[:5] == theirs[:5] and len(ours) > 0


def test_weight_bridges_round_trip_and_import():
    from iclr_17_compression_tpu.models.hyperprior import ScaleHyperprior as J

    tree = J(N, M).init({"params": __import__("jax").random.PRNGKey(0),
                         "quant": __import__("jax").random.PRNGKey(1)},
                        jnp.zeros((1, 64, 64, 3)), train=False)["params"]
    tree = __import__("jax").tree_util.tree_map(np.asarray, tree)
    back = hyperprior_params_to_jax(hyperprior_params_from_jax(tree, N, M), N, M)
    flat, flat_back = _flatten(tree), _flatten(back)
    assert set(flat) == set(flat_back)
    for k in flat:
        np.testing.assert_array_equal(flat_back[k], flat[k], err_msg=k)
    model = port_model()
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    imported, ours = _flatten(import_hyperprior(sd)), _flatten(jax_tree(model))
    assert set(imported) == set(ours)
    for k in ours:
        np.testing.assert_array_equal(imported[k], ours[k], err_msg=k)
    with pytest.raises(KeyError):
        hyperprior_params_from_jax({k: v for k, v in tree.items() if k != "h_s"}, N, M)


def test_cli_roundtrip_and_build_model(tmp_path, capsys):
    kind, built, mult = tcli.build_model("hyperprior-sigma")
    assert (kind, mult, built.out_channel_n, built.out_channel_m, built.quant) == (
        tcli.KIND_HYPERPRIOR, 64, 192, 320, "sigma-norm")
    model = port_model("round", seed=6)
    ckpt = tmp_path / "hp.msgpack"
    ckpt.write_bytes(msgpack_dumps({"params": jax_tree(model)}))
    img = image(7, 48, 80)
    src = tmp_path / "in.ppm"
    u8 = np.round(img * 255).astype(np.uint8)
    src.write_bytes(b"P6\n80 48\n255\n" + u8.tobytes())
    img = u8.astype(np.float32) / 255.0
    tcli.main(["roundtrip", str(src), "--model", "hyperprior", "--ckpt", str(ckpt),
               "--n", str(N), "--m", str(M), "--device", "cpu"])
    got = __import__("json").loads(capsys.readouterr().out.strip().splitlines()[-1])
    loaded = load_hyperprior(str(ckpt), device="cpu")
    data = tcli.encode_image(img, loaded, device="cpu")
    rec = tcli.decode_image(data, loaded, device="cpu")
    mse = float(np.mean((rec - img) ** 2))
    assert got == {"bytes": len(data), "bpp": round(8.0 * len(data) / (48 * 80), 5),
                   "psnr": round(10.0 * np.log10(1.0 / mse), 3)}
    icz, out = tmp_path / "a.icz", tmp_path / "a.ppm"
    tcli.main(["encode", str(src), str(icz), "--model", "hyperprior", "--ckpt", str(ckpt),
               "--n", str(N), "--m", str(M), "--device", "cpu"])
    assert icz.read_bytes() == data
    tcli.main(["decode", str(icz), str(out), "--ckpt", str(ckpt), "--device", "cpu"])
    assert out.stat().st_size == len(b"P6\n80 48\n255\n") + 48 * 80 * 3
    with pytest.raises(ValueError, match="shape"):  # widths the checkpoint does not have
        tcli.main(["roundtrip", str(src), "--model", "hyperprior", "--ckpt", str(ckpt),
                   "--device", "cpu"])
