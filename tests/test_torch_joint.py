"""Port parity: the joint-autoregressive (Cheng-2020) codec
(``models/cheng2020.py``, ``nn/layers.MaskedConv``, the host AR context and
its native library ``coding/ar_native.py``, kind 6 of ``coding/codec_cli.py``,
the weight bridges) against the JAX package, on the CPU in fp32.

Weights: the port's seeded init at n = 32, every GDN moved off the identity
(a full, non-symmetric γ), each channel of ``g_a``'s last conv centred and
scaled so that y spreads over several symbols; carried to JAX by
``joint_params_to_jax``; numpy-seeded 64×64 images. Stated tolerances:
each stack atol 1e-4; eval forward recon, σ and μ atol 1e-4, bpp / bpp_y /
bpp_z rtol 1e-4; the host AR loop byte-equal to JAX's numpy loop given
JAX's own y and hyper; the native library within the JAX test's 2e-4 of the
numpy path front by front; a file round trip bit-exact in ŷ; a file of one
package decodes in the other to ŷ within 1e-5.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iclr_17_compression_tpu.coding import codec_cli as jcli
from iclr_17_compression_tpu.models import cheng2020 as jc
from iclr_17_compression_tpu.nn.layers import MaskedConv as JaxMaskedConv
from iclr_17_compression_tpu.train.torch_import import import_joint
from iclr_17_compression_tpu_torch.coding import ar_native
from iclr_17_compression_tpu_torch.coding import codec_cli as tcli
from iclr_17_compression_tpu_torch.models import cheng2020 as tc
from iclr_17_compression_tpu_torch.models.cheng2020 import JointAutoregressive
from iclr_17_compression_tpu_torch.nn.layers import MaskedConv
from iclr_17_compression_tpu_torch.ops.kernels import conv_gdn_kernel as tk2
from iclr_17_compression_tpu_torch.train.weights import (_flatten, joint_params_from_jax,
                                                         joint_params_to_jax, load_joint,
                                                         msgpack_dumps)
from test_torch_dsc_blocks import perturb_gdn_
from test_torch_hyperprior import image

N = 32
ATOL = 1e-4
RATE_RTOL = 1e-4
NATIVE_TOL = 2e-4  # the JAX package's native-vs-numpy tolerance
Y_STD = 2.0


def port_model(seed: int = 0) -> JointAutoregressive:
    """Seeded weights, GDNs off the identity, y spread to Y_STD a channel."""
    gen = torch.Generator().manual_seed(seed)
    model = JointAutoregressive(N).init_(gen)
    perturb_gdn_(model, gen)
    model.eval()
    last = model.g_a[6]
    with torch.no_grad():
        y = model.g_a(torch.from_numpy(image(100 + seed)[None])).flatten(0, 2)
        scale = Y_STD / y.std(dim=0)
        last.weight.mul_(scale.view(-1, 1, 1, 1))
        last.bias.copy_(scale * (last.bias - y.mean(dim=0)))
    return model


def jax_params(model):
    return {"params": joint_params_to_jax(model.state_dict(), N)}


STACKS = {
    "ChengAnalysis": ("g_a", jc.ChengAnalysis, (2, 64, 64, 3)),
    "ChengHyperAnalysis": ("h_a", jc.ChengHyperAnalysis, (2, 4, 4, N)),
    "ChengHyperSynthesis": ("h_s", jc.ChengHyperSynthesis, (2, 1, 2, N)),
    "ChengSynthesis": ("g_s", jc.ChengSynthesis, (2, 4, 4, N)),
    "EntropyParameters": ("entropy_parameters", jc.EntropyParameters, (2, 4, 4, 4 * N)),
}


@pytest.mark.parametrize("stack", sorted(STACKS))
def test_stack_matches_jax(stack):
    name, jmod, shape = STACKS[stack]
    model = port_model()
    x = np.random.default_rng(sorted(STACKS).index(stack)).standard_normal(shape)
    x = (np.abs(x) * 0.3 if name == "g_a" else x).astype(np.float32)
    before = tk2.conv_gdn.launches
    with torch.no_grad():
        out = getattr(model, name)(torch.from_numpy(x)).numpy()
    assert tk2.conv_gdn.launches == before  # the CPU takes the plain path
    ref = np.asarray(jmod(N).apply({"params": jax_params(model)["params"][name]},
                                   jnp.asarray(x)))
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=0, atol=ATOL)


@pytest.mark.parametrize("mask_type", ["A", "B"])
def test_masked_conv_matches_jax(mask_type):
    gen = torch.Generator().manual_seed(3)
    conv = MaskedConv(N, 2 * N, 5, mask_type=mask_type, padding=2)
    conv.init_(gen)
    assert set(conv.state_dict()) == {"weight", "bias"}  # the mask is not a weight
    x = np.random.default_rng(4).standard_normal((2, 6, 7, N)).astype(np.float32)
    with torch.no_grad():
        out = conv(torch.from_numpy(x)).numpy()
    params = {"weight": conv.weight.detach().numpy().transpose(2, 3, 1, 0),
              "bias": conv.bias.detach().numpy()}
    ref = np.asarray(JaxMaskedConv(2 * N, 5, mask_type=mask_type, padding=2).apply(
        {"params": params}, jnp.asarray(x)))
    np.testing.assert_allclose(out, ref, rtol=0, atol=ATOL)
    live = int(conv.mask.sum())
    assert live == (12 if mask_type == "A" else 13)
    with pytest.raises(ValueError):
        MaskedConv(N, N, 5, mask_type="C")


def _jax_prob_y(out):
    delta = out["latent"] - out["mu"]
    return np.asarray(jc.normal_cdf((delta + 0.5) / out["sigma"])
                      - jc.normal_cdf((delta - 0.5) / out["sigma"]))


def test_eval_forward_matches_jax():
    """bpp_y. At the seeded init σ sits at its floor (0.11) while y spreads
    over ±6, so many elements lie 10-60 σ from μ, where P(ŷ) = Φ(a) − Φ(b)
    of two fp32 CDFs near 1 is rounding noise in both packages (±2 ulp of 1).
    There XLA's fp32 erf is not monotone: it can return less for a larger
    argument, so the JAX forward's P comes out negative (−6e-8) at some
    elements and its bpp_y is NaN; the port's P stays ≥ 0 at every element
    and its bpp_y finite. The test asserts that difference where it
    occurs, holds P element by element to atol 3e-7
    (2.5 ulp of 1) everywhere, and holds the bits rtol 1e-4 summed over the
    elements where both P ≥ 1e-3 (where fp32 resolves them); where the JAX
    total is finite, the totals rtol 1e-4."""
    model = port_model()
    x = np.stack([image(1), image(2)])
    with torch.no_grad():
        out = model(torch.from_numpy(x))
    ref = jc.JointAutoregressive(N).apply(jax_params(model), jnp.asarray(x))
    assert set(out) == set(ref)
    for key in ("recon", "sigma", "mu", "latent", "hyper_latent", "mse"):
        np.testing.assert_allclose(out[key].numpy(), np.asarray(ref[key]), rtol=0, atol=ATOL,
                                   err_msg=key)
    np.testing.assert_allclose(float(out["bpp_z"]), float(ref["bpp_z"]), rtol=RATE_RTOL)
    assert np.isfinite(float(out["bpp_y"])) and float(out["bpp_y"]) > 0.05
    prob_j = _jax_prob_y(ref)
    delta = out["latent"] - out["mu"]
    prob_t = (tc.normal_cdf((delta + 0.5) / out["sigma"])
              - tc.normal_cdf((delta - 0.5) / out["sigma"])).numpy()
    assert prob_t.min() >= 0.0
    np.testing.assert_allclose(prob_t, prob_j, rtol=0, atol=3e-7)
    negative = prob_j < 0
    assert np.isfinite(float(ref["bpp_y"])) == (not negative.any())
    if not negative.any():
        for key in ("bpp", "bpp_y"):
            np.testing.assert_allclose(float(out[key]), float(ref[key]), rtol=RATE_RTOL)
    resolved = (prob_t >= 1e-3) & (prob_j >= 1e-3)
    assert resolved.mean() > 0.1
    bits = lambda p: np.clip(-np.log2(p[resolved] + 1e-10), 0.0, 50.0).sum()  # noqa: E731
    np.testing.assert_allclose(bits(prob_t), bits(prob_j), rtol=RATE_RTOL)
    # the train forward (ported since; its parity is in test_torch_hyper_train.py)
    # gives the same keys, with noise where the eval forward rounds
    with torch.no_grad():
        noisy = model(torch.from_numpy(x), train=True, generator=torch.Generator().manual_seed(0))
    assert set(noisy) == set(out)
    assert not torch.equal(noisy["latent"], torch.round(noisy["latent"]))


def _jax_y_hyper(params, img):
    """JAX's own y and hyper-decoder output for one image, as its compress
    computes them."""
    y = np.asarray(jc._apply_submodule(None, params, "g_a", jc.ChengAnalysis(N),
                                       jnp.asarray(img[None])))[0]
    z = np.asarray(jc._apply_submodule(None, params, "h_a", jc.ChengHyperAnalysis(N),
                                       jnp.asarray(y[None])))[0]
    hyper = np.asarray(jc._apply_submodule(None, params, "h_s", jc.ChengHyperSynthesis(N),
                                           jnp.asarray(np.round(z)[None])), np.float32)[0]
    return y, hyper


def test_host_ar_stream_byte_equal_to_jax(monkeypatch):
    monkeypatch.setenv("ICLR17C_AR_HOST", "numpy")
    model = port_model()
    params = jax_params(model)
    img = image(5, 64, 128)
    comp, y_hat_j = jc.compress(jc.JointAutoregressive(N), params, img[None], return_y_hat=True)
    y, hyper = _jax_y_hyper(params, img)
    host = tc._HostARContext(model, "numpy")
    stream, max_sym, y_hat, tids = tc.ar_encode(host, y, hyper, model.scale_bound)
    assert tids.shape == (y.size,) and tids.max() > tids.min()
    assert max_sym == comp.max_sym and max_sym >= 4
    assert stream == comp.y_stream
    np.testing.assert_array_equal(y_hat, y_hat_j)
    np.testing.assert_array_equal(
        tc.ar_decode(host, stream, y.shape, max_sym, hyper, model.scale_bound), y_hat)


def test_native_matches_numpy_front_by_front():
    model = port_model()
    native, plain = tc._HostARContext(model, "native"), tc._HostARContext(model, "numpy")
    assert native._native is not None and plain._native is None
    h, w, pad = 8, 12, native.kh // 2
    rng = np.random.default_rng(0)
    y_hat_pad = rng.normal(0, 2.5, (h + 2 * pad, w + 2 * pad, N)).astype(np.float32)
    hyper = rng.normal(0, 1.0, (h, w, 2 * N)).astype(np.float32)
    base = plain.prep(hyper)
    np.testing.assert_array_equal(native.prep(hyper), base)
    for ii, jj in tc._wavefronts(h, w):
        mu_n, sg_n = native.mu_sigma_batch(y_hat_pad, base, ii, jj, 0.11)
        mu_p, sg_p = plain.mu_sigma_batch(y_hat_pad, base, ii, jj, 0.11)
        np.testing.assert_allclose(mu_n, mu_p, rtol=NATIVE_TOL, atol=NATIVE_TOL)
        np.testing.assert_allclose(sg_n, sg_p, rtol=NATIVE_TOL, atol=NATIVE_TOL)
        assert np.all(sg_n >= 0.11)


def test_wavefronts_match_jax():
    for h, w in ((1, 1), (4, 4), (5, 9), (12, 7)):
        ours, ref = tc._wavefronts(h, w), jc._wavefronts(h, w)
        assert len(ours) == len(ref)
        for (a, b), (c, d) in zip(ours, ref):
            np.testing.assert_array_equal(a, c)
            np.testing.assert_array_equal(b, d)
        cover = np.concatenate([ii * w + jj for ii, jj in ours])
        np.testing.assert_array_equal(np.sort(cover), np.arange(h * w))


@pytest.mark.parametrize("backend", ["native", "numpy"])
def test_file_round_trip_exact(backend):
    model = port_model()
    x = torch.from_numpy(image(6)[None])
    comp, y_hat = tc.compress(model, x, return_y_hat=True, backend=backend)
    recon, y_dec = tc.decompress(model, comp, return_y_hat=True, backend=backend)
    np.testing.assert_array_equal(y_dec, y_hat)
    assert recon.shape == (1, 64, 64, 3) and recon.min() >= 0.0 and recon.max() <= 1.0
    q, _ = tc.decompress(model, comp, return_y_hat=True, quantize_fetch=True, backend=backend)
    np.testing.assert_array_equal(q, np.round(recon * 255.0).astype(np.uint8) / np.float32(255))
    with torch.no_grad():
        ref = model.g_s(torch.from_numpy(y_hat[None])).clamp(0, 1).numpy()
    np.testing.assert_array_equal(recon, ref)
    assert comp.max_sym >= 4 and comp.num_bits > 0


def test_no_silent_fallback(monkeypatch):
    model = port_model()
    with pytest.raises(ValueError, match="backend"):
        tc._HostARContext(model, "auto")

    def missing():
        raise RuntimeError("native AR host backend: no libscipy_openblas*.so")

    monkeypatch.setattr(ar_native, "find_blas", missing)
    with pytest.raises(RuntimeError, match="openblas"):
        tc.compress(model, torch.from_numpy(image(6)[None]))
    tc.compress(model, torch.from_numpy(image(6)[None]), backend="numpy")  # asked for: runs


def test_files_cross_packages(monkeypatch):
    """A kind-6 file of either package decodes in the other (both on their
    numpy host paths) to the encoder's ŷ within 1e-5: the two packages'
    hyper decoders differ in the last bits, which moves μ by as much and
    no σ across a scale-table edge on these inputs (the decode would
    desync otherwise)."""
    monkeypatch.setenv("ICLR17C_AR_HOST", "numpy")
    model = port_model(seed=1)
    params = jax_params(model)
    img = image(7, 64, 128)
    ours = tcli.encode_image(img, model, device="cpu", ar_backend="numpy")
    theirs = jcli.encode_image(img, "joint", params, n=N)
    comp_o, n_o, _, _ = tcli.read_joint(ours)
    comp_t, n_t, _, _ = tcli.read_joint(theirs)
    assert n_o == n_t == N and comp_o.y_shape == comp_t.y_shape
    _, y_enc_o = tc.compress(model, torch.from_numpy(tcli.pad_to_multiple(img, 64)[None]),
                             return_y_hat=True, backend="numpy")
    _, y_enc_t = jc.compress(jc.JointAutoregressive(N), params, img[None], return_y_hat=True)
    _, y_dec_t = tc.decompress(model, comp_t, return_y_hat=True, backend="numpy")
    np.testing.assert_allclose(y_dec_t, y_enc_t, rtol=0, atol=1e-5)
    _, y_dec_o = jc.decompress(jc.JointAutoregressive(N), params,
                               jc.CompressedImage(*comp_o), return_y_hat=True)
    np.testing.assert_allclose(y_dec_o, y_enc_o, rtol=0, atol=1e-5)
    rec_o = tcli.decode_image(ours, model, device="cpu", ar_backend="numpy")
    np.testing.assert_allclose(jcli.decode_image(ours, params), rec_o, rtol=0, atol=ATOL)


def test_weight_bridges_round_trip_and_import():
    tree = jc.JointAutoregressive(N).init(
        {"params": jax.random.PRNGKey(0), "quant": jax.random.PRNGKey(1)},
        jnp.zeros((1, 64, 64, 3)), train=False)["params"]
    tree = jax.tree_util.tree_map(np.asarray, tree)
    back = joint_params_to_jax(joint_params_from_jax(tree, N), N)
    flat, flat_back = _flatten(tree), _flatten(back)
    assert set(flat) == set(flat_back)
    for k in flat:
        np.testing.assert_array_equal(flat_back[k], flat[k], err_msg=k)
    model = port_model()
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    ours = _flatten(joint_params_to_jax(model.state_dict(), N))
    imported = _flatten(import_joint(sd))
    # import_joint maps every key but the z prior (CompressAI's
    # entropy_bottleneck has no Bitparm counterpart; the JAX importer
    # skips it)
    assert set(imported) == {k for k in ours if not k.startswith("bit_estimator_z/")}
    for k in imported:
        np.testing.assert_array_equal(imported[k], ours[k], err_msg=k)


def test_cli_roundtrip_and_build_model(tmp_path, capsys):
    kind, built, mult = tcli.build_model("joint")
    assert (kind, mult, built.n) == (tcli.KIND_JOINT, 64, 192)
    model = port_model(seed=2)
    ckpt = tmp_path / "joint.msgpack"
    ckpt.write_bytes(msgpack_dumps(jax_params(model)))
    u8 = np.round(image(8, 48, 80) * 255).astype(np.uint8)
    src = tmp_path / "in.ppm"
    src.write_bytes(b"P6\n80 48\n255\n" + u8.tobytes())
    img = u8.astype(np.float32) / 255.0
    tcli.main(["roundtrip", str(src), "--model", "joint", "--ckpt", str(ckpt), "--n", str(N),
               "--device", "cpu"])
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    loaded = load_joint(str(ckpt), device="cpu")
    data = tcli.encode_image(img, loaded, device="cpu")
    rec = tcli.decode_image(data, loaded, device="cpu")
    mse = float(np.mean((rec - img) ** 2))
    assert got == {"bytes": len(data), "bpp": round(8.0 * len(data) / (48 * 80), 5),
                   "psnr": round(10.0 * np.log10(1.0 / mse), 3)}
    icz = tmp_path / "a.icz"
    tcli.main(["encode", str(src), str(icz), "--model", "joint", "--ckpt", str(ckpt),
               "--n", str(N), "--ar-backend", "numpy", "--device", "cpu"])
    tcli.main(["decode", str(icz), str(tmp_path / "a.ppm"), "--ckpt", str(ckpt),
               "--ar-backend", "numpy", "--device", "cpu"])
    assert (tmp_path / "a.ppm").stat().st_size == len(b"P6\n80 48\n255\n") + 48 * 80 * 3
    with pytest.raises(ValueError, match="unknown model"):
        tcli.main(["encode", str(src), str(icz), "--model", "nope", "--ckpt", str(ckpt),
                   "--device", "cpu"])
