"""Port parity: the Ballé-17 file codec against the JAX package's
``codec_cli`` and rANS coder, on the CPU path.

Stated tolerances: headers byte-equal; PSNR within 0.01 dB and bpp within
0.5% of the JAX codec; CDF tables equal for three of the four archived
checkpoints and within the 2 entries, 1 count each, that msssim48 differs in
today (``CDF_TABLE_DIFFS``); with identical tables and latent, the rANS
stream is byte-identical.
"""

import os
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iclr_17_compression_tpu.coding import api as japi
from iclr_17_compression_tpu.coding import codec_cli as jcli
from iclr_17_compression_tpu.models.cheng2020 import _bit_estimator_params
from iclr_17_compression_tpu_torch.coding import api as tapi
from iclr_17_compression_tpu_torch.coding import codec_cli as tcli
from iclr_17_compression_tpu_torch.ops.metrics import psnr
from iclr_17_compression_tpu_torch.train.weights import load_balle17, read_checkpoint

CKPT = os.path.join(os.path.dirname(__file__), "..", "results", "ckpts",
                    "lam2048_iter_19000.ckpt")


def _image(seed, h, w):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.full((h, w, 3), 0.5, np.float32)
    for _ in range(4):
        f = rng.uniform(-3, 3, 2) / np.array([h, w])
        img += rng.uniform(0.05, 0.15, 3).astype(np.float32) * np.cos(
            2 * np.pi * (f[0] * yy + f[1] * xx) + rng.uniform(0, 6))[..., None]
    img += 0.03 * rng.standard_normal((h, w, 3)).astype(np.float32)
    return np.clip(img, 0, 1)


@pytest.fixture(scope="module")
def models():
    tree = read_checkpoint(CKPT)
    jparams = {"params": jax.tree_util.tree_map(jnp.asarray, tree)}
    return jparams, load_balle17(CKPT, device="cpu")


def _header_len(data):
    return 4 + 2 + data[5] + struct.calcsize("<HII") + struct.calcsize("<HHHhh")


def test_codec_matches_jax_codec(models):
    jparams, model = models
    img = _image(0, 40, 56)  # not a multiple of 16: exercises the padding
    jdata = jcli.encode_image(img, "balle17", jparams, n=128)
    jrec = jcli.decode_image(jdata, jparams)
    data = tcli.encode_image(img, model, device="cpu")
    rec = tcli.decode_image(data, model, device="cpu")
    assert rec.shape == img.shape and rec.min() >= 0 and rec.max() <= 1
    assert data[:_header_len(data)] == jdata[:_header_len(jdata)]
    p_port = float(psnr(torch.from_numpy(rec), torch.from_numpy(img)))
    p_jax = float(psnr(torch.from_numpy(np.asarray(jrec)), torch.from_numpy(img)))
    assert abs(p_port - p_jax) <= 0.01
    assert abs(len(data) - len(jdata)) <= 0.005 * len(jdata)
    # the port reads back the latent it wrote
    lat, h0, w0 = tcli.read_latent(data, model)
    assert (h0, w0) == img.shape[:2] and lat.shape == (3, 4, 128)


# Entries of the (128, 121) table at z in [-60, 60] where the port's CDF
# tables differ from the JAX package's on the CPU, for each archived Ballé
# checkpoint, and by how many counts at most. XLA's and PyTorch's float32
# tanh/softplus/sigmoid differ in the last ulp on some inputs, which can move
# a pmf entry across a quantization boundary; only msssim48 is affected.
CDF_TABLE_DIFFS = {
    "lam128_iter_10000": (0, 0),
    "lam2048_iter_19000": (0, 0),
    "lam8192_iter_20000": (0, 0),
    "msssim48_iter_12000": (2, 1),
}


@pytest.mark.parametrize("ckpt", sorted(CDF_TABLE_DIFFS))
def test_cdf_tables_and_rans_stream_match_jax(ckpt):
    path = os.path.join(os.path.dirname(CKPT), ckpt + ".ckpt")
    jparams = {"params": jax.tree_util.tree_map(jnp.asarray, read_checkpoint(path))}
    model = load_balle17(path, device="cpu")
    zmin, zmax = -60, 60
    jcodec = japi.build_cdf_tables_from_bit_estimator(
        _bit_estimator_params(jparams, "bit_estimator"), zmin, zmax)
    tcodec = tapi.build_cdf_tables_from_bit_estimator(model.bitEstimator.params(), zmin, zmax)
    assert tcodec.freqs.shape == jcodec.freqs.shape == (128, zmax - zmin + 1)
    assert (tcodec.freqs.sum(axis=1) == 1 << 14).all()
    diff = np.abs(tcodec.freqs.astype(np.int64) - jcodec.freqs.astype(np.int64))
    entries, counts = CDF_TABLE_DIFFS[ckpt]
    assert int((diff > 0).sum()) <= entries and int(diff.max()) <= counts
    if entries == 0:
        np.testing.assert_array_equal(tcodec.freqs, jcodec.freqs)

    rng = np.random.default_rng(2)
    lat = np.clip(np.round(rng.laplace(0, 2, (5, 7, 128))), zmin, zmax).astype(np.int64)
    same = japi.RansCodec(tcodec.freqs, offset=zmin)  # the JAX coder on the port's tables
    stream = tapi.encode_latent(tcodec, lat)
    assert stream == japi.encode_latent(same, lat)
    np.testing.assert_array_equal(tapi.decode_latent(tcodec, stream, lat.shape), lat)
    np.testing.assert_array_equal(japi.decode_latent(same, stream, lat.shape), lat)


def test_quantize_pmf_matches_jax():
    rng = np.random.default_rng(3)
    for nsym in (2, 17, 255):
        pmf = rng.dirichlet(np.full(nsym, 0.3))
        np.testing.assert_array_equal(tapi._quantize_pmf(pmf, 14), japi._quantize_pmf(pmf, 14))


def test_latent_beyond_8_bit_symbols_codes_as_the_jax_codec():
    """A latent beyond ±127 (lam2048 with conv3 scaled by 8: -156..164)
    round-trips exactly through the port's 16-bit symbols, with the JAX
    codec's latent, header and, with equal tables, its bytes."""
    scale = 8.0
    tree = read_checkpoint(CKPT)
    tree["encoder"]["conv3"]["weight"] = tree["encoder"]["conv3"]["weight"] * scale
    jparams = {"params": jax.tree_util.tree_map(jnp.asarray, tree)}
    model = load_balle17(CKPT, device="cpu")
    with torch.no_grad():
        model.Encoder.conv3.weight.mul_(scale)
    img = _image(4, 48, 64)
    data = tcli.encode_image(img, model, device="cpu")
    jdata = jcli.encode_image(img, "balle17", jparams, n=128)
    lat, h0, w0 = tcli.read_latent(data, model)
    with torch.no_grad():
        enc = torch.round(model.Encoder(torch.from_numpy(img[None]))).numpy()[0]
    np.testing.assert_array_equal(lat, enc)
    assert np.abs(lat).max() > 127 and (h0, w0) == img.shape[:2]
    assert tcli.decode_image(data, model, device="cpu").shape == img.shape
    from iclr_17_compression_tpu.models.balle17 import Analysis17 as JAnalysis17

    jlat = np.asarray(jnp.round(JAnalysis17(128).apply(
        {"params": jparams["params"]["encoder"]}, jnp.asarray(img[None]))))[0]
    np.testing.assert_array_equal(lat, jlat)
    assert data[:_header_len(data)] == jdata[:_header_len(jdata)]
    zmin, zmax = int(lat.min()), int(lat.max())
    tcodec = tapi.build_cdf_tables_from_bit_estimator(model.bitEstimator.params(), zmin, zmax)
    jcodec = japi.build_cdf_tables_from_bit_estimator(
        _bit_estimator_params(jparams, "bit_estimator"), zmin, zmax)
    np.testing.assert_array_equal(tcodec.freqs, jcodec.freqs)
    assert data == jdata


def test_cli_png_roundtrip(models, tmp_path):
    from PIL import Image

    img = (_image(5, 32, 48) * 255).astype(np.uint8)
    src, icz, dst = tmp_path / "in.png", tmp_path / "x.icz", tmp_path / "out.png"
    Image.fromarray(img).save(src)
    tcli.main(["encode", str(src), str(icz), "--ckpt", CKPT, "--device", "cpu"])
    tcli.main(["decode", str(icz), str(dst), "--ckpt", CKPT, "--device", "cpu"])
    rec = np.asarray(Image.open(dst))
    assert rec.shape == img.shape
    assert float(psnr(torch.from_numpy(rec / 255.0), torch.from_numpy(img / 255.0))) > 20.0
