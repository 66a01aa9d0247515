"""Port parity: the DSC file codec, the two-stage file, the stereo evals and
the stereo dataset against the JAX package's, on the CPU.

Weights: the port's seeded ``tiny`` / ``tiny_reg`` init (GDNs moved off the
identity, the code spread over several symbols), carried to JAX by
``dsc_params_to_jax``; images numpy-seeded. Stated tolerances:

- ``serialize_dsc_code``, ``build_cdf_tables_from_histogram`` and
  ``gzip_bpp``: equal bytes / tables / values for the same symbols;
- end to end: the port's symbols equal JAX's except where code_pre/step
  lies within 1e-4 of a k + ½ boundary (reported, not avoided), where they
  may differ by one; where all are equal, the files are byte-equal;
- each package decodes the other's file, to atol 1e-4 of its own decode;
- evals: bpp_rans and bpp_gzip equal, PSNR within 1e-3 dB, MS-SSIM 1e-5;
- the stereo dataset: equal arrays.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iclr_17_compression_tpu.coding import api as japi
from iclr_17_compression_tpu.coding import codec_cli as jcli
from iclr_17_compression_tpu.data.datasets import StereoPairDataset as JaxStereoPairs
from iclr_17_compression_tpu.eval.reg_stage import eval_reg_stage as jax_eval_reg_stage
from iclr_17_compression_tpu.eval.stereo import eval_stereo_dsc as jax_eval_stereo
from iclr_17_compression_tpu.models import DSC_PRESETS as JAX_PRESETS
from iclr_17_compression_tpu.models import DSCStereoModel as JaxModel
from iclr_17_compression_tpu.models.dsc import _Stack
from iclr_17_compression_tpu_torch.coding import api as tapi
from iclr_17_compression_tpu_torch.coding import codec_cli as tcli
from iclr_17_compression_tpu_torch.data.datasets import StereoPairDataset, write_ppm
from iclr_17_compression_tpu_torch.eval.reg_stage import eval_reg_stage
from iclr_17_compression_tpu_torch.eval.stereo import eval_stereo_dsc
from iclr_17_compression_tpu_torch.models.dsc import DSC_PRESETS, DSCStereoModel
from iclr_17_compression_tpu_torch.nn.layers import GDN
from iclr_17_compression_tpu_torch.train.weights import (dsc_params_to_jax, load_dsc,
                                                         msgpack_dumps)

ATOL = 1e-4
H, W = 64, 96


def _pair(seed, h=H, w=W):
    """A left image and its right eye: rows shifted by a smooth disparity,
    with a small gain and offset (the eval pairs' warp family)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    a = np.full((h, w, 3), 0.5, np.float32)
    for _ in range(4):
        f = rng.uniform(-3, 3, 2) / np.array([h, w])
        a += rng.uniform(0.05, 0.15, 3).astype(np.float32) * np.cos(
            2 * np.pi * (f[0] * yy + f[1] * xx) + rng.uniform(0, 6))[..., None]
    a = np.clip(a + 0.05 * rng.standard_normal((h, w, 3)).astype(np.float32), 0, 1)
    disp = (4 + 2 * np.sin(np.linspace(0, 2 * np.pi, h) + rng.uniform(0, 6)))[:, None]
    cols = np.clip(np.arange(w)[None, :] + disp, 0, w - 1).astype(int)
    b = np.clip(a[np.arange(h)[:, None], cols] * rng.uniform(0.95, 1.05) + 0.02, 0, 1)
    return a, b.astype(np.float32)


def _model(preset, seed, spread=12.0):
    """The port's seeded init of ``preset``, GDNs off the identity and the
    last 3×3 conv of g_a22 scaled for a code of about ``spread`` std."""
    gen = torch.Generator().manual_seed(seed)
    model = DSCStereoModel(DSC_PRESETS[preset]).init_(gen).eval()
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, GDN):
                c = m.beta.shape[0]
                m.beta.copy_(0.7 + 0.6 * torch.rand(c, generator=gen))
                m.gamma.copy_(0.3 * torch.eye(c) + 0.1 * torch.rand((c, c), generator=gen))
        last = model.g_a22[max(i for i, s in enumerate(model.config.ga22) if s[0] == "conv3")]
        x = torch.from_numpy(_pair(0)[0][None])
        scale = spread / float(model.encode(x).std())
        last.weight.mul_(scale)
        last.bias.mul_(scale)
    return model


def _jparams(model):
    return {"params": jax.tree_util.tree_map(
        jnp.asarray, dsc_params_to_jax(model.state_dict(), model.config))}


@pytest.fixture(scope="module")
def models():
    base, reg = _model("tiny", 0), _model("tiny_reg", 1)
    return base, _jparams(base), reg, _jparams(reg)


def _near_boundary(jparams, preset, img):
    """Elements of the code whose code_pre/step lies within 1e-4 of k + ½."""
    cfg = JAX_PRESETS[preset]
    p = jparams["params"]
    x = jnp.asarray(jcli.pad_to_multiple(img, cfg.code_div)[None])
    pre = np.asarray(_Stack(cfg.ga22).apply({"params": p["g_a22"]},
                                           _Stack(cfg.ga).apply({"params": p["g_a"]}, x)))
    q = pre[0] / cfg.coarse_step
    return np.abs(q - np.floor(q) - 0.5) < 1e-4


def _payload_syms(data):
    code, _, _, _ = tcli.read_dsc_code(data)
    return np.round(code[0] / 16.0).astype(np.int64)


def test_histogram_tables_serialize_and_gzip_match_jax():
    syms = np.random.default_rng(4).integers(-9, 10, (3, 5, 8))
    for offset, nsym in ((None, None), (-8, 17)):
        t = tapi.build_cdf_tables_from_histogram(np.clip(syms, -8, 8), offset=offset, nsym=nsym)
        j = japi.build_cdf_tables_from_histogram(np.clip(syms, -8, 8), offset=offset, nsym=nsym)
        assert np.array_equal(t.freqs, j.freqs) and t.offset == j.offset
    for clip in (128.0, None):
        assert tcli.serialize_dsc_code(syms, 16.0, clip) == jcli.serialize_dsc_code(syms, 16.0,
                                                                                     clip)
    code = syms.astype(np.float32) * 16.0
    assert tapi.gzip_bpp(code, 640) == japi.gzip_bpp(code, 640)
    with pytest.raises(ValueError, match="do not fit"):
        tapi.build_cdf_tables_from_histogram(np.array([[0], [20000]]))


def test_dsc_file_matches_jax_and_cross_decodes(models):
    model, jparams, _, _ = models
    a, b = _pair(1, 70, 100)  # not a multiple of 32: the padding
    data = tcli.encode_image(a, model, device="cpu")
    jdata = jcli.encode_image(a, "tiny", jparams)
    syms, jsyms = _payload_syms(data), _payload_syms(jdata)
    assert len(np.unique(jsyms)) >= 4, "the code uses too few symbols to test"
    near = _near_boundary(jparams, "tiny", a)
    assert np.array_equal(syms[~near], jsyms[~near])
    assert np.abs(syms - jsyms).max() <= 1
    if near.any():
        print(f"{int(near.sum())} code elements within 1e-4 of k + 1/2")
    else:
        assert data == jdata
    # the same symbols serialize to the same bytes
    assert tcli.serialize_dsc_code(jsyms, 16.0, 128.0) == jcli.serialize_dsc_code(jsyms, 16.0,
                                                                                    128.0)
    rec = tcli.decode_image(data, model, device="cpu", si_image=b)
    jrec = np.asarray(jcli.decode_image(jdata, jparams, si_image=b))
    rec_of_j = tcli.decode_image(jdata, model, device="cpu", si_image=b)
    jrec_of_t = np.asarray(jcli.decode_image(data, jparams, si_image=b))
    assert rec.shape == a.shape and 0 <= rec.min() and rec.max() <= 1
    np.testing.assert_allclose(rec_of_j, jrec, rtol=0, atol=ATOL)
    np.testing.assert_allclose(jrec_of_t, rec, rtol=0, atol=ATOL)


def test_two_stage_file_matches_jax_and_cross_decodes(models):
    model, jparams, reg, jreg = models
    a, b = _pair(2)
    data = tcli.encode_composite(a, model, reg, device="cpu")
    # n=0: what the JAX CLI passes by default (the function's own default is 128)
    jdata = jcli.encode_composite(a, "tiny", jparams, "tiny_reg", jreg, n=0)
    near = _near_boundary(jparams, "tiny", a).any() or _near_boundary(jreg, "tiny_reg", a).any()
    if not near:
        assert data == jdata
    rec = tcli.decode_composite(data, model, reg, b, device="cpu")
    jrec = np.asarray(jcli.decode_composite(jdata, jparams, jreg, b))
    np.testing.assert_allclose(tcli.decode_composite(jdata, model, reg, b, device="cpu"), jrec,
                               rtol=0, atol=ATOL)
    np.testing.assert_allclose(np.asarray(jcli.decode_composite(data, jparams, jreg, b)), rec,
                               rtol=0, atol=ATOL)
    assert rec.shape == a.shape and 0 <= rec.min() and rec.max() <= 1
    with pytest.raises(ValueError, match="preset"):
        tcli.decode_composite(data, reg, model, b, device="cpu")


def test_stereo_and_two_stage_evals_match_jax(models):
    model, jparams, reg, jreg = models
    pairs = [_pair(10), _pair(11)]
    res = eval_stereo_dsc(model, pairs)
    jres = jax_eval_stereo(JaxModel(JAX_PRESETS["tiny"]), jparams, pairs)
    two = eval_reg_stage(model, reg, pairs)
    jtwo = jax_eval_reg_stage(JaxModel(JAX_PRESETS["tiny"]), jparams,
                              JaxModel(JAX_PRESETS["tiny_reg"]), jreg, pairs)
    for port, ref, rates in ((res, jres, ("bpp_rans", "bpp_gzip")),
                             (two, jtwo, ("bpp_rans", "bpp_gzip", "bpp_base", "bpp_reg"))):
        for k in rates:
            assert port[k] == ref[k], k
        assert abs(port["psnr"] - ref["psnr"]) <= 1e-3
        assert abs(port["ms_ssim"] - ref["ms_ssim"]) <= 1e-5
        assert abs(port["ms_ssim_db"] - ref["ms_ssim_db"]) <= 1e-3
        assert len(port["per_image"]) == 2


def test_stereo_pair_dataset_matches_jax(tmp_path):
    for side in ("left", "right"):
        os.makedirs(tmp_path / side)
    for i in range(3):
        a, b = _pair(20 + i, 70, 110)
        write_ppm(str(tmp_path / "left" / f"{i:02d}.ppm"), a)
        write_ppm(str(tmp_path / "right" / f"{i:02d}.ppm"), b)
    for kw in (dict(train=False, multiple=32), dict(train=True, crop=(32, 64), multiple=32),
               dict(train=True, crop=(96, 64), multiple=16)):
        ds = StereoPairDataset(str(tmp_path / "left"), str(tmp_path / "right"), **kw)
        jds = JaxStereoPairs(str(tmp_path / "left"), str(tmp_path / "right"), **kw)
        for epoch in (0, 1):
            ds.set_epoch(epoch)
            jds.set_epoch(epoch)
            for i in range(len(ds)):
                for x, y in zip(ds[i], jds[i]):
                    assert x.shape == y.shape and np.array_equal(x, y), (kw, epoch, i)


def test_dsc_entry_points_need_cuda_or_cpu(models, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the no-CUDA entry-point check does not apply")
    model, _, reg, _ = models
    path = str(tmp_path / "tiny.msgpack")
    with open(path, "wb") as f:
        f.write(msgpack_dumps(dsc_params_to_jax(model.state_dict(), model.config)))
    loaded = load_dsc(path, "tiny", device="cpu")
    assert all(torch.equal(x, y) for x, y in zip(loaded.state_dict().values(),
                                                 model.state_dict().values()))
    a, b = _pair(3)
    data = tcli.encode_image(a, model, device="cpu")
    for call in (lambda: load_dsc(path, "tiny"), lambda: tcli.encode_image(a, model),
                 lambda: tcli.decode_image(data, model, si_image=b),
                 lambda: tcli.encode_composite(a, model, reg),
                 lambda: tcli.decode_composite(data, model, reg, b)):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    with pytest.raises(ValueError, match="side-information"):
        tcli.decode_image(data, model, device="cpu")


def test_codec_cli_dsc_and_two_stage_commands(models, tmp_path):
    from PIL import Image

    model, _, reg, _ = models
    paths = {}
    for name, m in (("tiny", model), ("tiny_reg", reg)):
        paths[name] = str(tmp_path / f"{name}.msgpack")
        with open(paths[name], "wb") as f:
            f.write(msgpack_dumps(dsc_params_to_jax(m.state_dict(), m.config)))
    a, b = _pair(4)
    for name, img in (("left.png", a), ("right.png", b)):
        Image.fromarray(np.round(img * 255).astype(np.uint8)).save(tmp_path / name)
    left = np.asarray(Image.open(tmp_path / "left.png"), np.float32) / 255.0
    right = np.asarray(Image.open(tmp_path / "right.png"), np.float32) / 255.0
    cpu = ["--device", "cpu"]
    tcli.main(["encode", str(tmp_path / "left.png"), str(tmp_path / "a.icz"), "--model", "tiny",
               "--ckpt", paths["tiny"]] + cpu)
    tcli.main(["decode", str(tmp_path / "a.icz"), str(tmp_path / "a.png"), "--ckpt",
               paths["tiny"], "--si", str(tmp_path / "right.png")] + cpu)
    data = (tmp_path / "a.icz").read_bytes()
    assert data == tcli.encode_image(left, model, device="cpu")
    want = tcli.decode_image(data, model, device="cpu", si_image=right)
    got = np.asarray(Image.open(tmp_path / "a.png"), np.float32) / 255.0
    assert np.abs(got - want).max() <= 0.5 / 255 + 1e-6
    two = ["--reg-model", "tiny_reg", "--reg-ckpt", paths["tiny_reg"]]
    tcli.main(["encode", str(tmp_path / "left.png"), str(tmp_path / "b.icz"), "--model", "tiny",
               "--ckpt", paths["tiny"]] + two + cpu)
    tcli.main(["decode", str(tmp_path / "b.icz"), str(tmp_path / "b.png"), "--ckpt",
               paths["tiny"], "--si", str(tmp_path / "right.png")] + two + cpu)
    data = (tmp_path / "b.icz").read_bytes()
    assert data == tcli.encode_composite(left, model, reg, device="cpu")
    want = tcli.decode_composite(data, model, reg, right, device="cpu")
    got = np.asarray(Image.open(tmp_path / "b.png"), np.float32) / 255.0
    assert np.abs(got - want).max() <= 0.5 / 255 + 1e-6
