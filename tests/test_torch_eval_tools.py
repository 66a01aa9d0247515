"""Port parity: the evaluation and analysis tools (``eval/{ablation,mix,
similarity,rd_plot,metric_cli}.py``, ``utils/{analysis,svd,dataset_tools}.py``,
``data/datasets.py``'s ``write_png`` and ``StereoPlusDataset``) against the
JAX package's, on the CPU in fp32 with TF32 off.

Models: a Ballé-17 at N = 32 from the JAX init (``test_analysis_tools.py``'s
size) carried to the port by ``params_from_jax``; a DSC model of the ``tiny``
topology with a 4-channel code, the port's seeded init with every GDN off
the identity and the code spread over several symbols, carried to JAX by
``dsc_params_to_jax``. Images numpy-seeded. Stated tolerances:

- numpy-only tools (``utils/analysis``, ``utils/svd``, ``gzip_factor``,
  ``two_level_recon``, the JPEG bytes): equal results;
- reconstructions and latents: atol 1e-4 (fp32 convs in another order);
- PSNR 1e-3 dB, MS-SSIM / SSIM 1e-5; MSE sums and distances rtol 1e-4;
- the greedy channel order equal; statistics of rounded or binned latents
  (Hamming distance, entropies, histograms) within what one flipped element
  moves them, as written at each check;
- written PNGs: the port's and JAX's images (read by Pillow) within one
  level of 255 where the floats they came from differ by float error;
- the stereo-plus dataset: equal arrays.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import iclr_17_compression_tpu.eval as jeval
import iclr_17_compression_tpu.utils as jutils
from iclr_17_compression_tpu.data.datasets import StereoPlusDataset as JaxStereoPlus
from iclr_17_compression_tpu.eval import ablation as jablation
from iclr_17_compression_tpu.eval import metric_cli as jmetric_cli
from iclr_17_compression_tpu.eval import rd_plot as jrd_plot
from iclr_17_compression_tpu.models import Balle17Compressor as JaxBalle
from iclr_17_compression_tpu.models import DSC_PRESETS as JAX_PRESETS
from iclr_17_compression_tpu.models import DSCStereoModel as JaxDSC
from iclr_17_compression_tpu_torch import eval as teval
from iclr_17_compression_tpu_torch import utils as tutils
from iclr_17_compression_tpu_torch.data.datasets import StereoPlusDataset, _read_png, write_png
from iclr_17_compression_tpu_torch.eval import ablation, metric_cli, rd_plot
from iclr_17_compression_tpu_torch.models import Balle17Compressor
from iclr_17_compression_tpu_torch.models.dsc import DSC_PRESETS, DSCStereoModel
from iclr_17_compression_tpu_torch.nn.layers import GDN
from iclr_17_compression_tpu_torch.train.weights import dsc_params_to_jax, params_from_jax

ATOL = 1e-4
PSNR_DB = 1e-3
MS_SSIM = 1e-5
RTOL = 1e-4
H, W = 64, 96
TINY4 = dict(code_channels=4,
             ga22=(("conv3", 8, 1), ("rbs", 8, 2), ("conv3", 4, 1)))


@pytest.fixture(autouse=True, scope="module")
def _one_thread_fp32():
    """fp32 without TF32, and one intra-op thread: at these sizes it is
    faster than many, and the test workers do not oversubscribe the cores."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _img(seed, h=H, w=W):
    """A smooth HWC image in [0, 1] with some texture."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    a = np.full((h, w, 3), 0.5, np.float32)
    for _ in range(4):
        f = rng.uniform(-3, 3, 2) / np.array([h, w])
        a += rng.uniform(0.05, 0.15, 3).astype(np.float32) * np.cos(
            2 * np.pi * (f[0] * yy + f[1] * xx) + rng.uniform(0, 6))[..., None]
    return np.clip(a + 0.05 * rng.standard_normal((h, w, 3)).astype(np.float32), 0, 1)


def _pair(seed):
    a = _img(seed)
    b = np.clip(np.roll(a, 3, axis=1) * 0.97 + 0.02, 0, 1).astype(np.float32)
    return a, b


def _balle(seed):
    """(port model, JAX params) of a Ballé-17 at N = 32 from the JAX init."""
    jm = JaxBalle(out_channel_n=32)
    key = jax.random.PRNGKey(seed)
    params = jm.init({"params": key, "quant": key}, jnp.zeros((1, 64, 64, 3)), train=False)
    model = Balle17Compressor(32)
    model.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, params)))
    return model.eval(), params


@pytest.fixture(scope="module")
def balle():
    return JaxBalle(out_channel_n=32), _balle(0), _balle(9)


@pytest.fixture(scope="module")
def dsc():
    cfg = dataclasses.replace(DSC_PRESETS["tiny"], name="tiny4", **TINY4)
    jcfg = dataclasses.replace(JAX_PRESETS["tiny"], name="tiny4", **TINY4)
    gen = torch.Generator().manual_seed(3)
    model = DSCStereoModel(cfg).init_(gen).eval()
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, GDN):
                c = m.beta.shape[0]
                m.beta.copy_(0.7 + 0.6 * torch.rand(c, generator=gen))
                m.gamma.copy_(0.3 * torch.eye(c) + 0.1 * torch.rand((c, c), generator=gen))
        last = model.g_a22[2]
        scale = 24.0 / float(model.encode(torch.from_numpy(_img(0)[None])).std())
        last.weight.mul_(scale)
        last.bias.mul_(scale)
    jparams = {"params": jax.tree_util.tree_map(
        jnp.asarray, dsc_params_to_jax(model.state_dict(), cfg))}
    return model, JaxDSC(jcfg), jparams


def test_analysis_and_svd_equal_jax():
    rng = np.random.default_rng(0)
    z1 = rng.standard_normal((6, 8, 16)).astype(np.float32)
    z2 = (z1 + 0.3 * rng.standard_normal(z1.shape)).astype(np.float32)
    for bins in (16, 100):
        assert tutils.conditional_entropy(z1, z2, bins) == jutils.conditional_entropy(
            z1, z2, bins)
        assert tutils.uncertainty_coefficient(z1, z2, bins) == \
            jutils.uncertainty_coefficient(z1, z2, bins)
    assert tutils.uncertainty_coefficient(z1, z1) == pytest.approx(1.0, abs=1e-12)
    code = (np.round(rng.random((1, 4, 8, 8)) * 8 - 4) * 16).astype(np.float32)
    for rank in (1, 3, 8):
        np.testing.assert_array_equal(tutils.low_rank_code(code, rank),
                                      jutils.low_rank_code(code, rank))
        for a, b in zip(tutils.decompose_top_i(code, rank), jutils.decompose_top_i(code, rank)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    np.testing.assert_array_equal(tutils.low_rank_code(code, 8), code)  # full rank, on the grid
    assert tutils.rank_rate_bits((4, 8, 8), 2) == jutils.rank_rate_bits((4, 8, 8), 2)


def test_ablations_match_jax(dsc):
    model, jm, jparams = dsc
    pairs = [_pair(1), _pair(2)]
    # the greedy search: the first step's masked MSEs, then the order
    mses = ablation.masked_mses(model, pairs, [])

    @jax.jit
    def jax_mse(im1, im2, mask):
        return jnp.mean((jm.apply(jparams, im1, im2, train=False, mask_channels=mask)["recon"]
                         - im1) ** 2)

    for ch, total in mses.items():
        mask = jnp.zeros((4,)).at[ch].set(1.0)
        ref = sum(float(jax_mse(jnp.asarray(a)[None], jnp.asarray(b)[None], mask))
                  for a, b in pairs)
        assert total == pytest.approx(ref, rel=RTOL), ch
    assert len(set(np.round(list(mses.values()), 6))) == 4  # no tie decides the order
    chosen = ablation.greedy_channel_mask_search(model, pairs, 2)
    assert chosen == jablation.greedy_channel_mask_search(jm, jparams, pairs, 2)
    assert chosen[0] == min(mses, key=mses.get)

    a, b = pairs[0]
    np.testing.assert_allclose(ablation.si_only_recon(model, b),
                               jablation.si_only_recon(jm, jparams, b), rtol=0, atol=ATOL)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    co = ablation.code_only_recon(model, a)
    np.testing.assert_allclose(co, jablation.code_only_recon(jm, jparams, a), rtol=0, atol=ATOL)
    # the caller's model is as it was: its config, its tensors
    assert model.config.si_mode == "use"
    assert all(torch.equal(v, before[k]) for k, v in model.state_dict().items())
    ablated = ablation.zero_si_model(model)
    assert ablated.config.si_mode == "zero_si" and not ablated.training
    assert all(p.data_ptr() == q.data_ptr() for p, q in zip(ablated.parameters(),
                                                             model.parameters()))
    with torch.no_grad():
        full = model(torch.from_numpy(a[None]), torch.from_numpy(b[None]))["recon"][0].numpy()
    assert np.abs(full - co).max() > 1e-3  # zeroing the SI changed the recon

    def codec(diff):  # a lossy stand-in for the diff image's codec
        return np.round(diff * 32.0) / 32.0

    np.testing.assert_array_equal(ablation.two_level_recon(full, a, codec),
                                  jablation.two_level_recon(full, a, codec))


def test_mix_and_average_match_jax(balle, tmp_path):
    jm, (model_a, pa), (model_b, pb) = balle
    imgs = [_img(10 + i, 64, 64) for i in range(3)]
    mixed_sd = teval.mix_encoder_decoder(model_a.state_dict(), model_b.state_dict())
    assert all(torch.equal(mixed_sd[k], (model_a if k.startswith("Encoder.") else model_b)
                           .state_dict()[k]) for k in mixed_sd)
    with pytest.raises(KeyError, match="Encoder"):
        teval.mix_encoder_decoder(model_b.state_dict(), model_a.state_dict(),
                                  encoder_keys=("encoder",))
    mixed = Balle17Compressor(32)
    mixed.load_state_dict(mixed_sd)
    res = teval.eval_single_image(mixed.eval(), imgs, dump_dir=str(tmp_path / "port"))
    ref = jeval.eval_single_image(jm, jeval.mix_encoder_decoder(pa, pb), imgs,
                                  dump_dir=str(tmp_path / "jax"))
    assert abs(res["psnr"] - ref["psnr"]) <= PSNR_DB
    assert abs(res["ms_ssim"] - ref["ms_ssim"]) <= MS_SSIM
    assert res["best"]["index"] == ref["best"]["index"]
    assert res["worst"]["index"] == ref["worst"]["index"]
    assert abs(res["best"]["psnr"] - ref["best"]["psnr"]) <= PSNR_DB
    names = sorted(os.listdir(tmp_path / "jax"))
    assert sorted(os.listdir(tmp_path / "port")) == names and len(names) == 4
    for name in names:
        ours = np.asarray(Image.open(tmp_path / "port" / name), np.int16)
        theirs = np.asarray(Image.open(tmp_path / "jax" / name), np.int16)
        assert ours.shape == theirs.shape and np.abs(ours - theirs).max() <= 1, name

    avg = teval.average_two_models(model_a, model_b, imgs)
    jref = jeval.average_two_models(jm, pa, pb, imgs)
    assert abs(avg["psnr"] - jref["psnr"]) <= PSNR_DB
    assert abs(avg["ms_ssim"] - jref["ms_ssim"]) <= MS_SSIM
    same = teval.average_two_models(model_a, model_a, imgs)
    single = teval.eval_single_image(model_a, imgs)
    assert same["psnr"] == single["psnr"] and same["ms_ssim"] == single["ms_ssim"]


def test_similarity_matches_jax(dsc, balle, tmp_path):
    model, jm, jparams = dsc
    pairs = [_pair(3), _pair(4)]
    res = teval.encoder_similarity(model, pairs, dump_channels_dir=str(tmp_path / "port"))
    ref = jeval.encoder_similarity(jm, jparams, pairs, dump_channels_dir=str(tmp_path / "jax"))
    n_el = 2 * 16 * (H // 16) * (W // 16)  # z1 elements over both pairs (n = 16, ÷16)
    assert abs(res["normalized_hamming"] - ref["normalized_hamming"]) <= 2.0 / n_el
    for k in ("code_min", "code_max"):
        assert res[k] == pytest.approx(ref[k], abs=ATOL), k
    # histograms of 100 bins: an element within float error of a bin edge
    # may move a bin; entropies by at most a few 1e-3 bits
    for k in ("uncertainty_coefficient", "conditional_entropy"):
        assert res[k] == pytest.approx(ref[k], abs=5e-3), k
    assert res["n_pairs"] == 2
    names = sorted(os.listdir(tmp_path / "jax"))
    assert sorted(os.listdir(tmp_path / "port")) == names and len(names) == 16
    for name in names:
        ours = np.asarray(Image.open(tmp_path / "port" / name), np.int16)
        theirs = np.asarray(Image.open(tmp_path / "jax" / name), np.int16)
        assert ours.shape == theirs.shape and np.abs(ours - theirs).max() <= 1, name
    same = teval.encoder_similarity(model, [(pairs[0][0], pairs[0][0])])
    assert same["normalized_hamming"] == 0.0
    assert same["uncertainty_coefficient"] == pytest.approx(1.0, abs=1e-6)

    dist = teval.encoder_distances(model, pairs)
    jdist = jeval.encoder_distances(jm, jparams, pairs)
    for k in ("latent_l1", "latent_l2"):
        assert dist[k] == pytest.approx(jdist[k], rel=RTOL), k

    jb, (model_a, pa), _ = balle
    imgs = [_img(20 + i, 64, 64) for i in range(2)]
    cd = teval.code_distribution(model_a, imgs)
    jcd = jeval.code_distribution(jb, pa, imgs)
    np.testing.assert_allclose(cd["per_channel_variance"], jcd["per_channel_variance"],
                               rtol=RTOL, atol=1e-6)
    np.testing.assert_allclose(cd["bin_edges"], jcd["bin_edges"], rtol=0, atol=ATOL)
    assert cd["histogram"].sum() == jcd["histogram"].sum() == 2 * 4 * 4 * 32
    assert np.abs(cd["histogram"] - jcd["histogram"]).sum() <= 4  # edge flips only
    assert cd["gzip_factor"] == pytest.approx(jcd["gzip_factor"], rel=0.02)
    code = np.round(np.random.default_rng(1).standard_normal(4096) * 5)
    for binary in (False, True):
        assert teval.gzip_factor(code, binary) == jeval.gzip_factor(code, binary)


def test_rd_plot_matches_jax(tmp_path):
    imgs = [_img(30), _img(31)]
    for img in imgs:
        bpp, dec = rd_plot.jpeg_anchor_point(img, 40)
        jbpp, jdec = jrd_plot.jpeg_anchor_point(img, 40)
        assert bpp == jbpp
        np.testing.assert_array_equal(dec, jdec)
    curve = rd_plot.jpeg_anchor_curve(imgs, qualities=(10, 75), device="cpu")
    jcurve = jrd_plot.jpeg_anchor_curve(imgs, qualities=(10, 75))
    for p, q in zip(curve, jcurve):
        assert p["quality"] == q["quality"] and p["bpp"] == q["bpp"]
        assert abs(p["psnr"] - q["psnr"]) <= PSNR_DB
        for k in ("ssim", "ms_ssim"):
            assert abs(p[k] - q[k]) <= MS_SSIM, k
    assert rd_plot.lstm_bpp(16) == jrd_plot.lstm_bpp(16) == 2.0
    out = rd_plot.plot_rd({"JPEG": [(p["bpp"], p["psnr"]) for p in curve]},
                          str(tmp_path / "plot" / "rd.png"), ylabel="PSNR (dB)")
    assert Image.open(out).size[0] > 0


def test_metric_cli_matches_jax(tmp_path, capsys):
    for side in ("o", "c"):
        os.makedirs(tmp_path / side)
    for i in range(2):
        a = _img(40 + i, 80, 96)
        b = np.clip(a + 0.03 * np.random.default_rng(i).standard_normal(a.shape), 0, 1)
        write_png(str(tmp_path / "o" / f"{i}.png"), np.rint(a * 255).astype(np.uint8))
        write_png(str(tmp_path / "c" / f"{i}.png"), np.rint(b * 255).astype(np.uint8))
    argv = ["-m", "both", "-o", str(tmp_path / "o"), "-c", str(tmp_path / "c")]
    rows = metric_cli.main(argv + ["--device", "cpu"])
    ours = capsys.readouterr().out.split()
    jmetric_cli.main(argv)
    theirs = capsys.readouterr().out.split()
    assert len(rows) == 2 and len(ours) == len(theirs) == 8
    for x, y in zip(ours, theirs):
        if "=" not in x:
            assert x == y
            continue
        (kx, vx), (ky, vy) = x.split("="), y.split("=")
        assert kx == ky and abs(float(vx) - float(vy)) <= (PSNR_DB if "psnr" in kx
                                                            else 2e-6), (x, y)


def test_png_writer_reads_back(tmp_path):
    rng = np.random.default_rng(5)
    rgb = rng.integers(0, 256, (17, 23, 3), dtype=np.uint8)
    gray = rng.integers(0, 256, (9, 31), dtype=np.uint8)
    for name, arr in (("rgb.png", rgb), ("gray.png", gray)):
        write_png(str(tmp_path / name), arr)
        np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / name)), arr)
        with open(tmp_path / name, "rb") as f:
            back = _read_png(f.read())
        np.testing.assert_array_equal(back, arr if arr.ndim == 3 else np.repeat(
            arr[..., None], 3, axis=2))
    with pytest.raises(ValueError, match="uint8"):
        write_png(str(tmp_path / "bad.png"), rgb.astype(np.float32))


def test_dataset_tools_match_jax(balle, dsc, tmp_path):
    src = tmp_path / "src"
    src.mkdir()
    rng = np.random.default_rng(6)
    for i, hw in enumerate(((64, 80), (64, 80), (48, 64))):
        Image.fromarray((_img(50 + i, *hw) * 255).astype(np.uint8)).save(src / f"im{i}.png")
    Image.fromarray((rng.random((40, 72, 3)) * 255).astype(np.uint8)).save(src / "im3.jpg")
    Image.fromarray((rng.random((56, 48, 3)) * 255).astype(np.uint8)).save(src / "im4.ppm")
    (src / "notes.txt").write_text("not an image")
    assert tutils.check_image_sizes(str(src)) == jutils.check_image_sizes(str(src))

    jb, (model_a, pa), _ = balle
    for sub in ("port", "jax"):
        os.makedirs(tmp_path / sub)
    written = tutils.create_diff_folder(model_a, str(src), str(tmp_path / "port" / "diff"))
    jwritten = jutils.create_diff_folder(jb, pa, str(src), str(tmp_path / "jax" / "diff"))
    assert [os.path.splitext(os.path.basename(p))[0] for p in written] == \
        [os.path.splitext(os.path.basename(p))[0] for p in jwritten]
    assert [os.path.basename(p) for p in written if p.endswith("im0.png")] == ["im0.png"]
    for p, q in zip(written, jwritten):
        ours = np.asarray(Image.open(p), np.int16)
        theirs = np.asarray(Image.open(q).convert("RGB"), np.int16)
        if q.endswith(".png"):  # JAX writes a lossless file only under a .png name
            assert np.abs(ours - theirs).max() <= 1, p
        assert ours.shape == theirs.shape and ours.dtype == np.int16

    model, jm, jparams = dsc
    pairs = [_pair(7)]
    dumped = tutils.save_both_direction_recons(model, pairs, str(tmp_path / "port" / "bd"))
    jdumped = jutils.save_both_direction_recons(jm, jparams, pairs, str(tmp_path / "jax" / "bd"))
    assert [os.path.basename(p) for p in dumped] == [os.path.basename(p) for p in jdumped]
    for p, q in zip(dumped, jdumped):
        with open(p, "rb") as f:
            ours = _read_png(f.read()).astype(np.int16)
        assert np.abs(ours - np.asarray(Image.open(q), np.int16)).max() <= 1, p

    base = (rng.random((128, 160, 3)) * 255).astype(np.uint8)
    rp, sp = str(tmp_path / "recon.png"), str(tmp_path / "SI.png")
    Image.fromarray(base).save(rp)
    Image.fromarray(np.roll(base, (4, 6), axis=(0, 1))).save(sp)
    out = tutils.warp_side_information(rp, sp, str(tmp_path / "warped_port.png"))
    jout = jutils.warp_side_information(rp, sp, str(tmp_path / "warped_jax.png"))
    assert (out is None) == (jout is None)
    if out is not None:
        np.testing.assert_array_equal(np.asarray(Image.open(out)), np.asarray(Image.open(jout)))


def test_stereo_plus_dataset_matches_jax(tmp_path):
    for sub in ("left", "right", "contrast"):
        os.makedirs(tmp_path / sub)
    for i in range(3):
        a, b = _pair(60 + i)
        write_png(str(tmp_path / "left" / f"{i:02d}.png"), (a * 255).astype(np.uint8))
        write_png(str(tmp_path / "right" / f"{i:02d}.png"), (b * 255).astype(np.uint8))
    for i in range(2):
        write_png(str(tmp_path / "contrast" / f"c{i}.png"),
                  (_img(70 + i, 50, 70) * 255).astype(np.uint8))
    dirs = [str(tmp_path / s) for s in ("left", "right", "contrast")]
    for kw in (dict(), dict(random_crop=True, crop=(48, 64), contrast_size=40),
               dict(random_crop=True, crop=(80, 112), contrast_size=32)):
        ds, jds = StereoPlusDataset(*dirs, **kw), JaxStereoPlus(*dirs, **kw)
        assert len(ds) == len(jds) == 3
        for epoch in (0, 1):
            ds.set_epoch(epoch)
            jds.set_epoch(epoch)
            for i in range(3):
                for x, y in zip(ds[i], jds[i]):
                    np.testing.assert_array_equal(x, y)
