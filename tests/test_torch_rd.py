"""Port parity: the R-D entry points (``eval/kodak.py`` and ``eval/stereo.py``
``main``) and the reference ``.pth`` loader (``train/weights.py``
``load_torch_state_dict``, through the codec CLI, ``load_balle17`` and
``load_dsc``) against the JAX package, on the CPU in fp32.

Weights: the archived ``lam2048_iter_19000.ckpt``; the port's seeded init of
a Ballé-17 (N = 32), the ``tiny`` / ``tiny_reg`` DSC presets (GDNs off the
identity, the code spread over several symbols) and a hyperprior (16 / 24)
and joint-AR (16) model, written as reference ``.pth`` files. Images
numpy-seeded. Stated tolerances:

- Ballé eval of the archived weights: per image the same rANS bytes (the
  same symbols, the same stream), PSNR within 1e-3 dB, MS-SSIM 1e-5, the
  estimated bpp rtol 1e-5;
- the SI-only column: PSNR within 1e-3 dB, MS-SSIM 1e-5 of the archive
  script's computation (the SI image as both eyes, against the left);
- a ``.pth`` loaded into the port gives the source model's outputs bit for
  bit; loaded into JAX through ``torch_import``, its outputs within atol
  1e-4 of the port's (fp32 convs in another order).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iclr_17_compression_tpu.coding import codec_cli as jcli
from iclr_17_compression_tpu.eval.kodak import eval_kodak as jax_eval_kodak
from iclr_17_compression_tpu.models import Balle17Compressor as JaxBalle
from iclr_17_compression_tpu.models import DSC_PRESETS as JAX_PRESETS
from iclr_17_compression_tpu.models import DSCStereoModel as JaxDSC
from iclr_17_compression_tpu.ops.metrics import ms_ssim as jax_ms_ssim
from iclr_17_compression_tpu.train import torch_import
from iclr_17_compression_tpu_torch.coding import api as tapi
from iclr_17_compression_tpu_torch.coding import codec_cli as tcli
from iclr_17_compression_tpu_torch.data.datasets import write_png
from iclr_17_compression_tpu_torch.eval import kodak, stereo
from iclr_17_compression_tpu_torch.models import Balle17Compressor
from iclr_17_compression_tpu_torch.models.dsc import DSC_PRESETS, DSCStereoModel
from iclr_17_compression_tpu_torch.nn.layers import GDN
from iclr_17_compression_tpu_torch.train.checkpoint import save_train_state
from iclr_17_compression_tpu_torch.train.weights import (dsc_params_to_jax, load_balle17,
                                                         load_dsc, load_torch_state_dict,
                                                         msgpack_dumps, read_checkpoint)

LAM2048 = os.path.join(os.path.dirname(__file__), "..", "results", "ckpts",
                       "lam2048_iter_19000.ckpt")
PSNR_DB, MS_SSIM, ATOL = 1e-3, 1e-5, 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_thread_fp32():
    """fp32 without TF32, and one intra-op thread (faster at these sizes;
    no oversubscription under the test workers)."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _img(seed, h, w):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    a = np.full((h, w, 3), 0.5, np.float32)
    for _ in range(4):
        f = rng.uniform(-3, 3, 2) / np.array([h, w])
        a += rng.uniform(0.05, 0.15, 3).astype(np.float32) * np.cos(
            2 * np.pi * (f[0] * yy + f[1] * xx) + rng.uniform(0, 6))[..., None]
    return np.clip(a + 0.04 * rng.standard_normal((h, w, 3)).astype(np.float32), 0, 1)


def _u8(img):
    return np.rint(img * 255).astype(np.uint8)


def test_archived_balle_eval_matches_jax():
    images = [_img(0, 64, 96), _img(1, 80, 64)]
    model = load_balle17(LAM2048, device="cpu")
    jm = JaxBalle(out_channel_n=128)
    jparams = {"params": jax.tree_util.tree_map(jnp.asarray, read_checkpoint(LAM2048))}
    res = kodak.eval_kodak(model, images, use_rans=True)
    jres = jax_eval_kodak(jm, jparams, images, use_rans=True)
    jest = jax_eval_kodak(jm, jparams, images)
    lo, hi = res["rans_bounds"]
    codec = tapi.build_cdf_tables_from_bit_estimator(model.bitEstimator.params(), lo, hi)
    for img, row, jrow in zip(images, res["per_image"], jres["per_image"]):
        x = torch.from_numpy(img[None])
        with torch.no_grad():
            sym = torch.round(model(x)["latent"][0]).numpy().astype(np.int64)
        jsym = np.asarray(jnp.round(jm.apply(jparams, jnp.asarray(img)[None],
                                             train=False)["latent"][0])).astype(np.int64)
        np.testing.assert_array_equal(sym, jsym)
        assert row["bpp"] == jrow["bpp"] == len(tapi.encode_latent(codec, sym)) * 8.0 / (
            img.shape[0] * img.shape[1])
        assert abs(row["psnr"] - jrow["psnr"]) <= PSNR_DB
        assert abs(row["ms_ssim"] - jrow["ms_ssim"]) <= MS_SSIM
    assert res["bpp_estimated"] == pytest.approx(jest["bpp"], rel=1e-5)
    assert lo <= 0 <= hi and hi - lo > 2


def test_kodak_main_layout(tmp_path):
    data = tmp_path / "eval"
    data.mkdir()
    images = [_img(10, 64, 96), _img(11, 72, 80)]  # the second floors to 64×80
    for i, img in enumerate(images):
        write_png(str(data / f"eval{i:02d}.png"), _u8(img))
    out = tmp_path / "rd.json"
    res = kodak.main(["--data", str(data), "--ckpt", LAM2048, "--device", "cpu",
                      "--out", str(out)])
    assert json.loads(out.read_text())["points"][0]["bpp_rans"] == res["points"][0]["bpp_rans"]
    (pt,) = res["points"]
    assert pt["name"] == "lam2048" and pt["n"] == 128 and res["files"] == [
        "eval00.png", "eval01.png"]
    model = load_balle17(LAM2048, device="cpu")
    loaded = [np.rint(im * 255) / 255 for im in (images[0], images[1][4:68])]
    ref = kodak.eval_kodak(model, [im.astype(np.float32) for im in loaded], use_rans=True)
    assert pt["bpp_rans"] == ref["bpp"] and pt["psnr"] == ref["psnr"]
    assert [r["image"] for r in pt["per_image"]] == res["files"]
    assert pt["latent_range"] == list(ref["rans_bounds"])
    assert set(pt["gap"]) == {"bpp_rans_rel", "psnr_db", "ms_ssim"}
    assert pt["archived"]["bpp_rans"] == pytest.approx(0.7513067914853201)
    assert [p["quality"] for p in res["jpeg_anchor"]] == list(range(5, 101, 5))
    assert res["device"] == "cpu"


def _dsc(preset, seed, spread=12.0):
    """The port's seeded init of a DSC preset, GDNs off the identity and
    the code spread to about ``spread`` std."""
    gen = torch.Generator().manual_seed(seed)
    model = DSCStereoModel(DSC_PRESETS[preset]).init_(gen).eval()
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, GDN):
                c = m.beta.shape[0]
                m.beta.copy_(0.7 + 0.6 * torch.rand(c, generator=gen))
                m.gamma.copy_(0.3 * torch.eye(c) + 0.1 * torch.rand((c, c), generator=gen))
        last = model.g_a22[2]
        scale = spread / float(model.encode(torch.from_numpy(_img(0, 64, 96)[None])).std())
        last.weight.mul_(scale)
        last.bias.mul_(scale)
    return model


def test_stereo_main_si_only_column_and_optional_reg(tmp_path):
    root = tmp_path / "root"
    pairs = []
    for side in ("left", "right"):
        os.makedirs(root / "stereo_eval" / side)
    for i in range(2):
        a = _img(20 + i, 128, 192)
        b = np.clip(0.5 * np.roll(a, 8, axis=1) + 0.5 * _img(40 + i, 128, 192), 0, 1)
        write_png(str(root / "stereo_eval" / "left" / f"{i:02d}.png"), _u8(a))
        write_png(str(root / "stereo_eval" / "right" / f"{i:02d}.png"), _u8(b))
        pairs.append((_u8(a).astype(np.float32) / 255, _u8(b).astype(np.float32) / 255))
    paths = {}
    for preset, seed in (("tiny", 0), ("tiny_reg", 1)):
        model = _dsc(preset, seed)
        paths[preset] = str(tmp_path / f"{preset}.msgpack")
        with open(paths[preset], "wb") as f:
            f.write(msgpack_dumps(dsc_params_to_jax(model.state_dict(), model.config)))
    argv = ["--data", str(root), "--ckpt", paths["tiny"], "--preset", "tiny", "--device", "cpu"]
    res = stereo.main(argv)
    (pt,) = res["points"]
    assert set(res["per_image"]) == {"si_assisted", "code_only"}
    # the archive script's SI-only point (tools/rd_experiment_dsc.py): the
    # right image as both eyes, scored against the left
    jm = JaxDSC(JAX_PRESETS["tiny"])
    jparams = {"params": jax.tree_util.tree_map(jnp.asarray, read_checkpoint(paths["tiny"]))}
    fwd = jax.jit(lambda im1, im2: jm.apply(jparams, im2, im2, train=False)["recon"])
    psnrs, mss = [], []
    for a, b in pairs:
        im1, im2 = jnp.asarray(a)[None], jnp.asarray(b)[None]
        recon = fwd(im1, im2)
        psnrs.append(10.0 * np.log10(1.0 / max(float(jnp.mean((recon - im1) ** 2)), 1e-12)))
        mss.append(float(jax_ms_ssim(recon, im1, win_size=7)))
    assert abs(pt["si_only_0bpp"]["psnr"] - np.mean(psnrs)) <= PSNR_DB
    assert abs(pt["si_only_0bpp"]["ms_ssim"] - np.mean(mss)) <= MS_SSIM
    assert pt["si_only_0bpp"]["psnr"] != pt["si_assisted"]["psnr"]

    two = stereo.main(argv + ["--reg-ckpt", paths["tiny_reg"], "--reg-preset", "tiny_reg"])
    assert [p["preset"] for p in two["points"]] == ["tiny", "tiny+tiny_reg"]
    assert two["points"][1]["kind"] == "two_stage" and "two_stage" in two["per_image"]
    assert two["points"][0] == pt


# spec → (n, m) of the seeded source model
PTH_SPECS = {"balle17": (32, 0), "tiny": (0, 0), "hyperprior": (16, 24), "joint": (16, 0)}


def _source(spec):
    n, m = PTH_SPECS[spec]
    if spec in DSC_PRESETS:
        return _dsc(spec, 5)
    _, model, _ = tcli.build_model(spec, n, m)
    return model.init_(torch.Generator().manual_seed(5)).eval()


def _jax_params_from_pth(spec, jm, path):
    """``jcli.load_params``' reference-``.pth`` route (``torch_import``'s
    import of the file merged over a template of the model's params), with
    a template of shapes alone (``jax.eval_shape``) where the CLI initialises
    one eagerly, in a minute on the CPU. A leaf the import misses (joint's
    ``bit_estimator_z``, which the recon does not read) is zeros: one the
    recon reads would differ from the port's, which loads every key."""
    n, m = PTH_SPECS[spec]
    _, _, mult = jcli.build_model(spec, n, m)
    dummy = jnp.zeros((1, 2 * mult, 2 * mult, 3), jnp.float32)
    rng = jax.random.PRNGKey(0)
    args = (dummy, dummy) if spec in DSC_PRESETS else (dummy,)
    template = jax.eval_shape(
        lambda *a: jm.init({"params": rng, "quant": rng}, *a, train=False), *args)
    sd = torch_import.load_torch_state_dict(path)
    imported = {"balle17": torch_import.import_balle17, "joint": torch_import.import_joint,
                "hyperprior": torch_import.import_hyperprior}.get(
                    spec, lambda d: torch_import.import_dsc(d, jm.config))(sd)
    merged = torch_import.merge_partial(template["params"], imported)
    return {"params": jax.tree_util.tree_map(
        lambda v: jnp.zeros(v.shape, v.dtype) if isinstance(v, jax.ShapeDtypeStruct) else v,
        merged)}


def _outputs(model, x, y):
    with torch.no_grad():
        out = model(x, y) if isinstance(model, DSCStereoModel) else model(x)
    return out["recon"]


@pytest.mark.parametrize("spec", sorted(PTH_SPECS))
def test_reference_pth_loads_as_torch_import(spec, tmp_path):
    n, m = PTH_SPECS[spec]
    source = _source(spec)
    sd = source.state_dict()
    bare, wrapped = str(tmp_path / "ref.pth"), str(tmp_path / "ref.pth.tar")
    torch.save(sd, bare)
    torch.save({"epoch": 3, "model_state_dict": sd}, wrapped)
    x = torch.from_numpy(_img(30, 64, 128)[None])
    y = torch.from_numpy(_img(31, 64, 128)[None])
    want = _outputs(source, x, y)
    loaders = [lambda p: tcli._load_model(spec, p, "cpu", n, m)]
    if spec == "balle17":
        loaders.append(lambda p: load_balle17(p, device="cpu"))
    elif spec == "tiny":
        loaders.append(lambda p: load_dsc(p, spec, device="cpu"))
    for path in (bare, wrapped):
        for load in loaders:
            assert torch.equal(_outputs(load(path), x, y), want), path
    _, jm, _ = jcli.build_model(spec, n, m)
    jparams = _jax_params_from_pth(spec, jm, bare)
    args = (jnp.asarray(x.numpy()),) + ((jnp.asarray(y.numpy()),) if spec == "tiny" else ())
    jout = np.asarray(jax.jit(lambda *a: jm.apply(jparams, *a, train=False)["recon"])(*args))
    np.testing.assert_allclose(want.numpy(), jout, rtol=0, atol=ATOL)


def test_reference_pth_partial_load_shape_mismatch_and_train_state(tmp_path):
    source = _source("balle17")
    target = Balle17Compressor(32).init_(torch.Generator().manual_seed(6))
    before = {k: v.clone() for k, v in target.state_dict().items()}
    partial = {k: v for k, v in source.state_dict().items() if not k.startswith("Decoder.")}
    partial["unknown.weight"] = torch.ones(3)
    path = str(tmp_path / "partial.pth")
    torch.save(partial, path)
    load_torch_state_dict(target, path)
    for k, v in target.state_dict().items():
        assert torch.equal(v, source.state_dict()[k] if k in partial else before[k]), k
    assert any(not torch.equal(before[k], source.state_dict()[k]) for k in before
               if k.startswith("Decoder."))
    # JAX's partial load takes the same file
    kind, jm, _ = jcli.build_model("balle17", 32)
    jparams = jcli.load_params(kind, jm, "balle17", path)
    np.testing.assert_array_equal(
        np.asarray(jparams["params"]["encoder"]["conv1"]["weight"]),
        source.Encoder.conv1.weight.detach().permute(2, 3, 1, 0).numpy())

    wide = str(tmp_path / "wide.pth")
    torch.save(Balle17Compressor(48).state_dict(), wide)
    with pytest.raises(ValueError, match="shape mismatch"):
        load_torch_state_dict(Balle17Compressor(32), wide)
    with pytest.raises(ValueError, match="shape mismatch"):
        jcli.load_params(kind, jm, "balle17", wide)

    # the port's own train-state file (a torch.save zip too) keeps its path
    dsc = _dsc("tiny", 7)
    state = save_train_state({"model": dsc.state_dict(), "optimizer": {}, "step": 0},
                             str(tmp_path), "best_train")
    x = torch.from_numpy(_img(32, 64, 96)[None])
    for loaded in (load_dsc(state, "tiny", device="cpu"),
                   tcli._load_model("tiny", state, "cpu")):
        assert torch.equal(_outputs(loaded, x, x), _outputs(dsc, x, x))
