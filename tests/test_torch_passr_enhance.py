"""Port parity: PASSRnet (``ResASPPB``, ``PASSRnet``, ``passr_losses``), the
enhancement nets (``FIFEnhance``, ``FinalEnhanceNet``), their loaders
(``StereoPassrDataset``, ``FIFEnhanceDataset``) and evals (``eval_passr``,
``eval_enhance``) against the JAX package on the CPU in fp32.

Weights: the port's seeded ``init_`` (FIFEnhance's adaptive BatchNorms
moved off their init) carried to JAX through the JAX package's importers
(``import_passr``, ``import_final_enhance``) and the port's
``model_params_to_jax``, which give the same trees. Widths: PASSRnet at 16
channels on 2 pairs of 24×32 (and 16×24 at ×2), FinalEnhanceNet and
FIFEnhance at 16 features. Stated tolerances: every module output rtol 1e-5
and atol 1e-4 of its largest |value| (FIFEnhance's running statistics
too), PAM's validity masks exact, the losses rtol 1e-4, the gradients
rtol 1e-4 and atol 1e-4 of the tensor's largest (at least 1e-5 of the
largest of all), the loaders' crops bit-equal, the evals' rows rtol 1e-4.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from iclr_17_compression_tpu.data import datasets as jdata
from iclr_17_compression_tpu.eval.enhance import eval_enhance as jeval_enhance
from iclr_17_compression_tpu.eval.passr import eval_passr as jeval_passr
from iclr_17_compression_tpu.models import enhance as jenh
from iclr_17_compression_tpu.models import passr as jpassr
from iclr_17_compression_tpu.train.torch_import import import_final_enhance, import_passr
from iclr_17_compression_tpu_torch.data import datasets as tdata
from iclr_17_compression_tpu_torch.eval.enhance import eval_enhance
from iclr_17_compression_tpu_torch.eval.passr import eval_passr
from iclr_17_compression_tpu_torch.models import enhance as tenh
from iclr_17_compression_tpu_torch.models import passr as tpassr
from iclr_17_compression_tpu_torch.train import weights as tw
from test_torch_dsc_trainers import kitti  # noqa: F401 (fixture)
from test_torch_extra import _flat
from test_torch_fusion import _perturb_abn_

RTOL, ATOL, LOSS_RTOL = 1e-5, 1e-4, 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the test workers do not oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _close(got, want, what=""):
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=ATOL * max(1.0, float(np.abs(want).max(initial=0.0))),
                               err_msg=what)


def _same_tree(a, b):
    fa, fb = _flat(a), _flat(b)
    assert fa.keys() == fb.keys()
    for k in fa:
        np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)


def _pair(seed, b=2, h=24, w=32):
    """Smooth stereo-like pairs: the right eye the left shifted by 3 px."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    left = np.full((b, h, w, 3), 0.5, np.float32)
    for _ in range(4):
        f = rng.uniform(-3, 3, 2) / np.array([h, w])
        left += rng.uniform(0.05, 0.2, (b, 1, 1, 3)).astype(np.float32) * np.cos(
            2 * np.pi * (f[0] * yy + f[1] * xx) + rng.uniform(0, 6))[None, ..., None]
    left = np.clip(left + 0.03 * rng.standard_normal(left.shape), 0, 1).astype(np.float32)
    return left, np.roll(left, 3, axis=2)


def _passr(r, seed=0):
    model = tpassr.PASSRnet(upscale_factor=r, channels=16).init_(
        torch.Generator().manual_seed(seed))
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    tree = tw.model_params_to_jax(model)
    _same_tree(tree, import_passr(sd))
    back = tw.model_params_from_jax(model, {"params": tree})
    assert all(torch.equal(back[k], v) for k, v in model.state_dict().items())
    return model, {"params": tree}


def test_resasppb_matches_jax():
    mod = tpassr.ResASPPB(8)
    tpassr.init_dsc_(mod, torch.Generator().manual_seed(1))
    x = np.random.default_rng(2).standard_normal((2, 20, 24, 8)).astype(np.float32)
    tree = {k: {"weight": v.detach().numpy().transpose(2, 3, 1, 0)}
            for k, v in ((name.rsplit(".", 1)[0].split(".")[0], p)
                         for name, p in mod.named_parameters())}
    ref = jpassr.ResASPPB(8).apply({"params": tree}, jnp.asarray(x))
    with torch.no_grad():
        _close(mod(torch.from_numpy(x)), ref)


@pytest.mark.parametrize("r,hw", [(1, (24, 32)), (2, (16, 24))], ids=["x1", "x2"])
def test_passrnet_eval_matches_jax(r, hw):
    model, variables = _passr(r)
    left, right = _pair(3, h=hw[0], w=hw[1])
    with torch.no_grad():
        out = model(torch.from_numpy(left), torch.from_numpy(right))
    ref = jpassr.PASSRnet(upscale_factor=r, channels=16).apply(
        variables, jnp.asarray(left), jnp.asarray(right))
    assert out.shape == (2, hw[0] * r, hw[1] * r, 3)
    _close(out, ref, "sr")


def test_passrnet_train_and_losses_match_jax():
    """The train forward's SR, attention, cycle maps and masks, each loss,
    and the gradient of the total in every parameter."""
    model, variables = _passr(1, seed=4)
    left, right = _pair(5)
    blurry = np.clip(left + 0.05, 0, 1).astype(np.float32)
    jnet = jpassr.PASSRnet(upscale_factor=1, channels=16)

    def jloss(params):
        sr, ms, cycles, vs = jnet.apply({"params": params}, jnp.asarray(blurry),
                                        jnp.asarray(right), train=True)
        losses = jpassr.passr_losses(sr, jnp.asarray(left), ms, cycles, vs,
                                     jnp.asarray(blurry), jnp.asarray(right))
        return losses["loss"], (sr, ms, cycles, vs, losses)

    import jax

    (_, (jsr, jms, jcyc, jvs, jlosses)), jgrads = jax.value_and_grad(jloss, has_aux=True)(
        variables["params"])
    sr, ms, cycles, vs = model(torch.from_numpy(blurry), torch.from_numpy(right), train=True)
    losses = tpassr.passr_losses(sr, torch.from_numpy(left), ms, cycles, vs,
                                 torch.from_numpy(blurry), torch.from_numpy(right))
    _close(sr, jsr, "sr")
    for got, want, what in ((ms, jms, "attention"), (cycles, jcyc, "cycle")):
        for g, w in zip(got, want):
            _close(g, w, what)
    for g, w in zip(vs, jvs):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert 0 < float(vs[0].mean()) < 1  # the masks are not trivial
    assert losses.keys() == jlosses.keys()
    for k in losses:
        np.testing.assert_allclose(float(losses[k].detach()), float(jlosses[k]), rtol=LOSS_RTOL,
                                   err_msg=k)
    losses["loss"].backward()
    grads = _flat(tw.model_params_to_jax(model, {k: p.grad for k, p in model.named_parameters()}))
    jflat = _flat(jgrads)
    # PAM's b2 bias shifts each row of scores by a constant, which the
    # softmax does not see: its true gradient is 0 and both sides hold fp32
    # noise of 1e-12, so a tensor's scale is at least 1e-5 of the largest
    top = max(float(np.abs(g).max()) for g in jflat.values())
    for k, g in jflat.items():
        scale = max(float(np.abs(g).max()), 1e-5 * top)
        np.testing.assert_allclose(grads[k], g, rtol=1e-4, atol=1e-4 * scale, err_msg=k)


def test_final_enhance_net_matches_jax():
    model = tenh.FinalEnhanceNet(16).init_(torch.Generator().manual_seed(6))
    tree = tw.model_params_to_jax(model)
    _same_tree(tree, import_final_enhance({k: v.numpy() for k, v in model.state_dict().items()}))
    back = tw.model_params_from_jax(model, tree)
    assert all(torch.equal(back[k], v) for k, v in model.state_dict().items())
    x = np.random.default_rng(7).uniform(0, 1, (2, 16, 20, 6)).astype(np.float32)
    with torch.no_grad():
        out = model(torch.from_numpy(x))
    ref = jenh.FinalEnhanceNet(16).apply({"params": tree}, jnp.asarray(x))
    assert out.shape == (2, 16, 20, 3)
    _close(out, ref)


def _stats_to_jax(model):
    """The running statistics of ``model`` as a JAX ``batch_stats`` tree."""
    return tw._tree_from({k: v for k, v in model.state_dict().items() if tw._is_stat(k)},
                         tw.layout_of(model).path_of)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_fif_enhance_matches_jax(train):
    gen = torch.Generator().manual_seed(8)
    model = tenh.FIFEnhance(6, 16).init_(gen)
    _perturb_abn_(model, gen)
    variables = {"params": tw.model_params_to_jax(model), "batch_stats": _stats_to_jax(model)}
    back = {**tw.model_params_from_jax(model, variables),
            **tw._state_from(variables["batch_stats"], tw._template(model, stats=True),
                             tw.layout_of(model).path_of, "FIFEnhance batch_stats")}
    assert all(torch.equal(back[k], v) for k, v in model.state_dict().items())
    x = np.random.default_rng(9).uniform(0, 1, (2, 12, 18, 6)).astype(np.float32)
    jnet = jenh.FIFEnhance(features=16)
    if train:
        ref, new_vars = jnet.apply(variables, jnp.asarray(x), train=True,
                                   mutable=["batch_stats"])
    else:
        ref = jnet.apply(variables, jnp.asarray(x))
    with torch.no_grad():
        out = model(torch.from_numpy(x), train=train)
    _close(out, ref)
    if train:
        stats = _flat(_stats_to_jax(model))
        for k, v in _flat(new_vars["batch_stats"]).items():
            _close(stats[k], v, k)


def _write_png(path, img):
    Image.fromarray(np.round(img * 255).astype(np.uint8)).save(path)


@pytest.fixture(scope="module")
def triplets(tmp_path_factory):
    """A FIFEnhanceDataset folder: reconstructed / original / SI_warped
    images of the same names, 40×56."""
    root = tmp_path_factory.mktemp("fif")
    rng = np.random.default_rng(10)
    for sub in ("reconstructed", "original", "SI_warped"):
        os.makedirs(root / sub)
    for i in range(3):
        orig = _pair(20 + i, b=1, h=40, w=56)[0][0]
        _write_png(root / "original" / f"{i}.png", orig)
        _write_png(root / "reconstructed" / f"{i}.png",
                   np.clip(orig + 0.05 * rng.standard_normal(orig.shape), 0, 1))
        _write_png(root / "SI_warped" / f"{i}.png", np.roll(orig, 2, axis=1))
    return str(root / "reconstructed")


@pytest.mark.parametrize("epoch", [0, 1])
def test_loaders_crop_as_jax(kitti, triplets, epoch):  # noqa: F811
    for port, ref in (
            (tdata.StereoPassrDataset([kitti[0]], train=True, crop=(32, 48), seed=3),
             jdata.StereoPassrDataset([kitti[0]], train=True, crop=(32, 48), seed=3)),
            (tdata.StereoPassrDataset([kitti[0]], train=False, crop=(80, 96), seed=3),
             jdata.StereoPassrDataset([kitti[0]], train=False, crop=(80, 96), seed=3)),
            (tdata.FIFEnhanceDataset(triplets, random_crop=True, crop=(32, 32), seed=4),
             jdata.FIFEnhanceDataset(triplets, random_crop=True, crop=(32, 32), seed=4)),
            (tdata.FIFEnhanceDataset(triplets), jdata.FIFEnhanceDataset(triplets))):
        assert len(port) == len(ref)
        port.set_epoch(epoch)
        ref.set_epoch(epoch)
        for i in range(len(port)):
            for a, b in zip(port[i], ref[i]):
                np.testing.assert_array_equal(a, np.asarray(b))


def _rows_close(out, ref):
    assert out.keys() == ref.keys() and len(out["per_image"]) == len(ref["per_image"])
    for row, jrow in zip(out["per_image"] + [out], ref["per_image"] + [ref]):
        for k, v in jrow.items():
            if k != "per_image":
                np.testing.assert_allclose(row[k], v, rtol=1e-4, err_msg=k)


def test_eval_passr_and_enhance_match_jax(kitti, triplets):  # noqa: F811
    model, variables = _passr(1, seed=11)
    data = list(tdata.StereoPassrDataset([kitti[0]], train=False, crop=(32, 48), seed=0))[:2]
    _rows_close(eval_passr(model, data, device="cpu"),
                jeval_passr(jpassr.PASSRnet(upscale_factor=1, channels=16), variables, data))
    net = tenh.FinalEnhanceNet(16).init_(torch.Generator().manual_seed(12))
    tree = tw.model_params_to_jax(net)
    data = list(tdata.FIFEnhanceDataset(triplets))
    _rows_close(eval_enhance(net, data, device="cpu"),
                jeval_enhance(jenh.FinalEnhanceNet(16), {"params": tree}, data))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            eval_passr(model, data)
        with pytest.raises(RuntimeError, match="CUDA"):
            eval_enhance(net, data)
