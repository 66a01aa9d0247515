"""Port parity: the DSC fusion presets (``att_0031bpp``, ``bottleneck_att_1bpp``,
``fif_0031bpp``, ``pam_0031bpp``) and their modules (``models/attention.py``,
``models/passr.py``, ``models/enhance.py``), the weight and batch-stats
bridges, their files and ``train_dsc`` on them, against the JAX package on
the CPU in fp32.

Weights: the port's seeded init (GDNs and FIF's adaptive BatchNorms moved
off their init, ``scale_att`` off 1), carried to JAX by
``dsc_params_to_jax`` and ``dsc_batch_stats_to_jax``; inputs from numpy
seeds. Stated tolerances: the modules rtol 1e-5 / atol 1e-4 (FIF's running
statistics too), the morphology and the extracted patches exact; the
presets as ``test_torch_dsc_model.py`` holds the flagship (the code equal
off the k + ½ boundaries, the decoder on JAX's own code), every output
rtol 1e-5 and atol 1e-4 of its largest |value| (the clipped recon: of the
unclipped one's; at least 1e-4 in all: the random
decoders of an untrained model carry values of thousands, and fp32 keeps
about 7 digits of the largest term of a sum), at 64×128 (the latent is
smaller than one 9×9 patch:
``bottleneck_att_1bpp``'s patch attention has no token there, in both
packages) and ``bottleneck_att_1bpp`` also at 192×224 (2×2 key patches);
the train forwards with JAX's noise handed to the port (as in
``test_torch_dsc_train.py``), the loss triplet rtol 1e-4.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iclr_17_compression_tpu.coding import codec_cli as jcli
from iclr_17_compression_tpu.models import DSC_PRESETS as JAX_PRESETS
from iclr_17_compression_tpu.models import DSCDecoder as JaxDecoder
from iclr_17_compression_tpu.models import DSCStereoModel as JaxModel
from iclr_17_compression_tpu.models import attention as jatt
from iclr_17_compression_tpu.models import enhance as jenh
from iclr_17_compression_tpu.models import passr as jpassr
from iclr_17_compression_tpu.models.dsc import _Stack
from iclr_17_compression_tpu.train.torch_import import (import_fif, import_passr,
                                                        import_patch_attention)
from iclr_17_compression_tpu_torch.coding import codec_cli as tcli
from iclr_17_compression_tpu_torch.models import attention as tatt
from iclr_17_compression_tpu_torch.models import enhance as tenh
from iclr_17_compression_tpu_torch.models import passr as tpassr
from iclr_17_compression_tpu_torch.models.dsc import DSC_PRESETS, DSCDecoder, DSCStereoModel
from iclr_17_compression_tpu_torch.nn.layers import GDN
from iclr_17_compression_tpu_torch.train import cli
from iclr_17_compression_tpu_torch.train.weights import (_flatten, dsc_batch_stats_from_jax,
                                                         dsc_batch_stats_to_jax,
                                                         dsc_params_from_jax, dsc_params_to_jax,
                                                         load_dsc, msgpack_dumps)
from test_torch_dsc_model import _image
from test_torch_dsc_train import _inject, _noises
from test_torch_dsc_trainers import _dsc_cfg, kitti, small_crops  # noqa: F401 (fixtures)

ATOL, RTOL = 1e-4, 1e-5
CODE_RTOL = 2e-6
LOSS_RTOL = 1e-4
PRESETS = ("att_0031bpp", "bottleneck_att_1bpp", "fif_0031bpp", "pam_0031bpp")
TRAINABLE = ("att_0031bpp", "bottleneck_att_1bpp", "pam_0031bpp")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the test workers do not oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _perturb_abn_(module: torch.nn.Module, gen: torch.Generator) -> None:
    """Every adaptive BatchNorm off its init: a, b, the BN's scale and bias,
    and running statistics (variance positive)."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, tenh.AdaptiveBatchNorm):
                c = m.bn.weight.shape[0]
                m.a.fill_(0.8 + 0.4 * float(torch.rand((), generator=gen)))
                m.b.fill_(0.3 + 0.4 * float(torch.rand((), generator=gen)))
                m.bn.weight.copy_(0.5 + torch.rand(c, generator=gen))
                m.bn.bias.copy_(0.2 * torch.randn(c, generator=gen))
                m.bn.running_mean.copy_(torch.randn(c, generator=gen))
                m.bn.running_var.copy_(0.5 + torch.rand(c, generator=gen))


def _variables(model: DSCStereoModel) -> dict:
    """The JAX variables of a port DSC model: params, and batch_stats where
    it has running statistics."""
    sd, cfg = model.state_dict(), model.config
    out = {"params": dsc_params_to_jax(sd, cfg)}
    stats = dsc_batch_stats_to_jax(sd, cfg)
    if stats:
        out["batch_stats"] = stats
    return jax.tree_util.tree_map(lambda v: jnp.array(np.array(v)), out)


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _close(out, ref, what: str, scale=None) -> None:
    """rtol 1e-5, atol 1e-4 of the largest |value| of ``scale`` (default
    ``ref``; at least 1e-4)."""
    out, ref = _np(out), np.asarray(ref)
    top = float(np.abs(np.asarray(ref if scale is None else scale)).max(initial=0.0))
    np.testing.assert_allclose(out, ref, rtol=RTOL, atol=ATOL * max(1.0, top), err_msg=what)


def _close_outputs(out, jout) -> None:
    """Every output of a DSC forward; the clipped recon at the scale of the
    unclipped one it is cut from."""
    assert set(out) == set(jout)
    for key in out:
        if key.startswith("loss"):
            np.testing.assert_allclose(_np(out[key]), np.asarray(jout[key]), rtol=LOSS_RTOL,
                                       err_msg=key)
        else:
            _close(out[key], jout[key], key, jout["recon_raw"] if key == "recon" else None)


# ---------------------------------------------------------------------------
# The modules.
# ---------------------------------------------------------------------------


def test_bottleneck_attention_matches_jax():
    rng = np.random.default_rng(0)
    q = rng.standard_normal((2, 5, 7, 16)).astype(np.float32)
    kv = rng.standard_normal((2, 4, 6, 16)).astype(np.float32)
    out = tatt.bottleneck_attention(torch.from_numpy(q), torch.from_numpy(kv)).numpy()
    ref = np.asarray(jatt.bottleneck_attention(jnp.asarray(q), jnp.asarray(kv)))
    np.testing.assert_allclose(out, ref, rtol=RTOL, atol=ATOL)
    # the keys are the values: a constant key map returns itself
    const = np.broadcast_to(kv[:, :1, :1], kv.shape).copy()
    same = tatt.bottleneck_attention(torch.from_numpy(q), torch.from_numpy(const)).numpy()
    np.testing.assert_allclose(same, np.broadcast_to(const[:, :1, :1], q.shape), atol=1e-6)


@pytest.mark.parametrize("size,stride", [(9, 3), (4, 2), (9, 9)])
def test_extract_patches_matches_jax(size, stride):
    x = np.random.default_rng(size + stride).standard_normal((2, 20, 23, 5)).astype(np.float32)
    out, nh, nw = tatt._extract_patches(torch.from_numpy(x), size, stride)
    ref, jnh, jnw = jatt._extract_patches(jnp.asarray(x), size, stride)
    assert (nh, nw) == (jnh, jnw)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def _patch_attention(seed: int, dim: int = 8, dim_head: int = 6):
    gen = torch.Generator().manual_seed(seed)
    mod = tatt.PatchMatchAttention(dim, dim_head)
    with torch.no_grad():
        for conv in (mod.q_patches[0], mod.k_patches[0]):
            conv.weight.copy_(torch.randn(conv.weight.shape, generator=gen) * 0.1)
            conv.bias.copy_(torch.randn(conv.bias.shape, generator=gen) * 0.1)
        mod.scale_att.fill_(0.7)
    jparams = import_patch_attention({k: v.numpy() for k, v in mod.state_dict().items()})
    return mod, jparams


# q / kv maps, and the value image (None: the keys' map) with its scale
ATTENTION_CASES = {"kv": ((2, 18, 27), (2, 21, 27), None),
                   "v_img": ((2, 18, 27), (2, 18, 27), (2, 36, 54)),
                   "smaller_than_a_patch": ((2, 4, 8), (2, 4, 8), None)}


@pytest.mark.parametrize("case", sorted(ATTENTION_CASES))
def test_patch_match_attention_matches_jax(case):
    q_shape, kv_shape, v_shape = ATTENTION_CASES[case]
    mod, jparams = _patch_attention(3)
    rng = np.random.default_rng(4)
    q = rng.standard_normal(q_shape + (8,)).astype(np.float32)
    kv = rng.standard_normal(kv_shape + (8,)).astype(np.float32)
    v = None if v_shape is None else rng.standard_normal(v_shape + (3,)).astype(np.float32)
    with torch.no_grad():
        out = mod(torch.from_numpy(q), torch.from_numpy(kv),
                  None if v is None else torch.from_numpy(v)).numpy()
    ref = np.asarray(jatt.PatchMatchAttention(8, 6).apply(
        {"params": jparams}, jnp.asarray(q), jnp.asarray(kv),
        None if v is None else jnp.asarray(v)))
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=RTOL, atol=ATOL)
    if case != "smaller_than_a_patch":
        assert np.abs(out).max() > 0.1


def test_clean_mask_matches_jax():
    rng = np.random.default_rng(7)
    mask = (rng.random((2, 24, 40, 1)) > 0.55).astype(np.float32)
    out = tpassr.clean_mask(torch.from_numpy(mask)).numpy()
    ref = np.asarray(jpassr.clean_mask(jnp.asarray(mask)))
    np.testing.assert_array_equal(out, ref)
    assert 0 < out.mean() < 1 and not np.array_equal(out, mask)


def _pam(c: int = 8, seed: int = 5):
    mod = tpassr.PAM(c)
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in mod.parameters():
            p.copy_(torch.randn(p.shape, generator=gen) * 0.3)
    sd = {f"pam.{k}": v.numpy() for k, v in mod.state_dict().items()}
    return mod, import_passr(sd)["pam"]


@pytest.mark.parametrize("train", [False, True])
def test_pam_matches_jax(train):
    mod, jparams = _pam()
    rng = np.random.default_rng(8)
    xl = rng.standard_normal((2, 20, 32, 8)).astype(np.float32)
    xr = np.roll(xl, 2, axis=2) + 0.1 * rng.standard_normal(xl.shape).astype(np.float32)
    with torch.no_grad():
        out = mod(torch.from_numpy(xl), torch.from_numpy(xr), train=train)
    ref = jpassr.PAM(8).apply({"params": jparams}, jnp.asarray(xl), jnp.asarray(xr), train=train)
    if not train:
        out, ref = (out,), (ref,)
    flat_t = jax.tree_util.tree_leaves(jax.tree_util.tree_map(np.asarray, out))
    flat_j = jax.tree_util.tree_leaves(ref)
    assert len(flat_t) == len(flat_j) == (7 if train else 1)
    for i, (a, b) in enumerate(zip(flat_t, flat_j)):
        np.testing.assert_allclose(_np(a), np.asarray(b), rtol=RTOL, atol=ATOL, err_msg=str(i))
    for m in flat_t[-2:] if train else ():  # the masks: {0, 1}, not all 0
        assert set(np.unique(m)) <= {0.0, 1.0} and m.max() == 1.0


@pytest.mark.parametrize("train", [False, True])
def test_fif_matches_jax(train):
    """FIF at 16 features on a 6×10 map: dilation 8 wraps the circular
    padding more than once. In training the output uses the batch's
    statistics and the running ones move (flax: momentum 0.9, biased
    variance)."""
    fif = tenh.FIF(16)
    gen = torch.Generator().manual_seed(9)
    with torch.no_grad():
        for name in tenh.FIF_NAMES:
            conv = getattr(fif, name).convblk[0]
            conv.weight.add_(0.05 * torch.randn(conv.weight.shape, generator=gen))
            conv.bias.copy_(0.1 * torch.randn(conv.bias.shape, generator=gen))
    _perturb_abn_(fif, gen)
    sd = {f"fif.{k}": v.numpy().copy() for k, v in fif.state_dict().items()}
    jparams, jstats = import_fif(sd, "fif")
    x = np.random.default_rng(10).standard_normal((2, 6, 10, 16)).astype(np.float32)
    jfif = jenh.FIF(features=16)
    variables = {"params": jparams, "batch_stats": jstats}
    if train:
        ref, mutated = jfif.apply(variables, jnp.asarray(x), train=True,
                                  mutable=["batch_stats"])
    else:
        ref = jfif.apply(variables, jnp.asarray(x), train=False)
    with torch.no_grad():
        out = fif(torch.from_numpy(x), train).numpy()
    np.testing.assert_allclose(out, np.asarray(ref), rtol=RTOL, atol=ATOL)
    _, stats_after = import_fif({f"fif.{k}": v.numpy() for k, v in fif.state_dict().items()},
                                "fif")
    want = mutated["batch_stats"] if train else jstats
    for path, v in _flatten(want).items():
        np.testing.assert_allclose(_flatten(stats_after)[path], np.asarray(v), rtol=RTOL,
                                   atol=ATOL, err_msg=path)
    moved = any(not np.array_equal(_flatten(stats_after)[p], np.asarray(v))
                for p, v in _flatten(jstats).items())
    assert moved == train


# ---------------------------------------------------------------------------
# The presets.
# ---------------------------------------------------------------------------


def _calibrate_bn_(model: DSCStereoModel, im1: np.ndarray, im2: np.ndarray) -> None:
    """Each BatchNorm's running statistics set, block after block, to the
    statistics of its input in an eval forward of (``im1``, ``im2``): the
    statistics a trained model holds, in place of flax's init (mean 0,
    variance 1) under latents of tens."""
    for bn in (m for m in model.modules() if isinstance(m, tenh.FlaxBatchNorm)):
        seen = {}
        hook = bn.register_forward_pre_hook(lambda mod, args: seen.setdefault("x", args[0]))
        with torch.no_grad():
            model(torch.from_numpy(im1), torch.from_numpy(im2))
            hook.remove()
            x = seen["x"].flatten(0, 2)
            bn.running_mean.copy_(x.mean(dim=0))
            bn.running_var.copy_(x.var(dim=0, unbiased=False))


def port_model(preset: str, seed: int = 0, spread: float = 60.0) -> DSCStereoModel:
    """The seeded init of ``preset``, GDNs and adaptive BatchNorms off their
    init (the running statistics those of the data), ``scale_att`` at 0.5,
    and the last conv of g_a22 scaled so that the code spreads over several
    steps on ``_image(1)``."""
    gen = torch.Generator().manual_seed(seed)
    model = DSCStereoModel(DSC_PRESETS[preset]).init_(gen).eval()
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, GDN):
                c = m.beta.shape[0]
                m.beta.copy_(0.7 + 0.6 * torch.rand(c, generator=gen))
                m.gamma.copy_(0.3 * torch.eye(c) + 0.1 * torch.rand((c, c), generator=gen))
        _perturb_abn_(model, gen)
        if hasattr(model, "bot_mhsa"):
            model.bot_mhsa.scale_att.fill_(0.5)
        cfg = model.config
        last = model.g_a22[max(i for i, s in enumerate(cfg.ga22) if s[0] in ("conv3", "rb"))]
        conv = last if isinstance(last, torch.nn.Conv2d) else last.conv2
        std = float(model.encode(torch.from_numpy(_image(1, 64, 128))).std())
        conv.weight.mul_(spread / std)
        conv.bias.mul_(spread / std)
    _calibrate_bn_(model, _image(1, 64, 128), _image(2, 64, 128))
    return model


@pytest.fixture(scope="module")
def models():
    return {p: port_model(p) for p in PRESETS}


FORWARD_CASES = [(p, (64, 128)) for p in PRESETS] + [("bottleneck_att_1bpp", (192, 224))]


@pytest.mark.parametrize("preset,hw", FORWARD_CASES)
def test_preset_eval_forward_matches_jax(models, preset, hw):
    model = models[preset]
    cfg = model.config
    variables = _variables(model)
    im1, im2 = _image(1, *hw), _image(2, *hw)
    jout = JaxModel(JAX_PRESETS[preset]).apply(variables, jnp.asarray(im1), jnp.asarray(im2),
                                               train=False)
    with torch.no_grad():
        code_pre = model.encode(torch.from_numpy(im1)).numpy()
        out = model(torch.from_numpy(im1), torch.from_numpy(im2))
    jcode_pre = np.asarray(_Stack(cfg.ga22).apply({"params": variables["params"]["g_a22"]},
                                                  jout["z1"]))
    step = cfg.coarse_step
    np.testing.assert_allclose(code_pre / step, jcode_pre / step, rtol=CODE_RTOL, atol=ATOL)
    near = np.abs(jcode_pre / step - np.floor(jcode_pre / step) - 0.5) < 1e-4
    jcode = np.array(jout["code"])
    assert len(np.unique(jcode)) >= 4, "the code uses too few symbols to test"
    assert np.array_equal(out["code"].numpy()[~near], jcode[~near])
    # the receiver on JAX's own code
    with torch.no_grad():
        recon = DSCDecoder(cfg, clip=False, model=model)(torch.from_numpy(jcode),
                                                         torch.from_numpy(im2)).numpy()
    jrecon = np.asarray(JaxDecoder(JAX_PRESETS[preset], clip=False).apply(
        variables, jnp.asarray(jcode), jnp.asarray(im2)))
    _close(recon, jrecon, "decoder")
    assert 0.05 < recon.std()
    if near.any():
        print(f"{preset}: {int(near.sum())} code elements within 1e-4 of k + 1/2")
        return
    _close_outputs(out, jout)


@pytest.mark.parametrize("preset", PRESETS)
def test_preset_train_forward_matches_jax(models, preset, monkeypatch):
    """JAX's noise handed to the port; FIF's batch statistics against JAX's
    ``apply(..., mutable=["batch_stats"])`` (the only way the JAX model runs
    that preset in training)."""
    model = port_model(preset, seed=1)
    cfg = model.config
    variables = _variables(model)
    im1, im2 = (np.concatenate([_image(s, 64, 128), _image(s + 10, 64, 128)])
                for s in (3, 4))
    rng = jax.random.PRNGKey(21)
    jmodel = JaxModel(JAX_PRESETS[preset])
    args = (jnp.asarray(im1), jnp.asarray(im2))
    if cfg.fusion_pre == "fif":
        jout, mutated = jmodel.apply(variables, *args, train=True, rngs={"quant": rng},
                                     mutable=["batch_stats"])
    else:
        jout = jmodel.apply(variables, *args, train=True, rngs={"quant": rng})
    queue = _noises(JAX_PRESETS[preset], variables, rng,
                    [(2, 64 // cfg.code_div, 128 // cfg.code_div, cfg.code_channels)]
                    + [(2, 64 // cfg.latent_div, 128 // cfg.latent_div, cfg.n)] * 2)
    _inject(monkeypatch, queue)
    with torch.no_grad():
        out = model(torch.from_numpy(im1), torch.from_numpy(im2), train=True)
    assert not queue, "the port drew fewer noises than JAX"
    _close_outputs(out, jout)
    if cfg.fusion_pre == "fif":
        stats = _flatten(dsc_batch_stats_to_jax(model.state_dict(), cfg))
        before = _flatten(variables["batch_stats"])
        for path, v in _flatten(mutated["batch_stats"]).items():
            np.testing.assert_allclose(stats[path], np.asarray(v), rtol=RTOL, atol=ATOL,
                                       err_msg=path)
            assert not np.array_equal(stats[path], np.asarray(before[path])), path


@pytest.mark.parametrize("preset", PRESETS)
def test_bridges_round_trip_every_leaf(models, preset):
    model = models[preset]
    cfg = model.config
    sd = model.state_dict()
    tree, stats = dsc_params_to_jax(sd, cfg), dsc_batch_stats_to_jax(sd, cfg)
    back = {**dsc_params_from_jax(tree, cfg), **dsc_batch_stats_from_jax(stats, cfg)}
    assert set(back) == set(sd)
    for k, v in sd.items():
        assert torch.equal(back[k], v), k
    # the JAX model's own variables: the same leaves and shapes
    x = jax.ShapeDtypeStruct((1, 64, 128, 3), jnp.float32)
    key = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(lambda a: JaxModel(JAX_PRESETS[preset]).init(
        {"params": key, "quant": key}, a, a, train=False), x)
    for ours, theirs in ((tree, shapes["params"]), (stats, shapes.get("batch_stats", {}))):
        want = {p: tuple(v.shape) for p, v in _flatten(dict(theirs)).items()}
        assert {p: np.shape(v) for p, v in _flatten(ours).items()} == want
    # the JAX package's importers of the reference's keys agree
    np_sd = {k: v.numpy() for k, v in sd.items()}
    imported = []
    if cfg.fusion_pre == "fif":
        fif_p, fif_s = import_fif(np_sd, "fif")
        imported += [(fif_p, tree["fif"]), (fif_s, stats["fif"])]
    if cfg.fusion_post == "patch_att":
        imported.append((import_patch_attention({k[len("bot_mhsa."):]: v for k, v in np_sd.items()
                                                 if k.startswith("bot_mhsa.")}), tree["bot_mhsa"]))
    if cfg.fusion_post == "pam":
        imported.append((import_passr({k: v for k, v in np_sd.items()
                                       if k.startswith("pam.")})["pam"], tree["pam"]))
    for got, ours in imported:
        got, ours = _flatten(got), _flatten(ours)
        assert set(got) == set(ours)
        for path in got:
            np.testing.assert_array_equal(np.asarray(got[path]), ours[path], err_msg=path)
    with pytest.raises(KeyError, match="missing"):
        dsc_params_from_jax({k: v for k, v in tree.items() if k not in ("fif", "final_conv",
                                                                         "pam")}, cfg)


def _near(variables, preset, img):
    cfg = JAX_PRESETS[preset]
    p = variables["params"]
    x = jnp.asarray(jcli.pad_to_multiple(img, cfg.code_div)[None])
    pre = np.asarray(_Stack(cfg.ga22).apply({"params": p["g_a22"]},
                                           _Stack(cfg.ga).apply({"params": p["g_a"]}, x)))
    q = pre[0] / cfg.coarse_step
    return np.abs(q - np.floor(q) - 0.5) < 1e-4


@pytest.mark.parametrize("preset", PRESETS)
def test_files_match_jax_and_load_dsc(models, preset, tmp_path):
    """The DSC file of a fusion preset: the JAX CLI's bytes; each package
    decodes the other's file; a checkpoint of the variables (params and
    batch_stats) loads through ``load_dsc``."""
    model = models[preset]
    variables = _variables(model)
    a, b = _image(5, 70, 120)[0], _image(6, 70, 120)[0]
    data = tcli.encode_image(a, model, device="cpu")
    jdata = jcli.encode_image(a, preset, variables)
    near = _near(variables, preset, a)
    if near.any():
        print(f"{preset}: {int(near.sum())} code elements within 1e-4 of k + 1/2")
    else:
        assert data == jdata
    code = tcli.read_dsc_code(data)[0]
    assert code.shape[-1] == model.config.code_channels
    jrec = np.asarray(jcli.decode_image(jdata, variables, si_image=b))
    np.testing.assert_allclose(tcli.decode_image(jdata, model, device="cpu", si_image=b), jrec,
                               rtol=0, atol=ATOL)
    ckpt = tmp_path / "vars.msgpack"
    ckpt.write_bytes(msgpack_dumps(jax.tree_util.tree_map(np.asarray, variables)))
    loaded = load_dsc(str(ckpt), preset, device="cpu")
    for k, v in model.state_dict().items():
        assert torch.equal(loaded.state_dict()[k], v), k


@pytest.mark.parametrize("preset", PRESETS)
def test_load_dsc_of_a_params_only_file(models, preset, tmp_path):
    """A params-only JAX file (what the JAX trainer writes): a preset without
    BatchNorm loads from it; ``fif_0031bpp`` is refused naming Queue 3, as
    the JAX model refuses to run on it."""
    model = models[preset]
    variables = _variables(model)
    ckpt = tmp_path / "params.msgpack"
    ckpt.write_bytes(msgpack_dumps({"params": jax.tree_util.tree_map(
        np.asarray, variables["params"])}))
    if model.config.fusion_pre != "fif":
        loaded = load_dsc(str(ckpt), preset, device="cpu")
        for k, v in model.state_dict().items():
            assert torch.equal(loaded.state_dict()[k], v), k
        return
    with pytest.raises(ValueError, match="Queue 3"):
        load_dsc(str(ckpt), preset, device="cpu")
    im = jnp.asarray(_image(1, 64, 128))
    with pytest.raises(Exception, match="batch_stats"):
        JaxModel(JAX_PRESETS[preset]).apply({"params": variables["params"]}, im, im,
                                            train=False)


@pytest.mark.parametrize("preset", TRAINABLE)
def test_train_dsc_trains_the_fusion_presets(kitti, small_crops, tmp_path, preset):  # noqa: F811
    """Two steps of ``train_dsc`` on 64×64 crops; the best-train state goes
    into the codec."""
    cfg = _dsc_cfg(kitti, tmp_path, model=f"dsc:{preset}", tot_epoch=1)
    state = cli.train_dsc(cfg, "run", device="cpu")
    assert state.step == 2
    trained = load_dsc(str(tmp_path / "run" / "best_train.ckpt"), preset, device="cpu")
    for k, v in state.model.state_dict().items():
        assert torch.equal(trained.state_dict()[k], v), k
    data = tcli.encode_image(_image(7, 64, 64)[0], trained, device="cpu")
    rec = tcli.decode_image(data, trained, device="cpu", si_image=_image(8, 64, 64)[0])
    assert rec.shape == (64, 64, 3) and np.isfinite(rec).all()


def test_fif_preset_is_refused_by_train_dsc(kitti, tmp_path):  # noqa: F811
    cfg = _dsc_cfg(kitti, tmp_path, model="dsc:fif_0031bpp")
    with pytest.raises(NotImplementedError, match="Queue 3"):
        cli.train_dsc(cfg, "run", device="cpu")
    with pytest.raises(NotImplementedError, match="batch_stats"):
        cli.check_supported(dataclasses.replace(cfg, tot_epoch=1))
