"""Port parity: the six auxiliary trainers (``two_steps``, ``decoder_only``,
``att_exp``, ``att_block``, ``passr``, ``fif_enhance``) against the JAX
package's on the CPU in fp32, their helpers (``_kitti``'s ``multiple``,
``_load_frozen``) against JAX's, and each trainer's whole loop.

Each trainer's epoch loop is replaced by a capture of its state and step,
which the test drives on the same batch: JAX's optimizer by a transform that
keeps the gradients in its state, so that both packages' gradients of the
same step are compared, every parameter tensor; JAX's noise is handed to
the port (``decoder_only``). Both frozen models and trainable states start
from the port's seeded init carried across by the weight bridges; the
frozen model is read from its file by both (JAX's own loader inits a model
first, which takes minutes in eager flax). Sizes: ``two_steps`` at its
fixed 128 channels, ``decoder_only`` at N = 16, ``att_block`` on the
``tiny`` DSC preset for ``temp_1bpp`` (its patch attention takes the
preset's 16 channels) on 192×224 images (a 12×14 latent: one 9×9 query
patch against 2×2 key patches; with one key the softmax is 1 and every
gradient 0), PASSRnet and FinalEnhanceNet at 16 channels. Stated tolerances:
the loss rtol 1e-4, each gradient (clamped at ±5, as both optimizers clamp
it) rtol 1e-4 and atol 1e-4 of its tensor's largest (at least 1e-5 of the
largest of all: PAM's b2 bias has a true gradient of 0). The frozen models
are bit-unchanged.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import serialization

import iclr_17_compression_tpu.models as jmodels
from iclr_17_compression_tpu.models import DSC_PRESETS as JAX_PRESETS
from iclr_17_compression_tpu.models import Balle17Compressor as JaxBalle17
from iclr_17_compression_tpu.train import trainers as jtrainers
from iclr_17_compression_tpu.train.config import TrainConfig as JaxTrainConfig
from iclr_17_compression_tpu.train.state import TrainState as JaxTrainState
from iclr_17_compression_tpu_torch.models.attention import PatchMatchAttention
from iclr_17_compression_tpu_torch.models.balle17 import Balle17Compressor, Synthesis17
from iclr_17_compression_tpu_torch.models.dsc import DSC_PRESETS, DSCStereoModel
from iclr_17_compression_tpu_torch.models.enhance import FinalEnhanceNet
from iclr_17_compression_tpu_torch.models.extra import LatentCompressor
from iclr_17_compression_tpu_torch.models.passr import PASSRnet
from iclr_17_compression_tpu_torch.nn.blocks import init_dsc_
from iclr_17_compression_tpu_torch.nn.layers import init_modules_
from iclr_17_compression_tpu_torch.ops import quant as tquant
from iclr_17_compression_tpu_torch.train import checkpoint as tckpt
from iclr_17_compression_tpu_torch.train import cli
from iclr_17_compression_tpu_torch.train import trainers as ttrainers
from iclr_17_compression_tpu_torch.train import weights as tw
from iclr_17_compression_tpu_torch.train.config import TrainConfig
from iclr_17_compression_tpu_torch.train.state import create_train_state
from test_torch_dsc_trainers import kitti  # noqa: F401 (fixture)
from test_torch_extra import _flat
from test_torch_passr_enhance import _pair, triplets  # noqa: F401 (fixture)

LOSS_RTOL, GRAD_RTOL = 1e-4, 1e-4
AUX = ("two_steps", "decoder_only", "att_exp", "att_block", "passr", "fif_enhance")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the test workers do not oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def small_models(monkeypatch):
    """The trainers' fixed-width models at test widths, in both packages:
    ``temp_1bpp`` is the ``tiny`` preset, PASSRnet and FinalEnhanceNet have
    16 channels."""
    for table in (JAX_PRESETS, DSC_PRESETS):
        monkeypatch.setitem(table, "temp_1bpp", table["tiny"])
    monkeypatch.setattr(jmodels, "PASSRnet", functools.partial(jmodels.PASSRnet, channels=16))
    monkeypatch.setattr(jmodels, "FinalEnhanceNet",
                        functools.partial(jmodels.FinalEnhanceNet, n=16))
    monkeypatch.setattr(ttrainers, "PASSRnet", functools.partial(PASSRnet, channels=16))
    monkeypatch.setattr(ttrainers, "FinalEnhanceNet", functools.partial(FinalEnhanceNet, n=16))


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _frozen_balle(n, seed=1):
    return Balle17Compressor(n).init_(_gen(seed)).eval()


def _frozen_dsc(seed=2):
    return DSCStereoModel(DSC_PRESETS["tiny"]).init_(_gen(seed)).eval()


def _images(seed, b=2, hw=(64, 64)):
    left, right = _pair(seed, b=b, h=hw[0], w=hw[1])
    return left, right


# trainer → (its trainable port model, n for the config, the frozen model
# or None, the batch)
def _case(name):
    if name == "two_steps":
        return LatentCompressor().init_(_gen(3)), 128, _frozen_balle(128), _images(4)
    if name == "decoder_only":
        return init_modules_(Synthesis17(16), _gen(3)), 16, _frozen_balle(16), _images(5)
    if name == "att_exp":
        return init_dsc_(PatchMatchAttention(3, 128), _gen(3)), 16, None, _images(6)
    if name == "att_block":
        return (init_dsc_(PatchMatchAttention(16, 1024), _gen(3)), 16, _frozen_dsc(),
                _images(7, hw=(192, 224)))
    if name == "passr":
        left, right = _images(8, hw=(32, 48))
        return PASSRnet(1, 16).init_(_gen(3)), 16, None, (np.clip(left + 0.05, 0, 1), right,
                                                          left)
    rec, orig = _images(9, hw=(32, 32))
    return FinalEnhanceNet(16).init_(_gen(3)), 16, None, (np.roll(orig, 2, axis=2), rec, orig)


def _keep_grads():
    """An optax transformation that leaves the parameters as they are and
    keeps the gradients of the last update in its state."""
    return optax.GradientTransformation(
        lambda params: {"g": jax.tree_util.tree_map(jnp.zeros_like, params)},
        lambda grads, state, params=None: (jax.tree_util.tree_map(jnp.zeros_like, grads),
                                           {"g": grads}))


def _jtree(model):
    return jax.tree_util.tree_map(lambda v: jnp.array(np.array(v)), tw.model_params_to_jax(model))


def _write_frozen(model, path):
    if isinstance(model, DSCStereoModel):
        tree = tw.dsc_params_to_jax(model.state_dict(), model.config)
    else:
        tree = tw.params_to_jax(model.state_dict())
    with open(path, "wb") as f:
        f.write(tw.msgpack_dumps(tree))
    return str(path)


def _train_dir(name, kitti, triplets):  # noqa: F811
    return triplets if name == "fif_enhance" else kitti[0]


@pytest.mark.parametrize("name", AUX)
def test_step_matches_jax(name, kitti, triplets, small_models, tmp_path,  # noqa: F811
                          monkeypatch):
    model, n, frozen, batch = _case(name)
    pretrain = _write_frozen(frozen, tmp_path / "frozen.msgpack") if frozen is not None else ""
    captured = {}

    def capture(pkg):
        def run_epochs(cfg, run_name, dataset, state, step_fn, *args, **kw):
            captured[pkg] = (state, step_fn)
            return state
        return run_epochs

    monkeypatch.setattr(jtrainers, "_run_epochs", capture("jax"))
    monkeypatch.setattr(jtrainers, "_state_with_lr", lambda m, rng, ex, cfg, **kw: (
        JaxTrainState.create(apply_fn=m.apply, params=_jtree(model), tx=_keep_grads())))
    monkeypatch.setattr(jtrainers, "_load_frozen", lambda m, rng, ex, path, **kw: (
        serialization.msgpack_restore(open(path, "rb").read())))
    monkeypatch.setattr(ttrainers, "_run_epochs", capture("port"))
    real_load_frozen = ttrainers._load_frozen
    monkeypatch.setattr(ttrainers, "_load_frozen", lambda m, path: captured.setdefault(
        "frozen", real_load_frozen(m, path)))
    kw = dict(model=name, train_dir=_train_dir(name, kitti, triplets), batch_size=2,
              lr_base=1e-4, out_channel_n=n, image_size=64, save_root=str(tmp_path))
    getattr(jtrainers, f"train_{name}")(JaxTrainConfig(**kw), "jax", pretrain=pretrain)
    ttrainers.TRAINERS[name](TrainConfig(**kw), "port", pretrain=pretrain, device="cpu")
    jstate, jstep = captured["jax"]
    state, step = captured["port"]
    state.model.load_state_dict(model.state_dict())
    port_frozen = captured.get("frozen")
    if frozen is not None:
        assert not port_frozen.training and all(not p.requires_grad
                                                for p in port_frozen.parameters())
        for k, v in frozen.state_dict().items():  # read from the file bit-exact
            assert torch.equal(port_frozen.state_dict()[k], v), k

    rng = jax.random.PRNGKey(7)
    queue = []
    if name == "decoder_only":
        z_shape = (2, batch[0].shape[1] // 16, batch[0].shape[2] // 16, n)
        queue.append(np.array(jax.random.uniform(rng, z_shape, jnp.float32, -0.5, 0.5)))
        monkeypatch.setattr(tquant, "add_uniform_noise",
                            lambda x, gen, h: x + torch.from_numpy(queue.pop(0)))
    jstate, jm = jstep(jstate, batch, rng)
    metrics = step(state, batch, None)
    assert not queue
    np.testing.assert_allclose(float(metrics["loss"]), float(jm["loss"]), rtol=LOSS_RTOL)
    # a parameter off the loss's path (LatentCompressor's z1_down branch) has
    # no torch gradient and a zero JAX one
    grads = _flat(tw.model_params_to_jax(state.model, {
        k: torch.zeros_like(p) if p.grad is None else p.grad
        for k, p in state.model.named_parameters()}))
    jgrads = {k: np.clip(g, -5, 5) for k, g in _flat(jstate.opt_state["g"]).items()}
    assert grads.keys() == jgrads.keys()
    top = max(float(np.abs(g).max()) for g in jgrads.values())
    assert top > 0
    for k, g in jgrads.items():
        scale = max(float(np.abs(g).max()), 1e-5 * top)
        np.testing.assert_allclose(grads[k], g, rtol=GRAD_RTOL, atol=GRAD_RTOL * scale,
                                   err_msg=f"{name} {k}")
    if frozen is not None:
        for k, v in frozen.state_dict().items():
            assert torch.equal(port_frozen.state_dict()[k], v), k


def test_kitti_multiple_matches_jax(kitti, tmp_path):  # noqa: F811
    """``_kitti(cfg, multiple)`` floors the KITTI crops, and crops the pairs
    square at ``image_size`` floored, to ×``multiple``, as JAX's does."""
    left, right = (os.path.join(kitti[0], side) for side in ("image_2", "image_3"))
    for dataset, train_dir in (("kitti", kitti[0]), ("pairs", f"{left},{right}")):
        for multiple in (16, 32):
            cfg = dict(train_dir=train_dir, dataset=dataset, image_size=72)
            port = ttrainers._kitti(TrainConfig(**cfg), multiple=multiple)
            ref = jtrainers._kitti(JaxTrainConfig(**cfg), multiple=multiple)
            for i in range(2):
                for a, b in zip(port[i], ref[i]):
                    np.testing.assert_array_equal(a, np.asarray(b))
                    assert a.shape[0] % multiple == 0 and a.shape[1] % multiple == 0
    assert ttrainers._kitti(TrainConfig(train_dir=f"{left},{right}", dataset="pairs",
                                        image_size=72), 16)[0][0].shape[:2] == (64, 64)


def test_load_frozen_matches_jax(tmp_path):
    """``_load_frozen`` reads a Ballé-17 params file, a JAX TrainState and
    the port's train state, and a DSC params file, into the weights JAX's
    ``_load_frozen`` gives; the result is frozen."""
    src = _frozen_balle(16, seed=11)
    tree = tw.params_to_jax(src.state_dict())
    files = {"params": tree, "train_state": {"params": tree, "step": np.int32(3),
                                             "opt_state": {"count": np.int32(3)}}}
    img = jnp.zeros((1, 32, 32, 3))
    for kind, blob in files.items():
        path = str(tmp_path / f"{kind}.msgpack")
        with open(path, "wb") as f:
            f.write(tw.msgpack_dumps(blob))
        ref = jtrainers._load_frozen(JaxBalle17(out_channel_n=16), jax.random.PRNGKey(0),
                                     (img,), path, train=False)
        got = ttrainers._load_frozen(Balle17Compressor(16), path)
        assert not got.training and not any(p.requires_grad for p in got.parameters())
        for k, v in _flat(ref).items():
            np.testing.assert_array_equal(_flat(tw.params_to_jax(got.state_dict()))[k], v,
                                          err_msg=f"{kind} {k}")
    port_state = tckpt.save_train_state(create_train_state(src, lr=1e-4), str(tmp_path), "src")
    got = ttrainers._load_frozen(Balle17Compressor(16), port_state)
    assert all(torch.equal(got.state_dict()[k], v) for k, v in src.state_dict().items())
    dsc = _frozen_dsc(seed=12)
    got = ttrainers._load_frozen(DSCStereoModel(DSC_PRESETS["tiny"]),
                                 _write_frozen(dsc, tmp_path / "dsc.msgpack"))
    assert all(torch.equal(got.state_dict()[k], v) for k, v in dsc.state_dict().items())
    with pytest.raises(ValueError, match="shape"):  # another width
        ttrainers._load_frozen(Balle17Compressor(32), str(tmp_path / "params.msgpack"))


@pytest.mark.parametrize("name", AUX)
def test_trainer_loop_and_checkpoints(name, kitti, triplets, small_models,  # noqa: F811
                                      tmp_path):
    """Each trainer's own loop on the CPU for 2 epochs, at most 3 steps
    (stereo pairs cropped square): finite losses, ``best_train.ckpt`` of its state that
    loads back through ``_load_frozen`` and ``load_params_partial``, the
    frozen model untouched."""
    model, n, frozen, _ = _case(name)
    pretrain = _write_frozen(frozen, tmp_path / "frozen.msgpack") if frozen is not None else ""
    left, right = (os.path.join(kitti[0], side) for side in ("image_2", "image_3"))
    train_dir = _train_dir(name, kitti, triplets)
    if train_dir == kitti[0] and name != "passr":
        train_dir = f"{left},{right}"
    cfg = TrainConfig(model=name, train_dir=train_dir, dataset="pairs", batch_size=2,
                      out_channel_n=n, image_size=192 if name == "att_block" else 64,
                      tot_epoch=2, tot_step=3, print_freq=1, save_root=str(tmp_path))
    losses = []
    real_update = ttrainers._update

    def update(state, loss):
        losses.append(float(loss.detach()))
        real_update(state, loss)

    ttrainers._update = update
    try:
        cli.setup_logging(name, str(tmp_path / name))
        state = ttrainers.TRAINERS[name](cfg, name, pretrain=pretrain, device="cpu")
    finally:
        ttrainers._update = real_update
    # two pairs of frames give two batches an epoch, three triplets one
    assert state.step == len(losses) == (2 if name == "fif_enhance" else 3)
    assert np.all(np.isfinite(losses))
    best = tmp_path / name / "best_train.ckpt"
    assert best.exists() and (tmp_path / name / "epoch_0.ckpt").exists()
    blob = torch.load(best, weights_only=True)
    loaded = ttrainers._load_frozen(type(state.model)(*_ctor_args(name, n)), str(best))
    partial = type(state.model)(*_ctor_args(name, n))
    tckpt.load_params_partial(partial, str(best))
    for k, v in blob["model"].items():
        assert torch.equal(loaded.state_dict()[k], v) and torch.equal(partial.state_dict()[k], v)
    # the trained parameters as the JAX tree and back
    tree = tw.model_params_to_jax(state.model)
    back = tw.model_params_from_jax(state.model, {"params": tree})
    assert all(torch.equal(back[k], state.model.state_dict()[k]) for k in back)


def _ctor_args(name, n):
    return {"two_steps": (), "decoder_only": (n,), "att_exp": (3, 128),
            "att_block": (16, 1024), "passr": (1, 16), "fif_enhance": (16,)}[name]


def test_entry_points_and_dispatch():
    for name in AUX + ("reg_stage",):
        assert ttrainers.TRAINERS[name].__name__ == f"train_{name}"
        cli.check_supported(TrainConfig(model=name))
    with pytest.raises(ValueError, match="unknown model"):
        cli.check_supported(TrainConfig(model="nope"))
    if not torch.cuda.is_available():
        for name in AUX:
            with pytest.raises(RuntimeError, match="CUDA"):
                ttrainers.TRAINERS[name](TrainConfig(model=name), "x")
