"""The port's DSC training loops on the CPU: a step of the residual stage's
trainer ``reg_stage`` against the JAX package's, ``train_dsc`` end to end
(its checkpoints, the off-cycle best, the plateau LR and an exact resume),
the auxiliary trainers' epoch loop and stereo source against JAX's, the DSC
checkpoint loaders, and what the trainers refuse.

The ``reg_stage`` trainers of both packages hard-code ``temp_0031bpp`` and
``reg_0_0625`` at n = 128; here both packages' preset tables map those names
to ``tiny`` / ``tiny_reg`` for the test. Each trainer's epoch loop is
replaced by a capture of its state and step, which the test drives on the
same two batches, with JAX's noise handed to the port (as in
``test_torch_dsc_train.py``). Stated tolerances: the loss to rtol 1e-4, the
parameters to 5% of one LR step where the port's gradient is decided
(above 1e-3 of its tensor's largest at both steps); the gradients
themselves are held for ``tiny_reg`` by ``test_torch_dsc_train.py``. The
frozen base is bit-unchanged.

``train_dsc`` runs on KITTI-layout PNG frames with the loader's crop cut to
64×64 (the loop, not the crop, is under test: the KITTI crop itself is held
by ``test_torch_stereo_data.py``); everything else is bit-exact on the CPU.
"""

import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch
from flax import serialization
from PIL import Image

from iclr_17_compression_tpu.models import DSC_PRESETS as JAX_PRESETS
from iclr_17_compression_tpu.train import trainers as jtrainers
from iclr_17_compression_tpu.train.config import TrainConfig as JaxTrainConfig
from iclr_17_compression_tpu.train.state import TrainState as JaxTrainState
from iclr_17_compression_tpu_torch.coding import codec_cli as tcli
from iclr_17_compression_tpu_torch.data.datasets import StereoKittiDataset
from iclr_17_compression_tpu_torch.models.dsc import DSC_PRESETS, DSCStereoModel
from iclr_17_compression_tpu_torch.train import checkpoint as tckpt
from iclr_17_compression_tpu_torch.train import cli
from iclr_17_compression_tpu_torch.train import trainers as ttrainers
from iclr_17_compression_tpu_torch.train.config import TrainConfig
from iclr_17_compression_tpu_torch.train.state import build_model, create_train_state
from iclr_17_compression_tpu_torch.train.weights import (dsc_params_to_jax, load_dsc,
                                                         msgpack_dumps)
from test_torch_dsc_train import (LR, PARAM_ATOL, DECIDED, LOSS_RTOL, _flat, _images, _inject,
                                  _jtree, _model, _noises, _noise_shapes)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: at these sizes it is faster than many, and the
    test workers do not oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _frame(rng, h, w):
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.full((h, w, 3), 0.5, np.float32)
    for _ in range(3):
        f = rng.uniform(-3, 3, 2) / np.array([h, w])
        img += rng.uniform(0.05, 0.2, 3).astype(np.float32) * np.cos(
            2 * np.pi * (f[0] * yy + f[1] * xx) + rng.uniform(0, 6))[..., None]
    return np.clip(img + 0.03 * rng.standard_normal((h, w, 3)), 0, 1)


def _kitti_root(root, frames, h=72, w=104, seed=0):
    """A KITTI-layout root: image_2/image_3 pairs 0000NN_10.png and _11.png."""
    rng = np.random.default_rng(seed)
    for side in ("image_2", "image_3"):
        os.makedirs(os.path.join(root, side), exist_ok=True)
    for i in range(frames):
        for t in (10, 11):
            a = _frame(rng, h, w)
            b = np.roll(a, 3, axis=1)
            for side, img in (("image_2", a), ("image_3", b)):
                Image.fromarray(np.round(img * 255).astype(np.uint8)).save(
                    os.path.join(root, side, f"{i:06d}_{t}.png"))
    return str(root)


@pytest.fixture(scope="module")
def kitti(tmp_path_factory):
    d = tmp_path_factory.mktemp("kitti")
    return _kitti_root(d / "train", 2), _kitti_root(d / "test", 1, seed=1)


def test_reg_stage_step_matches_jax(kitti, tmp_path, monkeypatch):
    for table, base, reg in ((JAX_PRESETS, "tiny", "tiny_reg"), (DSC_PRESETS, "tiny", "tiny_reg")):
        monkeypatch.setitem(table, "temp_0031bpp", table[base])
        monkeypatch.setitem(table, "reg_0_0625", table[reg])
    base, reg = _model("tiny", seed=0), _model("tiny_reg", seed=1)
    frozen = str(tmp_path / "base.msgpack")
    with open(frozen, "wb") as f:
        f.write(msgpack_dumps(dsc_params_to_jax(base.state_dict(), base.config)))

    captured = {}

    def capture(pkg):
        def run_epochs(cfg, name, dataset, state, step_fn, *args, **kw):
            captured[pkg] = (state, step_fn)
            return state
        return run_epochs

    monkeypatch.setattr(jtrainers, "_run_epochs", capture("jax"))
    monkeypatch.setattr(jtrainers, "_state_with_lr", lambda model, rng, ex, cfg, **kw: (
        JaxTrainState.create(apply_fn=model.apply, params=_jtree(reg),
                             tx=jtrainers._injectable_optimizer(cfg.lr_base, cfg.grad_clip))))
    # the frozen base straight from its file (JAX's own loader inits a model
    # first, which takes minutes in eager flax)
    monkeypatch.setattr(jtrainers, "_load_frozen", lambda model, rng, ex, pretrain, **kw: (
        serialization.msgpack_restore(open(pretrain, "rb").read())))
    monkeypatch.setattr(ttrainers, "_run_epochs", capture("port"))
    real_make_step = ttrainers.make_reg_stage_step
    monkeypatch.setattr(ttrainers, "make_reg_stage_step", lambda frozen_base: (
        captured.setdefault("base", frozen_base), real_make_step(frozen_base))[1])
    kw = dict(model="reg_stage", train_dir=kitti[0], batch_size=2, lr_base=LR,
              save_root=str(tmp_path))
    jtrainers.train_reg_stage(JaxTrainConfig(**kw), "jax", pretrain=frozen)
    ttrainers.train_reg_stage(TrainConfig(**kw), "port", pretrain=frozen, device="cpu")
    jstate, jstep = captured["jax"]
    state, step = captured["port"]
    state.model.load_state_dict(reg.state_dict())
    base_before = base.state_dict()
    port_base = captured["base"]  # the frozen base the step runs
    assert isinstance(port_base, DSCStereoModel) and not port_base.training
    assert all(not p.requires_grad for p in port_base.parameters())
    trained = {id(p) for g in state.optimizer.param_groups for p in g["params"]}
    assert trained == {id(p) for p in state.model.parameters()}

    queue = []
    _inject(monkeypatch, queue)
    undecided = {}
    for i in range(2):
        im1, im2 = _images(20 + i)
        rng = jax.random.PRNGKey(200 + i)
        queue += _noises(JAX_PRESETS["tiny_reg"], {"params": jstate.params}, rng,
                         _noise_shapes(reg.config))
        jstate, jm = jstep(jstate, (im1, im2), rng)
        metrics = step(state, (im1, im2), None)
        assert not queue
        np.testing.assert_allclose(float(metrics["loss"]), float(jm["loss"]), rtol=LOSS_RTOL)
        grads = _flat(dsc_params_to_jax({k: p.grad for k, p in state.model.named_parameters()},
                                        reg.config))
        params_t = _flat(dsc_params_to_jax(state.model.state_dict(), reg.config))
        for k, pj in _flat(jstate.params).items():
            g = np.clip(grads[k], -5, 5)
            undecided[k] = undecided.get(k, False) | (np.abs(g) <= DECIDED * np.abs(g).max())
            np.testing.assert_allclose(params_t[k][~undecided[k]], pj[~undecided[k]], rtol=0,
                                       atol=PARAM_ATOL, err_msg=f"step {i + 1} {k}")
    assert np.mean([np.mean(~u) for u in undecided.values()]) > 0.5
    for k, v in port_base.state_dict().items():
        assert torch.equal(v, base_before[k]), k


@pytest.mark.parametrize("tot_step", [100, 5], ids=["tot_epoch", "tot_step"])
def test_run_epochs_writes_what_jax_writes(tmp_path, tot_step):
    """The auxiliary trainers' epoch loop against JAX's, with scripted epoch
    losses (patience 0, so the plateau cuts the LR): the same checkpoint
    files with the same sidecar epochs and losses, and the same final LR.
    With ``tot_step`` 5 both stop one step into epoch 2. Exact but for the
    LR, which JAX keeps in float32 (rtol 1e-6)."""
    import jax.numpy as jnp

    per_epoch, epoch_losses = 2, [3.0, 1.0, 2.0, 0.5, 0.7]
    dataset = [np.zeros(2, np.float32)] * (2 * per_epoch)
    kw = dict(batch_size=2, lr_base=1e-4, plateau_patience=0, tot_epoch=len(epoch_losses),
              tot_step=tot_step, print_freq=1)
    calls = {"jax": 0, "port": 0}

    def loss_of(pkg):
        calls[pkg] += 1
        return epoch_losses[(calls[pkg] - 1) // per_epoch]

    jstate = JaxTrainState.create(apply_fn=None, params={"w": jnp.zeros(2)},
                                  tx=jtrainers._injectable_optimizer(1e-4, 5.0))
    jstate = jtrainers._run_epochs(
        JaxTrainConfig(save_root=str(tmp_path), **kw), "jax", dataset, jstate,
        lambda state, batch, rng: (state, {"loss": jnp.float32(loss_of("jax"))}),
        jax.random.PRNGKey(0),
        save_every=2)
    state = ttrainers._run_epochs(
        TrainConfig(save_root=str(tmp_path), **kw), "port", dataset,
        create_train_state(torch.nn.Linear(2, 1), lr=1e-4),
        lambda state, batch, gen: {"loss": torch.tensor(loss_of("port"))},
        torch.device("cpu"), save_every=2)
    assert calls["jax"] == calls["port"] == min(tot_step, per_epoch * len(epoch_losses))
    names = sorted(os.listdir(tmp_path / "jax"))
    assert sorted(os.listdir(tmp_path / "port")) == names
    assert {"best_train.ckpt", "epoch_0.ckpt", "epoch_2.ckpt"} <= set(names)
    for name in (n for n in names if n.endswith(".json")):
        jmeta = json.load(open(tmp_path / "jax" / name))
        meta = json.load(open(tmp_path / "port" / name))
        assert (meta["epoch"], meta["loss"]) == (jmeta["epoch"], jmeta["loss"]), name
    jlr = float(jstate.opt_state[1].hyperparams["learning_rate"])
    assert state.schedule(state.step) == pytest.approx(jlr, rel=1e-6)
    assert jlr < 1e-4  # the plateau cut it


def test_run_epochs_refuses_a_dataset_smaller_than_a_batch(tmp_path):
    """Fewer items than a batch give no step: the loop raises before its
    first epoch ends, with no step run and no checkpoint written."""
    steps = []
    cfg = TrainConfig(save_root=str(tmp_path), batch_size=4, tot_epoch=3, print_freq=1)
    with pytest.raises(ValueError, match="no batch of 4"):
        ttrainers._run_epochs(cfg, "small", [np.zeros(2, np.float32)] * 3,
                              create_train_state(torch.nn.Linear(2, 1), lr=1e-4),
                              lambda state, batch, gen: steps.append(1) or {"loss": 0.0},
                              torch.device("cpu"))
    assert not steps
    assert os.listdir(tmp_path / "small") == []


def test_stereo_sources_of_the_trainers(kitti, tmp_path):
    """``make_stereo_dataset`` follows ``cfg.dataset``; the auxiliary
    trainers' ``_kitti`` reads KITTI for anything but pairs, and crops the
    pairs square at ``image_size`` floored to ×32, as JAX's does."""
    left = os.path.join(kitti[0], "image_2")
    right = os.path.join(kitti[0], "image_3")
    kit = TrainConfig(train_dir=kitti[0], dataset="kitti")
    assert isinstance(ttrainers.make_stereo_dataset(kit), StereoKittiDataset)
    holo = dataclasses.replace(kit, dataset="holopix")
    assert isinstance(ttrainers._kitti(holo), StereoKittiDataset)
    pairs = TrainConfig(train_dir=f"{left},{right}", dataset="pairs", image_size=70)
    jpairs = JaxTrainConfig(train_dir=f"{left},{right}", dataset="pairs", image_size=70)
    for port, ref in ((ttrainers._kitti(pairs), jtrainers._kitti(jpairs)),
                      (ttrainers._kitti(kit), jtrainers._kitti(JaxTrainConfig(
                          train_dir=kitti[0], dataset="kitti")))):
        for a, b in zip(port[0], ref[0]):
            np.testing.assert_array_equal(a, np.asarray(b))
    assert ttrainers._kitti(pairs)[0][0].shape[:2] == (64, 64)
    with pytest.raises(ValueError, match="unknown stereo dataset"):
        ttrainers.make_stereo_dataset(dataclasses.replace(kit, dataset="nope"))


def _dsc_cfg(kitti, root, **kw):
    base = dict(model="dsc:tiny", batch_size=2, lr_base=1e-4, print_freq=1,
                tensorboard=False, train_dir=kitti[0], test_dir=kitti[1],
                save_root=str(root), num_workers=0)
    base.update(kw)
    return TrainConfig(**base)


@pytest.fixture
def small_crops(monkeypatch):
    """The KITTI loader at 64×64 crops."""
    monkeypatch.setattr(cli, "make_stereo_dataset", lambda cfg: StereoKittiDataset(
        cfg.train_dir.split(","), train=True, crop=(64, 64), seed=cfg.seed))


def _scripted_losses(monkeypatch, per_epoch, epoch_losses, seen):
    """The real DSC step, with the loss the loop sees replaced by
    ``epoch_losses[epoch]`` (to drive the plateau and the best epoch), and
    the parameters after each step kept in ``seen`` by global step."""
    real = cli.make_dsc_train_step

    def make(*a, **k):
        step = real(*a, **k)

        def scripted(state, im1, im2, generator):
            metrics = step(state, im1, im2, generator)
            seen[state.step] = {k: v.clone() for k, v in state.model.state_dict().items()}
            metrics["loss"] = torch.tensor(epoch_losses[(state.step - 1) // per_epoch])
            return metrics

        return scripted

    monkeypatch.setattr(cli, "make_dsc_train_step", make)


def test_train_dsc_checkpoints_plateau_and_resume(kitti, tmp_path, monkeypatch, small_crops):
    per_epoch = 2  # 2 frames × 2 times, batch 2
    losses, seen = [3.0, 1.0, 2.0, 2.5], {}
    _scripted_losses(monkeypatch, per_epoch, losses, seen)
    cfg = _dsc_cfg(kitti, tmp_path, tot_epoch=4, save_epoch_freq=2, plateau_patience=0)
    full = cli.train_dsc(cfg, "full", device="cpu")
    run = tmp_path / "full"
    assert full.step == 4 * per_epoch
    assert {"best_train.ckpt", "best_val.ckpt", "latest.ckpt", "epoch_0.ckpt", "train.log",
            "events.jsonl"} <= set(os.listdir(run))
    for name in ("best_train", "best_val", "latest", "epoch_0"):
        meta = json.load(open(run / f"{name}.ckpt.json"))
        assert {"epoch", "loss", "step"} <= set(meta), name
    # the best epoch (1) is off the save cycle (every 2): written at epoch 2,
    # it holds epoch 1's weights, not the live ones
    best = json.load(open(run / "best_train.ckpt.json"))
    assert (best["epoch"], best["loss"], best["step"]) == (1, 1.0, 2 * per_epoch)
    blob = torch.load(run / "best_train.ckpt", weights_only=True)
    for k, v in seen[2 * per_epoch].items():
        assert torch.equal(blob["model"][k], v), k
    assert not all(torch.equal(blob["model"][k], v) for k, v in seen[4 * per_epoch].items())
    latest = json.load(open(run / "latest.ckpt.json"))
    # plateau (patience 0): epochs 2 and 3 did not improve on 1.0
    assert latest == {"epoch": 3, "loss": 2.5, "step": 8, "next_epoch": 4,
                      "lr": pytest.approx(1e-6), "plateau_best": 1.0, "plateau_bad": 0}
    val = json.load(open(run / "best_val.ckpt.json"))
    assert np.isfinite(val["loss"]) and val["loss"] > 0

    # two epochs, then --resume for two more: the same weights, bit for bit
    half = cli.train_dsc(dataclasses.replace(cfg, tot_epoch=2), "half", device="cpu")
    assert half.step == 2 * per_epoch
    resumed = cli.train_dsc(cfg, "half", resume=str(tmp_path / "half"), device="cpu")
    assert resumed.step == full.step
    assert resumed.schedule(0) == full.schedule(0) == pytest.approx(1e-6)
    for (k, a), b in zip(full.model.state_dict().items(), resumed.model.state_dict().values()):
        assert torch.equal(a, b), k
    sa, sb = full.optimizer.state_dict()["state"], resumed.optimizer.state_dict()["state"]
    assert all(torch.equal(sa[i][k], sb[i][k]) for i in sa for k in ("exp_avg", "exp_avg_sq",
                                                                     "step"))


def test_trained_dsc_checkpoint_codes_through_the_cli(kitti, tmp_path, small_crops):
    cfg = _dsc_cfg(kitti, tmp_path, tot_epoch=1, test_dir="")
    state = cli.train_dsc(cfg, "run", device="cpu")
    ckpt = str(tmp_path / "run" / "best_train.ckpt")
    loaded = load_dsc(ckpt, "tiny", device="cpu")
    for k, v in state.model.state_dict().items():
        assert torch.equal(loaded.state_dict()[k], v), k
    left = os.path.join(kitti[1], "image_2", "000000_10.png")
    right = os.path.join(kitti[1], "image_3", "000000_10.png")
    out = tmp_path / "a.icz"
    tcli.main(["encode", left, str(out), "--model", "tiny", "--ckpt", ckpt, "--device", "cpu"])
    tcli.main(["decode", str(out), str(tmp_path / "a.ppm"), "--ckpt", ckpt, "--si", right,
               "--device", "cpu"])
    img = np.asarray(Image.open(left), np.float32) / 255.0
    data = out.read_bytes()
    assert data == tcli.encode_image(img, loaded, device="cpu")
    rec = tcli.decode_image(data, loaded, device="cpu",
                            si_image=np.asarray(Image.open(right), np.float32) / 255.0)
    got = np.asarray(Image.open(tmp_path / "a.ppm"), np.float32) / 255.0
    assert got.shape == img.shape and np.abs(got - rec).max() <= 0.5 / 255 + 1e-6
    # two-stage: the port's train state as --reg-ckpt beside a JAX-layout base
    base_path = str(tmp_path / "base.msgpack")
    with open(base_path, "wb") as f:
        f.write(msgpack_dumps(dsc_params_to_jax(loaded.state_dict(), loaded.config)))
    reg = build_model("dsc:tiny_reg", device="cpu", seed=3)
    reg_state = create_train_state(reg, lr=1e-4)
    reg_ckpt = tckpt.save_train_state(reg_state, str(tmp_path), "reg")
    tcli.main(["encode", left, str(tmp_path / "b.icz"), "--model", "tiny", "--ckpt", base_path,
               "--reg-model", "tiny_reg", "--reg-ckpt", reg_ckpt, "--device", "cpu"])
    assert (tmp_path / "b.icz").read_bytes() == tcli.encode_composite(img, loaded, reg,
                                                                       device="cpu")


def test_load_params_partial_maps_dsc_trees(tmp_path):
    src = _model("tiny", seed=4)
    tree = dsc_params_to_jax(src.state_dict(), src.config)
    # a JAX TrainState-like file: params beside other entries, g_s missing
    tree_part = {k: v for k, v in tree.items() if k != "g_s"}
    path = str(tmp_path / "part.msgpack")
    with open(path, "wb") as f:
        f.write(msgpack_dumps({"params": tree_part, "step": np.int32(7)}))
    dst = _model("tiny", seed=5)
    before = {k: v.clone() for k, v in dst.state_dict().items()}
    tckpt.load_params_partial(dst, path)
    for k, v in dst.state_dict().items():
        want = before[k] if k.startswith("g_s.") else src.state_dict()[k]
        assert torch.equal(v, want), k
    # the port's own train-state file, into a preset of other widths: the
    # keys and shapes that match load, the rest keep their values
    state_path = tckpt.save_train_state(create_train_state(src, lr=1e-4),
                                        str(tmp_path), "src")
    reg = _model("tiny_reg", seed=6)
    reg_before = {k: v.clone() for k, v in reg.state_dict().items()}
    tckpt.load_params_partial(reg, state_path)
    for k, v in reg.state_dict().items():
        shared = k in src.state_dict() and src.state_dict()[k].shape == v.shape
        assert torch.equal(v, src.state_dict()[k] if shared else reg_before[k]), k


def test_what_the_trainers_refuse(kitti, tmp_path):
    # hyperprior, joint and the fusion presets but fif_0031bpp train now
    # (test_torch_hyper_train.py, test_torch_fusion.py), and so do the
    # auxiliary trainers (test_torch_aux_trainers.py)
    with pytest.raises(NotImplementedError, match="Queue 3"):
        cli.check_supported(TrainConfig(model="dsc:fif_0031bpp"))
    for model in ("passr", "two_steps", "att_exp"):
        cli.check_supported(TrainConfig(model=model))
    left, right = (os.path.join(kitti[0], side) for side in ("image_2", "image_3"))
    state = ttrainers.TRAINERS["att_exp"](
        TrainConfig(model="att_exp", train_dir=f"{left},{right}", dataset="pairs", image_size=64,
                    batch_size=2, tot_step=1, save_root=str(tmp_path)), "x", device="cpu")
    assert state.step == 1 and os.path.exists(tmp_path / "x" / "best_train.ckpt")
    # a mesh trains (test_torch_mesh*.py), but not one larger than its devices
    with pytest.raises(ValueError, match="mesh 2x1 != 1 devices"):
        cli.train_dsc(_dsc_cfg(kitti, tmp_path, mesh_data=2), "x", device="cpu")
    with pytest.raises(ValueError, match="dsc:"):
        cli.train_dsc(_dsc_cfg(kitti, tmp_path, model="balle17"), "x", device="cpu")
    assert build_model("hyperprior", device="cpu", out_channel_n=16, out_channel_m=24).quant \
        == "round"
    for model in ("reg_stage", "dsc:temp_0031bpp", "hyperprior", "joint", "dsc:att_0031bpp",
                  "dsc:bottleneck_att_1bpp", "dsc:pam_0031bpp"):
        cli.check_supported(TrainConfig(model=model))
    if not torch.cuda.is_available():
        for call in (lambda: cli.train_dsc(_dsc_cfg(kitti, tmp_path), "x"),
                     lambda: ttrainers.train_reg_stage(_dsc_cfg(kitti, tmp_path), "x"),
                     lambda: build_model("dsc:tiny"),
                     lambda: load_dsc(str(tmp_path / "none.ckpt"), "tiny")):
            with pytest.raises(RuntimeError, match="CUDA"):
                call()
