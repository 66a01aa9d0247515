"""Port parity of hyperprior and joint-AR training against the JAX package,
on the CPU in fp32: the train forwards (``ScaleHyperprior`` with both
quantizers, ``JointAutoregressive``), ``make_hyperprior_train_step``
against ``jax.grad`` + optax, ``train_single_image`` with its checkpoints
(read by the JAX package, by ``load_hyperprior`` / ``load_joint`` and the
codec) and its exact resume, and ``eval_kodak`` on both models.

Weights: the port's seeded init at n = 16 (m = 24), every GDN moved off the
identity, carried to JAX by ``hyperprior_params_to_jax`` /
``joint_params_to_jax``; numpy-seeded 64×64 images, batch 2. Noise: JAX's
draws of ``rng_z, rng_y = split(key)`` (ẑ's, then ŷ's or y/σ's) handed to
the port. Stated tolerances: the forwards' tensors rtol 1e-5 / atol 1e-4
and rates rtol 1e-4 (the joint's P(ŷ) element by element to rtol 1e-5
and atol 3e-7, 2.5 ulp of 1, as ``test_torch_joint.py`` holds it: a
difference of two fp32 CDFs near 1 is rounding noise in the far tails,
where XLA's fp32 erf is not monotone and JAX's bpp_y can be NaN); a step's
loss rtol 1e-4, the clamped gradients
within 1e-4 of each tensor's largest |gradient|, the parameters within 5%
of one LR step where the gradient's sign is decided (|g| above 1e-3 of the
tensor's largest: Adam's first updates are about lr·sign(g)); the resume
bit-equal; eval bpp and MS-SSIM rtol 1e-4, PSNR 1e-3 dB.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from iclr_17_compression_tpu.eval.kodak import eval_kodak as jeval_kodak
from iclr_17_compression_tpu.models import cheng2020 as jc
from iclr_17_compression_tpu.models.hyperprior import ScaleHyperprior as JaxHyperprior
from iclr_17_compression_tpu.ops import quant as jquant
from iclr_17_compression_tpu.train import checkpoint as jckpt
from iclr_17_compression_tpu.train.state import _make_optimizer
from iclr_17_compression_tpu_torch.coding import codec_cli as tcli
from iclr_17_compression_tpu_torch.data.datasets import write_ppm
from iclr_17_compression_tpu_torch.eval.kodak import eval_kodak
from iclr_17_compression_tpu_torch.models import cheng2020 as tc
from iclr_17_compression_tpu_torch.models import hyperprior as thp
from iclr_17_compression_tpu_torch.models.cheng2020 import JointAutoregressive
from iclr_17_compression_tpu_torch.models.hyperprior import ScaleHyperprior
from iclr_17_compression_tpu_torch.ops import quant as tquant
from iclr_17_compression_tpu_torch.train import checkpoint as tckpt
from iclr_17_compression_tpu_torch.train import cli
from iclr_17_compression_tpu_torch.train.config import TrainConfig
from iclr_17_compression_tpu_torch.train.state import (build_model, create_train_state,
                                                       make_hyperprior_train_step)
from iclr_17_compression_tpu_torch.train.weights import (hyperprior_params_to_jax,
                                                         joint_params_to_jax, load_hyperprior,
                                                         load_joint, msgpack_dumps)
from test_torch_dsc_blocks import perturb_gdn_
from test_torch_hyperprior import image

N, M, HW, B, LAM, LR = 16, 24, 64, 2, 8192.0, 1e-4
ATOL, RTOL = 1e-4, 1e-5
RATE_RTOL = 1e-4
P_ATOL = 3e-7
GRAD_TOL = 1e-4  # of the tensor's largest |gradient|
PARAM_ATOL = 0.05 * LR
DECIDED = 1e-3
CASES = ("round", "sigma-norm", "joint")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the test workers do not oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def port_model(case: str, seed: int = 0):
    gen = torch.Generator().manual_seed(seed)
    model = (JointAutoregressive(N) if case == "joint" else ScaleHyperprior(N, M, quant=case))
    model.init_(gen)
    perturb_gdn_(model, gen)
    return model


def jax_model(case: str):
    return jc.JointAutoregressive(N) if case == "joint" else JaxHyperprior(N, M, quant=case)


def jax_tree(model, sd=None):
    """``model``'s parameters (or ``sd``, a state_dict of its keys) as the
    JAX tree, copied."""
    sd = model.state_dict() if sd is None else sd
    tree = (joint_params_to_jax(sd, N) if isinstance(model, JointAutoregressive)
            else hyperprior_params_to_jax(sd, N, M))
    return jax.tree_util.tree_map(lambda v: jnp.array(np.array(v)), tree)


def batch(seed: int) -> np.ndarray:
    return np.stack([image(seed), image(seed + 50)])


def jax_noise(case: str, key):
    """JAX's draws in the model's order: ẑ's, then ŷ's (or y/σ's)."""
    rng_z, rng_y = jax.random.split(key)
    c = N if case == "joint" else M
    shapes = ((B, HW // 64, HW // 64, N), (B, HW // 16, HW // 16, c))
    return [np.array(jquant.add_uniform_noise(jnp.zeros(s, jnp.float32), k, 0.5))
            for s, k in zip(shapes, (rng_z, rng_y))]


def inject(monkeypatch, queue):
    monkeypatch.setattr(tquant, "add_uniform_noise",
                        lambda x, generator, half_width: x + torch.from_numpy(queue.pop(0)))


def _joint_probs(out, mod):
    """The joint model's P(ŷ) element by element, with ``mod``'s CDF."""
    delta = out["latent"] - out["mu"]
    return mod.normal_cdf((delta + 0.5) / out["sigma"]) - mod.normal_cdf(
        (delta - 0.5) / out["sigma"])


def compare_forward(out, ref, case: str) -> None:
    assert set(out) == set(ref)
    for key in out:
        if not key.startswith("bpp"):
            np.testing.assert_allclose(out[key].detach().numpy(), np.asarray(ref[key]),
                                       rtol=RTOL, atol=ATOL, err_msg=key)
    np.testing.assert_allclose(float(out["bpp_z"]), float(ref["bpp_z"]), rtol=RATE_RTOL)
    if case != "joint":
        for key in ("bpp", "bpp_y"):
            np.testing.assert_allclose(float(out[key]), float(ref[key]), rtol=RATE_RTOL,
                                       err_msg=key)
        return
    prob_t = _joint_probs({k: v.detach() for k, v in out.items()}, tc).numpy()
    prob_j = np.asarray(_joint_probs(ref, jc))
    assert prob_t.min() >= 0.0 and np.isfinite(float(out["bpp_y"]))
    np.testing.assert_allclose(prob_t, prob_j, rtol=RTOL, atol=P_ATOL)
    if np.isfinite(float(ref["bpp_y"])):
        for key in ("bpp", "bpp_y"):
            np.testing.assert_allclose(float(out[key]), float(ref[key]), rtol=RATE_RTOL,
                                       err_msg=key)
    else:  # JAX's far-tail P < 0 (test_torch_joint.py)
        assert (prob_j < 0).any()


@pytest.mark.parametrize("case", CASES)
def test_train_forward_matches_jax(case, monkeypatch):
    model = port_model(case)
    x = batch(1)
    key = jax.random.PRNGKey(7)
    ref = jax_model(case).apply({"params": jax_tree(model)}, jnp.asarray(x), train=True,
                                rng=key)
    queue = jax_noise(case, key)
    inject(monkeypatch, queue)
    with torch.no_grad():
        out = model(torch.from_numpy(x), train=True)
    assert not queue, "the port drew fewer noises than JAX"
    compare_forward(out, ref, case)
    # the noise, not the rounding: the latents are off the integer grid
    lat = out["latent"] / (out["sigma"] if case == "sigma-norm" else 1.0)
    assert float((lat - torch.round(lat)).abs().max()) > 0.1


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


@pytest.mark.parametrize("case", CASES)
def test_train_steps_match_jax(case, monkeypatch):
    """Two steps of ``make_hyperprior_train_step`` against ``jax.grad`` of
    λ·mse + bpp and optax's clip(5) + Adam."""
    model = port_model(case, seed=2)
    jparams = jax_tree(model)
    jmodel = jax_model(case)
    tx = _make_optimizer(LR)
    opt_state = tx.init(jparams)

    def jloss(params, x, key):
        out = jmodel.apply({"params": params}, x, train=True, rng=key)
        return LAM * out["mse"] + out["bpp"], out

    grad_fn = jax.jit(jax.value_and_grad(jloss, has_aux=True))
    queue = []
    inject(monkeypatch, queue)
    state = create_train_state(model, lr=LR)
    step = make_hyperprior_train_step(LAM)
    undecided = {}
    for i in range(2):
        x = batch(10 + i)
        key = jax.random.PRNGKey(100 + i)
        (loss_j, out_j), grads_j = grad_fn(jparams, jnp.asarray(x), key)
        assert np.isfinite(float(loss_j))
        updates, opt_state = tx.update(grads_j, opt_state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        queue += jax_noise(case, key)
        metrics = step(state, torch.from_numpy(x), None)
        assert not queue and state.step == i + 1
        assert set(metrics) == {"rd_loss", "mse", "bpp", "bpp_y", "bpp_z"}
        np.testing.assert_allclose(float(metrics["rd_loss"]), float(loss_j), rtol=RATE_RTOL)
        for k in ("mse", "bpp", "bpp_y", "bpp_z"):
            np.testing.assert_allclose(float(metrics[k]), float(out_j[k]), rtol=RATE_RTOL,
                                       err_msg=k)
        grads_t = _flat(jax_tree(model, {k: p.grad if p.grad is not None else torch.zeros_like(p)
                                         for k, p in model.named_parameters()}))
        params_t, params_j = _flat(jax_tree(model)), _flat(jparams)
        for k, gj in _flat(grads_j).items():
            gj = np.clip(gj, -5.0, 5.0)  # the port's gradients are clamped in place
            top = max(float(np.abs(gj).max()), 1e-30)
            np.testing.assert_allclose(grads_t[k], gj, rtol=0, atol=GRAD_TOL * top,
                                       err_msg=f"step {i + 1} d{k}")
            undecided[k] = undecided.get(k, False) | (np.abs(gj) <= DECIDED * top)
            decided = ~undecided[k]
            np.testing.assert_allclose(params_t[k][decided], params_j[k][decided], rtol=0,
                                       atol=PARAM_ATOL, err_msg=f"step {i + 1} {k}")
    assert np.mean([np.mean(~u) for u in undecided.values()]) > 0.5


@pytest.fixture(scope="module")
def data_dirs(tmp_path_factory):
    d = tmp_path_factory.mktemp("data")
    rng = np.random.default_rng(0)
    for sub, n, (h, w) in (("train", 6, (80, 96)), ("test", 2, (64, 128))):
        os.makedirs(d / sub)
        for i in range(n):
            yy, xx = np.mgrid[0:h, 0:w] / 20.0
            img = 0.5 + 0.3 * np.sin(xx + rng.uniform(0, 6))[..., None] * rng.uniform(
                0.2, 1, 3) + 0.05 * rng.standard_normal((h, w, 3))
            write_ppm(str(d / sub / f"{i}.ppm"), np.clip(img, 0, 1))
    return str(d / "train"), str(d / "test")


def _cfg(data_dirs, root, model, **kw):
    base = dict(model=model, out_channel_n=N, out_channel_m=M, joint_n=N, batch_size=B,
                image_size=HW, print_freq=2, cal_step=1, tensorboard=False,
                train_dir=data_dirs[0], test_dir="", save_root=str(root))
    return TrainConfig(**{**base, **kw})


@pytest.mark.parametrize("model", ["hyperprior", "joint"])
def test_train_single_image_resumes_and_checkpoints(data_dirs, tmp_path, model):
    """4 steps in one run equal 2 + resume + 2 bit for bit; the iter
    checkpoint is the JAX package's param tree, and it and the train state
    load through the port's loaders into the codec CLI."""
    full = cli.train_single_image(_cfg(data_dirs, tmp_path, model, tot_step=4,
                                       save_model_freq=2, test_dir=data_dirs[1]),
                                  "full", device="cpu")
    half = _cfg(data_dirs, tmp_path, model, tot_step=2, save_model_freq=2)
    cli.train_single_image(half, "half", device="cpu")
    resumed = cli.train_single_image(dataclasses.replace(half, tot_step=4), "half",
                                     resume=str(tmp_path / "half"), device="cpu")
    assert full.step == resumed.step == 4
    for (k, a), b in zip(full.model.state_dict().items(), resumed.model.state_dict().values()):
        assert torch.equal(a, b), k
    sa, sb = full.optimizer.state_dict()["state"], resumed.optimizer.state_dict()["state"]
    for i in sa:
        for k in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(sa[i][k], sb[i][k])
    run = tmp_path / "full"
    rows = [json.loads(line) for line in open(run / "events.jsonl")]
    assert [r["step"] for r in rows if "rd_loss" in r] == [2, 4]
    assert all(np.isfinite(r["rd_loss"]) for r in rows if "rd_loss" in r)
    assert "KODAK step 4" in open(run / "train.log").read()

    # the JAX package reads the iter checkpoint over its own model's template
    jm = jax_model("joint" if model == "joint" else "round")
    template = jm.init({"params": jax.random.PRNGKey(0), "quant": jax.random.PRNGKey(1)},
                       jnp.zeros((1, 64, 64, 3)), train=False)
    restored = jckpt.load_params(template, str(run / "iter_4.ckpt"))
    want = _flat(jax.tree_util.tree_map(np.asarray, jax_tree(full.model)))
    got = _flat(jax.tree_util.tree_map(np.asarray, restored["params"]))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)

    # both files load in the port, and the codec codes with them exactly
    load = load_joint if model == "joint" else load_hyperprior
    img = image(3, 64, 128)
    src = tmp_path / "in.ppm"
    write_ppm(str(src), img)
    for name in ("iter_4.ckpt", "latest.ckpt"):
        loaded = load(str(run / name), device="cpu")
        for k, v in full.model.state_dict().items():
            assert torch.equal(loaded.state_dict()[k], v), (name, k)
        x = torch.from_numpy(tcli.pad_to_multiple(np.asarray(img, np.float32), 64)[None])
        mod = tc if model == "joint" else thp
        kw = {"backend": "numpy"} if model == "joint" else {}
        comp, y_enc = mod.compress(loaded, x, return_y_hat=True, **kw)
        _, y_dec = mod.decompress(loaded, comp, return_y_hat=True, **kw)
        assert np.array_equal(y_enc, y_dec)
        icz, out = tmp_path / f"{name}.icz", tmp_path / f"{name}.ppm"
        flags = ["--ckpt", str(run / name), "--n", str(N), "--device", "cpu"]
        tcli.main(["encode", str(src), str(icz), "--model", model, *flags,
                   *(["--m", str(M)] if model == "hyperprior" else [])])
        tcli.main(["decode", str(icz), str(out), *flags])
        assert out.stat().st_size == len(b"P6\n128 64\n255\n") + 64 * 128 * 3


@pytest.mark.parametrize("case", CASES)
def test_eval_kodak_matches_jax(case):
    model = port_model(case, seed=4)
    images = [image(20), image(21, 64, 128)]
    ours = eval_kodak(model, images)
    ref = jeval_kodak(jax_model(case), {"params": jax_tree(model)}, images)
    for got, want in zip(ours["per_image"] + [ours], ref["per_image"] + [ref]):
        np.testing.assert_allclose(got["psnr"], want["psnr"], atol=1e-3)
        np.testing.assert_allclose(got["ms_ssim"], want["ms_ssim"], rtol=1e-4)
        np.testing.assert_allclose(got["ms_ssim_db"], want["ms_ssim_db"], rtol=1e-4)
        if np.isfinite(want["bpp"]):
            np.testing.assert_allclose(got["bpp"], want["bpp"], rtol=1e-4)
        else:  # the joint's far-tail NaN in JAX (test_torch_joint.py)
            assert case == "joint" and np.isfinite(got["bpp"])
    with pytest.raises(ValueError, match="Ballé-17"):
        eval_kodak(model, images, use_rans=True)


def test_build_model_reads_the_config_as_jax_does():
    for quant, want in (("noise-round", "round"), ("round", "round"),
                        ("sigma-norm", "sigma-norm")):
        built = build_model("hyperprior", device="cpu", out_channel_n=N, out_channel_m=M,
                            quant=quant)
        assert (built.quant, built.out_channel_n, built.out_channel_m) == (want, N, M)
    assert build_model("joint", device="cpu", n=N).n == N
    default = build_model("hyperprior", device="cpu")
    assert (default.out_channel_n, default.out_channel_m) == (192, 320)
    a = build_model("joint", device="cpu", n=N, seed=3).state_dict()
    b = build_model("joint", device="cpu", n=N, seed=3).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    cli.check_supported(TrainConfig(model="hyperprior"))
    cli.check_supported(TrainConfig(model="joint"))


@pytest.mark.parametrize("model,autotune", [("balle17", False), ("hyperprior", False),
                                            ("joint", True)])
def test_models_declare_their_training_cudnn_policy(model, autotune):
    """The training loop reads ``train_cudnn_autotune`` off the model: only
    the joint's 3×3 convs at C = 192 need cuDNN's algorithms chosen by timing."""
    built = build_model(model, device="cpu", out_channel_n=N, out_channel_m=M, n=N)
    assert getattr(built, "train_cudnn_autotune", False) is autotune


@pytest.mark.parametrize("case", ["round", "joint"])
def test_pretrain_loads_the_leaves_a_file_holds(case, tmp_path):
    """``--pretrain`` (``load_params_partial``) of a JAX file holding only
    the analysis transform: those parameters load, every other keeps its
    value."""
    src, dst = port_model(case, seed=5), port_model(case, seed=6)
    tree = jax.tree_util.tree_map(np.asarray, jax_tree(src))
    path = tmp_path / "g_a.msgpack"
    path.write_bytes(msgpack_dumps({"params": {"g_a": tree["g_a"]}}))
    before = {k: v.clone() for k, v in dst.state_dict().items()}
    tckpt.load_params_partial(dst, str(path))
    top = "g_a." if case == "joint" else "Encoder."
    for k, v in dst.state_dict().items():
        assert torch.equal(v, src.state_dict()[k] if k.startswith(top) else before[k]), k
    assert any(k.startswith(top) for k in before)
