"""The port's training loop end to end on the CPU, its checkpoints against
the JAX package's format, its exact resume, its Kodak eval against the JAX
eval, and what it refuses.

- ``save_params`` writes flax msgpack with the keys sorted, as the JAX
  training loop writes its (jit-returned) params: the archived lam2048
  checkpoint is rewritten byte for byte, and a JAX-written checkpoint loads
  in the port.
- 4 steps in one run equal 2 steps + checkpoint + ``--resume`` + 2 steps,
  bit for bit (CPU, fp32).
- ``eval_kodak`` equals the JAX ``eval_kodak`` on two 64×96 images: bpp
  (estimated) and MS-SSIM to rtol 1e-4, PSNR to 1e-3 dB; with ``use_rans``
  the stream sizes to 1% (the CDF tables may differ by a count).
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from iclr_17_compression_tpu.eval.kodak import eval_kodak as jeval_kodak
from iclr_17_compression_tpu.models.balle17 import Balle17Compressor as JBalle17
from iclr_17_compression_tpu.train import checkpoint as jckpt
from iclr_17_compression_tpu_torch.data.datasets import write_ppm
from iclr_17_compression_tpu_torch.eval.kodak import eval_kodak
from iclr_17_compression_tpu_torch.models.balle17 import Balle17Compressor
from iclr_17_compression_tpu_torch.ops.kernels import quant_pack_kernel as tk3
from iclr_17_compression_tpu_torch.train import checkpoint as tckpt
from iclr_17_compression_tpu_torch.train import cli
from iclr_17_compression_tpu_torch.train.config import TrainConfig
from iclr_17_compression_tpu_torch.train.weights import params_from_jax, params_to_jax

ROOT = os.path.join(os.path.dirname(__file__), "..")
N = 32


def _model(seed=0, n=N):
    return Balle17Compressor(n).init_(torch.Generator().manual_seed(seed))


def _tree_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], dict):
            _tree_equal(a[k], b[k])
        else:
            assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]))


def test_save_params_writes_flax_bytes(tmp_path):
    model = _model()
    path = tckpt.save_params(model, str(tmp_path), 7)
    assert os.path.basename(path) == "iter_7.ckpt" and tckpt.step_from_filename(path) == 7
    data = open(path, "rb").read()
    tree = params_to_jax(model.state_dict())
    _tree_equal(serialization.msgpack_restore(data), tree)
    assert data == serialization.msgpack_serialize(tree)
    # the JAX package's own loader restores it over a JAX model's template
    template = JBalle17(out_channel_n=N).init(
        {"params": jax.random.PRNGKey(0), "quant": jax.random.PRNGKey(1)},
        jnp.zeros((1, 32, 32, 3)), train=False)
    restored = jckpt.load_params(template, path)
    _tree_equal(jax.tree_util.tree_map(np.asarray, restored["params"]), tree)
    assert tckpt.latest_checkpoint(str(tmp_path)) == path
    archived = os.path.join(ROOT, "results", "ckpts", "lam2048_iter_19000.ckpt")
    again = tckpt.save_params(tckpt.load_params(Balle17Compressor(128), archived),
                              str(tmp_path), 19000)
    assert open(again, "rb").read() == open(archived, "rb").read()


def test_jax_checkpoint_loads_in_the_port(tmp_path):
    variables = JBalle17(out_channel_n=N).init(
        {"params": jax.random.PRNGKey(3), "quant": jax.random.PRNGKey(4)},
        jnp.zeros((1, 32, 32, 3)), train=False)
    path = jckpt.save_params(variables["params"], str(tmp_path), 12)
    model = tckpt.load_params(_model(), path)
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, variables["params"]))
    for k, v in model.state_dict().items():
        torch.testing.assert_close(v, want[k], rtol=0, atol=0)
    # partial: an encoder-only file loads the encoder and leaves the rest
    enc_only = {"encoder": jax.tree_util.tree_map(np.asarray, variables["params"]["encoder"])}
    part = str(tmp_path / "enc.ckpt")
    with open(part, "wb") as f:
        f.write(serialization.to_bytes(enc_only))
    fresh = _model(seed=9)
    before = {k: v.clone() for k, v in fresh.state_dict().items()}
    tckpt.load_params_partial(fresh, part)
    for k, v in fresh.state_dict().items():
        torch.testing.assert_close(v, want[k] if k.startswith("Encoder.") else before[k],
                                   rtol=0, atol=0)


@pytest.fixture(scope="module")
def data_dirs(tmp_path_factory):
    d = tmp_path_factory.mktemp("data")
    rng = np.random.default_rng(0)
    for sub, n, (h, w) in (("train", 6, (80, 96)), ("test", 2, (64, 96))):
        os.makedirs(d / sub)
        for i in range(n):
            yy, xx = np.mgrid[0:h, 0:w] / 20.0
            img = 0.5 + 0.3 * np.sin(xx + rng.uniform(0, 6))[..., None] * rng.uniform(
                0.2, 1, 3) + 0.05 * rng.standard_normal((h, w, 3))
            write_ppm(str(d / sub / f"{i}.ppm"), np.clip(img, 0, 1))
    return str(d / "train"), str(d / "test")


def _cfg(data_dirs, root, **kw):
    base = TrainConfig.from_json(os.path.join(ROOT, "examples", "balle17.json"))
    return dataclasses.replace(base, out_channel_n=N, batch_size=2, image_size=64,
                               print_freq=2, cal_step=1, tensorboard=False,
                               train_dir=data_dirs[0], test_dir="", save_root=str(root), **kw)


def test_resume_is_exact(data_dirs, tmp_path):
    full = cli.train_single_image(_cfg(data_dirs, tmp_path, tot_step=4, save_model_freq=2),
                                  "full", device="cpu")
    half_cfg = _cfg(data_dirs, tmp_path, tot_step=2, save_model_freq=2)
    cli.train_single_image(half_cfg, "half", device="cpu")
    meta = json.load(open(tmp_path / "half" / "latest.ckpt.json"))
    assert meta["step"] == 2 and meta["epoch"] == 0 and meta["batch_in_epoch"] == 2
    resumed = cli.train_single_image(dataclasses.replace(half_cfg, tot_step=4), "half",
                                     resume=str(tmp_path / "half"), device="cpu")
    assert full.step == resumed.step == 4
    for (k, a), b in zip(full.model.state_dict().items(), resumed.model.state_dict().values()):
        assert torch.equal(a, b), k
    sa, sb = full.optimizer.state_dict()["state"], resumed.optimizer.state_dict()["state"]
    for i in sa:
        for k in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(sa[i][k], sb[i][k])
    assert tckpt.resolve_resume(str(tmp_path / "half")).endswith("latest.ckpt")
    assert tckpt.resolve_resume(str(tmp_path / "nowhere")) is None


def test_train_single_image_end_to_end(data_dirs, tmp_path):
    cfg = _cfg(data_dirs, tmp_path, tot_step=6, save_model_freq=3, profile_start_step=1,
               profile_num_steps=2, profile_dir=str(tmp_path / "trace"))
    cfg = dataclasses.replace(cfg, test_dir=data_dirs[1])
    state = cli.train_single_image(cfg, "run1", device="cpu")
    run = tmp_path / "run1"
    assert state.step == 6
    assert {"train.log", "events.jsonl", "iter_3.ckpt", "iter_6.ckpt", "latest.ckpt",
            "latest.ckpt.json"} <= set(os.listdir(run))
    rows = [json.loads(line) for line in open(run / "events.jsonl")]
    train_rows = [r for r in rows if "rd_loss" in r]
    test_rows = [r for r in rows if "test/psnr" in r]
    assert [r["step"] for r in train_rows] == [2, 4, 6]
    assert [r["step"] for r in test_rows] == [3, 6]
    assert all(np.isfinite(r["rd_loss"]) for r in train_rows)
    assert "KODAK step 6" in open(run / "train.log").read()
    assert os.path.getsize(tmp_path / "trace" / "trace_1.json") > 0
    # the trained parameters are a JAX checkpoint the port's codec loads
    from iclr_17_compression_tpu_torch.train.weights import load_balle17

    loaded = load_balle17(str(run / "iter_6.ckpt"), device="cpu")
    for k, v in state.model.state_dict().items():
        assert torch.equal(loaded.state_dict()[k], v)


def test_cli_refuses_what_it_does_not_train(data_dirs, tmp_path):
    # the hyperprior and joint models train now (test_torch_hyper_train.py);
    # fif_0031bpp is refused as the JAX trainer fails it (ROADMAP Queue 3);
    # a mesh trains (test_torch_mesh.py), the hyperprior's over W-tiles too,
    # but not a mesh larger than its devices (one CPU device by default)
    for kw, err, match in (({"model": "dsc:fif_0031bpp"}, NotImplementedError, "Queue 3"),
                           ({"model": "hyperprior", "mesh_tile": 2}, ValueError,
                            "n_tile=2 exceeds 1 devices"),
                           ({"mesh_data": 2}, ValueError, "mesh 2x1 != 1 devices"),
                           ({"mesh_tile": 2}, ValueError, "n_tile=2 exceeds 1 devices")):
        with pytest.raises(err, match=match):
            cli.train_single_image(_cfg(data_dirs, tmp_path, tot_step=1, **kw), "x",
                                   device="cpu")
    # the auxiliary trainers train now (test_torch_aux_trainers.py), through
    # main's dispatch, not this loop
    cli.check_supported(_cfg(data_dirs, tmp_path, model="passr"))
    with pytest.raises(ValueError, match="passr"):
        cli.train_single_image(_cfg(data_dirs, tmp_path, tot_step=1, model="passr"), "x",
                               device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            cli.train_single_image(_cfg(data_dirs, tmp_path, tot_step=1), "x")
        with pytest.raises(RuntimeError, match="CUDA"):
            cli.main(["--config", os.path.join(ROOT, "examples", "balle17.json"), "-n", "x"])


@pytest.mark.parametrize("use_rans", [False, True])
def test_eval_kodak_matches_jax(use_rans):
    rng = np.random.default_rng(5)
    images = []
    for _ in range(2):
        yy, xx = np.mgrid[0:64, 0:96] / 15.0
        img = 0.5 + 0.25 * np.cos(xx + 2 * yy + rng.uniform(0, 6))[..., None] + \
            0.05 * rng.standard_normal((64, 96, 3))
        images.append(np.clip(img, 0, 1).astype(np.float32))
    model = _model(seed=2)
    jparams = {"params": jax.tree_util.tree_map(jnp.asarray, params_to_jax(model.state_dict()))}
    ours = eval_kodak(model, images, use_rans=use_rans)
    ref = jeval_kodak(JBalle17(out_channel_n=N), jparams, images, use_rans=use_rans)
    for got, want in zip(ours["per_image"] + [ours], ref["per_image"] + [ref]):
        np.testing.assert_allclose(got["bpp"], want["bpp"], rtol=1e-2 if use_rans else 1e-4)
        np.testing.assert_allclose(got["psnr"], want["psnr"], atol=1e-3)
        np.testing.assert_allclose(got["ms_ssim"], want["ms_ssim"], rtol=1e-4)
        np.testing.assert_allclose(got["ms_ssim_db"], want["ms_ssim_db"], rtol=1e-4)


def test_quantize_pack_16_bit_symbols():
    """The file codec's symbol store: uint16 sym + lim at lim 32767, rounding
    half to even and clamping, against numpy; 16 bits hold no more than
    65536 symbols."""
    rng = np.random.default_rng(6)
    x = (rng.standard_normal(4096) * 20000).astype(np.float32)
    x[:6] = [0.5, 1.5, -2.5, 40000.0, -40000.0, 32766.5]
    sym, deq = tk3.quantize_pack(torch.from_numpy(x), 1.0, 32767.0, bits=16)
    want = np.clip(np.rint(x), -32767, 32767)
    assert sym.dtype == torch.uint16
    np.testing.assert_array_equal(sym.numpy().astype(np.int64), want.astype(np.int64) + 32767)
    np.testing.assert_array_equal(deq.numpy(), want.astype(np.float32))
    with pytest.raises(ValueError):
        tk3.lim_of(1.0, 32768.0, bits=16)
