"""The training mesh of the port (``parallel/mesh.py``'s data axis,
``train/dryrun.py``, the training CLI over a mesh) against the JAX
package, on the CPU: ``training_mesh`` and ``put_batch`` against JAX's
(8 virtual JAX devices, ``["cpu"] * n`` for the port), the whole batch's
noise cut for each slot, MS-SSIM pooled from per-level sums against JAX's
whole-batch MS-SSIM, K2's autograd Function at a tile's padding pair
against ``jax.grad`` of the JAX package's conv + GDN, the port's
``dryrun_multichip`` on ``["cpu"] * 8``, ``train_single_image`` on a 2×2
mesh (the hyperprior and joint on 1×2 W-tiles) with an exact resume, and
what the CLI refuses.

Stated tolerances: the split helpers and the noise exact; MS-SSIM to rtol
1e-5 (fp32 means in another order); K2's gradients to 1e-4 of each
tensor's largest (as ``test_torch_train.py`` holds a step's); the resume
bit-equal.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iclr_17_compression_tpu.ops.gdn import PEDESTAL, GDNParams
from iclr_17_compression_tpu.ops.metrics import ms_ssim as jms_ssim
from iclr_17_compression_tpu.ops.pallas.conv_gdn_kernel import _ref_conv_gdn
from iclr_17_compression_tpu.parallel import mesh as jmesh
from iclr_17_compression_tpu_torch.data.datasets import write_ppm
from iclr_17_compression_tpu_torch.ops import quant as tquant
from iclr_17_compression_tpu_torch.ops.kernels import conv_gdn_kernel as tk2
from iclr_17_compression_tpu_torch.ops.metrics import ms_ssim, ms_ssim_of_sums, ms_ssim_sums
from iclr_17_compression_tpu_torch.parallel import mesh as tmesh
from iclr_17_compression_tpu_torch.train import cli
from iclr_17_compression_tpu_torch.train.config import TrainConfig
from iclr_17_compression_tpu_torch.train.dryrun import dryrun_multichip

ROOT = os.path.join(os.path.dirname(__file__), "..")
MS_RTOL = 1e-5
GRAD_TOL = 1e-4  # of the tensor's largest |gradient|


def _cpu(n):
    return ["cpu"] * n


@pytest.mark.parametrize("batch,n_data,n_tile", [
    (8, None, 1), (8, None, 2), (6, None, 1), (6, None, 2), (5, None, 1), (8, 2, 2),
    (8, 4, 2), (4, 1, 1)])
def test_training_mesh_matches_jax(batch, n_data, n_tile):
    """``n_data=None`` takes the largest divisor of the batch that the
    devices allow, an explicit one is kept, as in JAX."""
    want = jmesh.training_mesh(batch, n_data, n_tile, jax.devices()[:8]).devices.shape
    got = tmesh.training_mesh(batch, n_data, n_tile, _cpu(8))
    assert got.devices.shape == want
    assert got.shape == {"data": want[0], "tile": want[1]}


@pytest.mark.parametrize("batch,n_data,n_tile,match", [
    (8, 3, 1, "not divisible by mesh data=3"), (8, None, 16, "exceeds 8 devices"),
    (8, 4, 4, "mesh 4x4 != 8 devices")])
def test_training_mesh_errors_match_jax(batch, n_data, n_tile, match):
    with pytest.raises(ValueError, match=match):
        jmesh.training_mesh(batch, n_data, n_tile, jax.devices()[:8])
    with pytest.raises(ValueError, match=match):
        tmesh.training_mesh(batch, n_data, n_tile, _cpu(8))


def test_training_mesh_defaults_to_the_cuda_devices():
    if torch.cuda.is_available():
        mesh = tmesh.training_mesh(torch.cuda.device_count())
        assert mesh.devices[0, 0] == torch.device("cuda", 0)
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            tmesh.training_mesh(4)


def test_put_batch_matches_jax_shards():
    """Part (r, t) of ``put_batch`` is the shard JAX's ``put_batch`` puts on
    the device at mesh position (r, t); a W that the tiles do not divide
    splits ragged in whole units."""
    x = np.random.default_rng(0).standard_normal((8, 16, 64, 3)).astype(np.float32)
    jm = jmesh.training_mesh(8, 4, 2, jax.devices()[:8])
    where = {d: (r, t) for (r, t), d in np.ndenumerate(jm.devices)}
    parts = tmesh.put_batch(tmesh.make_mesh(4, 2, _cpu(8)), x, unit=16)
    assert [len(row) for row in parts] == [2] * 4
    shards = jmesh.put_batch(jm, jnp.asarray(x)).addressable_shards
    assert len(shards) == 8
    for shard in shards:
        r, t = where[shard.device]
        np.testing.assert_array_equal(parts[r][t].numpy(), np.asarray(shard.data))
    ragged = tmesh.put_batch(tmesh.make_mesh(2, 2, _cpu(4)), x[:, :, :48], unit=16)
    assert [t.shape[2] for t in ragged[0]] == [32, 16]
    np.testing.assert_array_equal(torch.cat(ragged[1], dim=2).numpy(), x[4:, :, :48])
    assert [p.shape[0] for p in tmesh.batch_split(torch.from_numpy(x),
                                                  tmesh.make_mesh(4, 2, _cpu(8)))] == [2] * 4
    with pytest.raises(ValueError, match="tile unit 16"):
        tmesh.put_batch(tmesh.make_mesh(2, 2, _cpu(4)), x[:, :, :40], unit=16)
    with pytest.raises(ValueError, match="not divisible by mesh data=3"):
        tmesh.batch_and_tile_split(torch.from_numpy(x), tmesh.make_mesh(3, 1, _cpu(3)))


def test_mesh_noise_cuts_the_whole_batch_draw():
    """Each slot's noise is its rows and columns of the one-device step's
    draw, made once from the same generator in the same order, at every
    resolution the model noises (here the image's and a ÷16 latent's)."""
    n, h, w = 4, 32, 64
    gen = lambda: torch.Generator().manual_seed(3)  # noqa: E731
    g = gen()
    want = [tquant.uniform_noise((n, h, w, 3), g, 0.5, "cpu", torch.float32),
            tquant.uniform_noise((n, h // 16, w // 16, 8), g, 8.0, "cpu", torch.float32)]
    whole = tquant.MeshNoise(gen(), (n, h, w))
    slots = {(r, t): whole.slot(slice(2 * r, 2 * r + 2), slice(32 * t, 32 * t + 32))
             for r in range(2) for t in range(2)}
    for k, (c, div, half) in enumerate(((3, 1, 0.5), (8, 16, 8.0))):
        for (r, t), slot in slots.items():
            x = torch.zeros((2, h // div, 32 // div, c))
            got = tquant.add_uniform_noise(x, slot, half)
            cols = slice(32 * t // div, 32 * (t + 1) // div)
            assert torch.equal(got, want[k][2 * r:2 * r + 2, :, cols])
    assert len(whole.drawn) == 2
    with pytest.raises(ValueError, match="do not fall on its grid"):
        odd = tquant.MeshNoise(gen(), (n, h, w)).slot(slice(0, 2), slice(0, 8))
        tquant.add_uniform_noise(torch.zeros((2, 2, 1, 3)), odd, 0.5)


def test_ms_ssim_pools_from_per_level_sums():
    """The whole batch's MS-SSIM from its parts' per-level sums (each part
    some of the images, each image whole) equals JAX's MS-SSIM of the
    whole batch; the mean of the parts' MS-SSIMs does not."""
    rng = np.random.default_rng(4)
    a = rng.uniform(0, 1, (8, 64, 96, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.2, a.shape), 0, 1).astype(np.float32)
    b[4:] = np.clip(a[4:] + rng.normal(0, 0.02, a[4:].shape), 0, 1)
    want = float(jms_ssim(jnp.asarray(a), jnp.asarray(b), win_size=7))
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    sums, counts = None, None
    for p in range(4):
        s, c = ms_ssim_sums(ta[2 * p:2 * p + 2], tb[2 * p:2 * p + 2], win_size=7)
        sums = s if sums is None else sums + s
        counts = c if counts is None else tuple(x + y for x, y in zip(counts, c))
    np.testing.assert_allclose(float(ms_ssim_of_sums(sums, counts)), want, rtol=MS_RTOL)
    np.testing.assert_allclose(float(ms_ssim(ta, tb, win_size=7)), want, rtol=MS_RTOL)
    mean = np.mean([float(ms_ssim(ta[2 * p:2 * p + 2], tb[2 * p:2 * p + 2], win_size=7))
                    for p in range(4)])
    assert abs(mean - want) > 10 * MS_RTOL * abs(want)


@pytest.mark.parametrize("k,s,p,inverse", [(5, 2, 2, False), (9, 4, 4, True), (3, 1, 1, False)])
def test_conv_gdn_gradients_at_a_padding_pair_match_jax(k, s, p, inverse):
    """K2's autograd Function on a tile with its halo columns, at padding
    (p, 0): its gradients in x, w, b, γᵀ and β against ``jax.grad`` of the
    JAX package's conv + GDN (``_ref_conv_gdn``, its VJP's target) at the
    same explicit padding."""
    rng = np.random.default_rng(k)
    cin, cout = 8, 32
    x = rng.standard_normal((2, 12, 24 + k - s, cin)).astype(np.float32)
    w = (rng.standard_normal((k, k, cin, cout)) * 0.1).astype(np.float32)
    b = (rng.standard_normal(cout) * 0.1).astype(np.float32)
    beta = rng.uniform(0.5, 1.5, cout).astype(np.float32)
    gamma = (0.1 * np.eye(cout) + 0.02 * rng.uniform(size=(cout, cout))).astype(np.float32)
    probe = rng.standard_normal(tk2.conv_gdn_plain(
        torch.from_numpy(x), torch.from_numpy(w), None, None, None, s, (p, 0)).shape)

    def jloss(x_, w_, b_, beta_, gamma_):
        params = GDNParams(beta=jnp.sqrt(beta_ + PEDESTAL), gamma=jnp.sqrt(gamma_ + PEDESTAL))
        y = _ref_conv_gdn(x_, w_, b_, params, s, (p, 0), inverse)
        return jnp.sum(y * probe.astype(np.float32))

    want = jax.grad(jloss, argnums=(0, 1, 2, 3, 4))(*map(jnp.asarray, (x, w, b, beta, gamma)))
    leaves = [torch.from_numpy(v).requires_grad_() for v in (x, w, b, gamma.T.copy(), beta)]
    y = tk2.conv_gdn(*leaves, s, (p, 0), inverse)
    assert tuple(y.shape) == probe.shape
    torch.sum(y * torch.from_numpy(probe.astype(np.float32))).backward()
    got = [t.grad.numpy() for t in leaves]
    got[3] = got[3].T  # γᵀ's gradient, as γ's
    for name, g, gj in zip(("x", "w", "b", "gamma", "beta"), got,
                           (want[0], want[1], want[2], want[4], want[3])):
        gj = np.asarray(gj)
        np.testing.assert_allclose(g, gj, rtol=0, atol=GRAD_TOL * float(np.abs(gj).max()),
                                   err_msg=f"d{name}")


def test_dryrun_multichip_on_eight_cpu_devices():
    torch.set_num_threads(2)
    res = dryrun_multichip(_cpu(8))
    assert res["mesh"] == {"data": 4, "tile": 2}
    for key in ("balle17_step", "dsc_step"):
        assert all(np.isfinite(v) for v in res[key].values())
    for key in ("balle17_serving", "dsc_serving", "pam_serving"):
        assert res[key]["code_flip_share"] == 0.0 and res[key]["rans_bytes"] > 0


@pytest.fixture(scope="module")
def data_dirs(tmp_path_factory):
    d = tmp_path_factory.mktemp("data")
    rng = np.random.default_rng(0)
    os.makedirs(d / "train")
    for i in range(6):
        yy, xx = np.mgrid[0:80, 0:96] / 20.0
        img = 0.5 + 0.3 * np.sin(xx + rng.uniform(0, 6))[..., None] * rng.uniform(
            0.2, 1, 3) + 0.05 * rng.standard_normal((80, 96, 3))
        write_ppm(str(d / "train" / f"{i}.ppm"), np.clip(img, 0, 1))
    return str(d / "train")


def _cfg(train_dir, root, **kw):
    base = TrainConfig.from_json(os.path.join(ROOT, "examples", "balle17.json"))
    kw = {"out_channel_n": 16, "batch_size": 2, "image_size": 64, "mesh_data": 2,
          "mesh_tile": 2, **kw}
    return dataclasses.replace(base, print_freq=2, cal_step=1, tensorboard=False,
                               train_dir=train_dir, test_dir="", save_root=str(root), **kw)


def test_train_single_image_on_a_mesh_resumes_exactly(data_dirs, tmp_path):
    """``train_single_image`` on ``devices=["cpu"] * 4`` at 2×2: 4 steps,
    and 2 steps then a resume to 4, end bit-equal (parameters and Adam
    moments); the split step equals the one-device loop's first step."""
    torch.set_num_threads(1)
    full = cli.train_single_image(_cfg(data_dirs, tmp_path, tot_step=4, save_model_freq=2),
                                  "full", device="cpu", devices=_cpu(4))
    assert "mesh: data=2 tile=2" in open(tmp_path / "full" / "train.log").read()
    half_cfg = _cfg(data_dirs, tmp_path, tot_step=2, save_model_freq=2)
    cli.train_single_image(half_cfg, "half", device="cpu", devices=_cpu(4))
    resumed = cli.train_single_image(dataclasses.replace(half_cfg, tot_step=4), "half",
                                     resume=str(tmp_path / "half"), device="cpu",
                                     devices=_cpu(4))
    assert full.step == resumed.step == 4
    for (k, a), b in zip(full.model.state_dict().items(), resumed.model.state_dict().values()):
        assert torch.equal(a, b), k
    sa, sb = full.optimizer.state_dict()["state"], resumed.optimizer.state_dict()["state"]
    assert len(sa) == len(list(full.model.parameters()))
    for i in sa:
        for k in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(sa[i][k], sb[i][k])
    # one step on the mesh and on one device from the same seed: the same
    # update up to fp32 sum order (Adam's first update is lr·sign(g))
    one = cli.train_single_image(_cfg(data_dirs, tmp_path, tot_step=1, mesh_data=None,
                                      mesh_tile=1), "one", device="cpu")
    split = cli.train_single_image(_cfg(data_dirs, tmp_path, tot_step=1), "split",
                                   device="cpu", devices=_cpu(4))
    moved = [float((a - b).abs().max()) for a, b in
             zip(one.model.state_dict().values(), split.model.state_dict().values())]
    assert max(moved) <= 2 * 1e-4 + 1e-6 and np.mean([m < 1e-6 for m in moved]) > 0.5


def test_what_the_mesh_refuses(data_dirs, tmp_path):
    # the hyperprior and joint train over the tile axis
    # (test_hyperprior_and_joint_train_single_image_on_tiles) in whole 64-column
    # units: 64-pixel crops on 2 tiles leave one without one (JAX's GSPMD pads it)
    for kw, err, match in (
            ({"model": "hyperprior", "out_channel_m": 24}, ValueError,
             "tile unit of 64 columns"),
            ({"model": "joint", "joint_n": 16}, ValueError, "tile unit of 64 columns"),
            ({"image_size": 32}, ValueError, "mesh_tile=2 gives deepest-latent W shards of 1")):
        with pytest.raises(err, match=match):
            cli.train_single_image(_cfg(data_dirs, tmp_path, tot_step=1, **kw), "x",
                                   device="cpu", devices=_cpu(4))
    with pytest.raises(NotImplementedError, match="Queue 3"):
        cli.check_supported(TrainConfig(model="dsc:fif_0031bpp", mesh_data=2))
    with pytest.raises(ValueError, match="mesh_tile=2 gives deepest-latent W shards of 1"):
        cli.train_dsc(TrainConfig(model="dsc:tiny", image_size=64, batch_size=2, mesh_data=1,
                                  mesh_tile=2, save_root=str(tmp_path)), "x", device="cpu",
                      devices=_cpu(2))
    cli.check_supported(TrainConfig(model="balle17", mesh_data=4, mesh_tile=2))
    cli.check_supported(TrainConfig(model="joint", mesh_data=4, mesh_tile=2))


@pytest.mark.parametrize("model", ["hyperprior", "joint"])
def test_hyperprior_and_joint_train_single_image_on_tiles(tmp_path, model):
    """``train_single_image`` of the hyperprior and the joint codec on a 1×2
    mesh of ``["cpu"] * 2`` (128-pixel crops: one 64-column unit a tile):
    2 steps, and 1 step then a resume to 2, end bit-equal (parameters and
    Adam moments), the mesh in the log, the checkpoints written."""
    torch.set_num_threads(1)
    rng = np.random.default_rng(1)
    os.makedirs(tmp_path / "train")
    for i in range(4):
        write_ppm(str(tmp_path / "train" / f"{i}.ppm"),
                  np.clip(rng.uniform(0.2, 0.8, (1, 1, 3)) + 0.1 * rng.standard_normal(
                      (136, 144, 3)), 0, 1))
    cfg = _cfg(str(tmp_path / "train"), tmp_path, model=model, out_channel_n=16,
               out_channel_m=24, joint_n=16, image_size=128, mesh_data=1, mesh_tile=2,
               save_model_freq=1)
    full = cli.train_single_image(dataclasses.replace(cfg, tot_step=2), "full", device="cpu",
                                  devices=_cpu(2))
    cli.train_single_image(dataclasses.replace(cfg, tot_step=1), "half", device="cpu",
                           devices=_cpu(2))
    resumed = cli.train_single_image(dataclasses.replace(cfg, tot_step=2), "half",
                                     resume=str(tmp_path / "half"), device="cpu",
                                     devices=_cpu(2))
    assert full.step == resumed.step == 2
    for (k, a), b in zip(full.model.state_dict().items(), resumed.model.state_dict().values()):
        assert torch.equal(a, b), k
    sa, sb = full.optimizer.state_dict()["state"], resumed.optimizer.state_dict()["state"]
    assert len(sa) == len(list(full.model.parameters()))
    for i in sa:
        for k in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(sa[i][k], sb[i][k])
    assert "mesh: data=1 tile=2" in open(tmp_path / "full" / "train.log").read()
    assert os.path.exists(tmp_path / "full" / "iter_2.ckpt")
