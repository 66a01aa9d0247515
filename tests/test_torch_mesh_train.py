"""Port parity of the split train steps (``train.mesh_step.shard_train_step``)
against the JAX package's ``shard_train_step`` over the same ('data',
'tile') mesh of ``jax.devices()[:n]``, and against the port's own
one-device step on the whole batch, on the CPU in fp32.

Cases: Ballé-17 (N = 16, batch 8, 64×128, λ 8192) on 4×2, 8×1 and 1×2 with
the MSE and the MS-SSIM distortion; the hyperprior and the joint codec
(N = 16, batch 4) on 4×1 at 64×64, and with both of the hyperprior's
quantizers on 2×2 and 1×2 at 64×128 (64-column W-tiles); the DSC cases
are in ``test_torch_mesh_dsc.py``. The port's
weights are numpy- and torch-seeded and carried to JAX (``*_params_to_jax``);
the noise is JAX's whole-batch draw (from the ``quant`` key the flax module
makes from the step's rng), handed to the port where it draws a whole
batch's noise tensor (``ops.quant.uniform_noise``), as
``test_torch_train.py`` hands it a step's noise. JAX's clamped gradients are
read from its Adam state after the step (μ = 0.1·g at the first update).

Stated tolerances, as in ``test_torch_train.py``: against JAX the losses
and metrics to rtol 1e-4, the clamped gradients to 1e-4 of each tensor's
largest (in the cases witnessed in fp64, against the port's fp32 or fp64
split step: ``_hold_against_jax``), the parameters to 5% of one LR
step where the gradient is
decided (above 1e-3 of the tensor's largest); against the one-device step
(fp32 sums in another order only) the gradients to 1e-5 of each tensor's
largest (1e-4 with an MS-SSIM loss, see ``MSSSIM_ONE_DEVICE_TOL``, whose
witness is ``test_balle17_msssim_split_within_fp32_error``; 1e-4 for the
W-tiled hyperprior and joint, ``TILED_ONE_DEVICE_TOL``, witnessed in fp64
by ``_hold_exact_in_fp64``) and the
metrics to rtol 1e-5, at each of two steps, the second from the split
run's state (so that it sees the replicas take the update).
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iclr_17_compression_tpu.models.balle17 import Balle17Compressor as JBalle17
from iclr_17_compression_tpu.ops import quant as jquant
from iclr_17_compression_tpu.parallel import mesh as jmesh
from iclr_17_compression_tpu.train import state as jstate
from iclr_17_compression_tpu_torch.models.balle17 import Balle17Compressor
from iclr_17_compression_tpu_torch.ops import metrics as tmetrics
from iclr_17_compression_tpu_torch.ops import quant as tquant
from iclr_17_compression_tpu_torch.ops.metrics import ms_ssim
from iclr_17_compression_tpu_torch.parallel import make_mesh
from iclr_17_compression_tpu_torch.parallel.halo import tiled_hyperprior_train, tiled_joint_train
from iclr_17_compression_tpu_torch.train.mesh_step import shard_train_step
from iclr_17_compression_tpu_torch.train.state import (create_train_state, make_balle17_train_step,
                                                       make_hyperprior_train_step)
from iclr_17_compression_tpu_torch.train.weights import (hyperprior_params_to_jax,
                                                         joint_params_to_jax, params_to_jax)
from test_torch_hyper_train import jax_model, port_model
from test_torch_hyperprior import image

N, B, H, W, LAM, LR = 16, 8, 64, 128, 8192.0, 1e-4
LOSS_RTOL = 1e-4
GRAD_TOL = 1e-4  # of the tensor's largest |gradient|
PARAM_ATOL = 0.05 * LR
DECIDED = 1e-3
ONE_DEVICE_TOL = 1e-5
# MS-SSIM's gradient reaches a bias as a sum over every pixel of terms that
# nearly cancel, so fp32 alone moves the one-device step further than 1e-5
# from the exact (fp64) step, and a split sums the same terms in another
# order: held by ``_hold_within_fp32_error``
MSSSIM_ONE_DEVICE_TOL = 1e-4
# a W-tiled hyperprior / joint data row sums its conv weights' gradients
# tile by tile: fp32 alone moves their one-device step 1.8e-5-1.9e-5 of a
# tensor's largest from the fp64 step, which the tiled step equals in fp64
# (FP64_EXACT): held by ``_hold_exact_in_fp64``
TILED_ONE_DEVICE_TOL = 1e-4
FP64_EXACT = 1e-10
# JAX's 2×2 hyperprior / joint step moves its hyper path's gradients by 0.48
# to 3.0 of a tensor's largest from its one-device step (ROADMAP Queue 3)
JAX_2X2_FAULT = 0.1
# the joint codec only: a tensor whose gradients all lie under this share
# of the model's largest is held against that share of it instead (its
# ẑ-rate last bias, largest 1.8e-5, sums 64 nearly cancelling terms, 2e-10
# apart between two sum orders, at fp32's resolution)
TINY_TENSOR = 1e-5
BALLE_KEY = 100  # the Ballé-17 cases' step key


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the test workers do not oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def _inject(monkeypatch, queue):
    """The port's whole-batch noise tensors are popped from ``queue``."""
    def draw(shape, generator, half_width, device, dtype):
        noise = queue.pop(0)
        assert tuple(shape) == noise.shape
        return torch.from_numpy(noise).to(device)

    monkeypatch.setattr(tquant, "uniform_noise", draw)


def _jax_noise(jmodel, params, key, shapes_halves, split: int):
    """JAX's draws in the model's order: the ``quant`` key the module makes
    from ``key``, split in ``split`` (1: used whole)."""
    k = jmodel.apply({"params": params}, method=lambda m: m.make_rng("quant"),
                     rngs={"quant": key})
    keys = [k] if split == 1 else list(jax.random.split(k, split))
    return [np.array(jquant.add_uniform_noise(jnp.zeros(s, jnp.float32), kk, h))
            for (s, h), kk in zip(shapes_halves, keys)]


def _jax_split_step(jmodel, params, step_fn, n_data, n_tile, batches, key):
    """JAX's ``shard_train_step`` on the mesh of ``jax.devices()[:n]``: its
    metrics, its clamped gradients (from Adam's μ) and its parameters."""
    mesh = jmesh.training_mesh(batches[0].shape[0], n_data, n_tile,
                               jax.devices()[: n_data * n_tile])
    assert mesh.devices.shape == (n_data, n_tile)
    state = jstate.TrainState.create(apply_fn=jmodel.apply, params=params,
                                     tx=jstate._make_optimizer(LR))
    step = jmesh.shard_train_step(step_fn, mesh, n_batch_args=len(batches))
    state = jmesh.put_replicated(state, mesh)
    args = jmesh.put_batch(mesh, *[jnp.asarray(b) for b in batches])
    args = args if isinstance(args, tuple) else (args,)
    state, metrics = step(state, *args, key)
    mu = state.opt_state[1][0].mu
    grads = jax.tree_util.tree_map(lambda m: np.asarray(m) / 0.1, mu)
    return ({k: float(v) for k, v in metrics.items()}, _flat(grads),
            _flat(jax.tree_util.tree_map(np.asarray, state.params)))


def _grads(model, to_jax):
    return _flat(to_jax({k: (p.grad if p.grad is not None else torch.zeros_like(p))
                         for k, p in model.named_parameters()}))


def _hold_against_jax(metrics, model, to_jax, jmetrics, jgrads, jparams, exact=None,
                      floor_share=0.0):
    """The split step's metrics, gradients and parameters against JAX's.
    With ``exact`` (the split step's fp64 gradients), each of JAX's
    gradient tensors is held against the port's fp32 or its fp64 one, at
    least ``floor_share`` of the model's largest: PyTorch's CPU convs sum a
    weight's gradient over the batch's positions in fp32 up to 1.2e-4 of
    the tensor's largest from the fp64 sum on the fusion presets' first
    residual blocks (JAX's stand within 2e-6 of it), and fp32 and fp64 put
    a leaky-ReLU input on either side of its kink now and then (one of the
    joint's g_a biases by 1.3e-2 of its value), each moving one of the two
    comparisons only."""
    for k, v in jmetrics.items():
        np.testing.assert_allclose(float(metrics[k]), v, rtol=LOSS_RTOL, err_msg=k)
    params_t, grads_t = _flat(to_jax(model.state_dict())), _grads(model, to_jax)
    grads_x = None if exact is None else _flat(to_jax(
        {k: exact.get(k, torch.zeros_like(p)).float() for k, p in model.named_parameters()}))
    floor = floor_share * max(float(np.abs(g).max()) for g in jgrads.values())
    decided_share = []
    for k, gj in jgrads.items():
        top = max(float(np.abs(gj).max()), 1e-30)
        atol = GRAD_TOL * max(top, floor)
        if grads_x is not None and np.abs(grads_t[k] - gj).max() > atol:
            np.testing.assert_allclose(grads_x[k], gj, rtol=0, atol=atol, err_msg=f"d{k}")
        else:
            np.testing.assert_allclose(grads_t[k], gj, rtol=0, atol=atol, err_msg=f"d{k}")
        decided = np.abs(gj) > DECIDED * top
        np.testing.assert_allclose(params_t[k][decided], jparams[k][decided], rtol=0,
                                   atol=PARAM_ATOL, err_msg=k)
        decided_share.append(decided.mean())
    assert np.mean(decided_share) > 0.5


def _hold_fp64_against_jax(grads, model, to_jax, jgrads, floor_share=0.0):
    """The port's fp64 gradients (``_fp64_grads``) against JAX's fp64 ones,
    each tensor to GRAD_TOL of its largest (at least ``floor_share`` of the
    model's largest): the check of a case whose fp32 gradients neither
    package computes to that tolerance."""
    got = _flat(to_jax({k: grads.get(k, torch.zeros_like(p)) for k, p in model.named_parameters()}))
    assert set(got) == set(jgrads)
    gap = _worst_gap({k: torch.as_tensor(got[k]) for k in jgrads},
                     {k: torch.as_tensor(v) for k, v in jgrads.items()}, floor_share)
    assert gap <= GRAD_TOL, gap
    return gap


def _run(step, state, batches, draws, monkeypatch):
    """One step with ``draws`` as its whole-batch noise: (metrics, the
    model's gradients)."""
    queue = [d.copy() for d in draws]
    _inject(monkeypatch, queue)
    metrics = step(state, *[torch.from_numpy(b) for b in batches], None)
    assert not queue, "the step drew fewer noise tensors than JAX"
    return metrics, {k: None if p.grad is None else p.grad.clone()
                     for k, p in state.model.named_parameters()}


def _one_device(model, state, make_step, batches, draws, monkeypatch):
    """The one-device step from a copy of (``model``, ``state``)."""
    ref = copy.deepcopy(model)
    ref_state = create_train_state(ref, lr=LR)
    ref_state.optimizer.load_state_dict(state.optimizer.state_dict())
    ref_state.step = state.step
    return _run(make_step(), ref_state, batches, draws, monkeypatch)


def _hold_against_one_device(got, want, i, grad_tol, floor_share=0.0):
    (metrics, grads), (want_metrics, want_grads) = got, want
    for k, v in want_metrics.items():
        np.testing.assert_allclose(float(metrics[k]), float(v), rtol=ONE_DEVICE_TOL,
                                   err_msg=f"step {i} {k}")
    floor = floor_share * max(float(g.abs().max()) for g in want_grads.values()
                              if g is not None)
    for k, g in want_grads.items():
        if g is None:
            assert grads[k] is None, k
            continue
        top = max(float(g.abs().max()), floor)
        torch.testing.assert_close(grads[k], g, rtol=0, atol=grad_tol * top,
                                   msg=lambda m: f"step {i} d{k}: {m}")


def _check_split(model, make_step, n_data, n_tile, batches, draws, jax_ref, to_jax,
                 monkeypatch, n_batch_args=1, msssim=False, floor_share=0.0,
                 tiled_sums=False, jax_fp64=None):
    """Two split steps of ``make_step()`` on the mesh: the first against
    JAX's (``jax_ref``) and each against the one-device step from the same
    state; ``tiled_sums``: at ``TILED_ONE_DEVICE_TOL``, step 1 witnessed
    by ``_hold_exact_in_fp64``; ``jax_fp64`` (with ``tiled_sums``; JAX's
    split step's gradients in its x64 mode): the gradients held in fp64
    only, against the one-device step's and JAX's (``_hold_fp64_against_jax``),
    and the metrics in fp32."""
    exact = (_fp64_grads(model, make_step, batches, draws, monkeypatch),
             _fp64_grads(model, make_step, batches, draws, monkeypatch,
                         (n_data, n_tile), n_batch_args)) if tiled_sums else None
    state = create_train_state(model, lr=LR)
    split = shard_train_step(make_step(), _cpu_mesh(n_data, n_tile), n_batch_args)
    tol = (TILED_ONE_DEVICE_TOL if tiled_sums else
           MSSSIM_ONE_DEVICE_TOL if msssim else ONE_DEVICE_TOL)
    if jax_fp64 is not None:
        assert _worst_gap(exact[1], exact[0], floor_share) <= FP64_EXACT
        _hold_fp64_against_jax(exact[1], model, to_jax, jax_fp64, floor_share)
        want = _one_device(model, state, make_step, batches, draws, monkeypatch)
        got = _run(split, state, batches, draws, monkeypatch)
        for k, v in want[0].items():
            np.testing.assert_allclose(float(got[0][k]), float(v), rtol=ONE_DEVICE_TOL,
                                       err_msg=k)
        for k, v in jax_ref[0].items():
            np.testing.assert_allclose(float(got[0][k]), v, rtol=LOSS_RTOL, err_msg=k)
        return
    for i in (1, 2):
        want = _one_device(model, state, make_step, batches, draws, monkeypatch)
        got = _run(split, state, batches, draws, monkeypatch)
        assert state.step == i
        _hold_against_one_device(got, want, i, tol, floor_share)
        if i == 1:
            if exact is None:
                _hold_against_jax(got[0], model, to_jax, *jax_ref)
            else:
                _hold_against_jax(got[0], model, to_jax, *jax_ref, exact[1], floor_share)
                _hold_exact_in_fp64(got[1], want[1], *exact, floor_share)


def _cpu_mesh(n_data, n_tile):
    return make_mesh(n_data, n_tile, ["cpu"] * (n_data * n_tile))


def _fp64_grads(model, make_step, batches, draws, monkeypatch, mesh=None, n_batch_args=1):
    """The gradients of the one-device step (of the split step on a CPU
    ``mesh`` of that (n_data, n_tile)) from ``model`` with the model, the
    batch, the noise and the MS-SSIM in fp64: the exact step, as far as
    fp32's sums are concerned."""
    nchw = tmetrics._nchw32
    monkeypatch.setattr(tmetrics, "_nchw32", lambda img: img.permute(0, 3, 1, 2)
                        if img.dtype == torch.float64 else nchw(img))
    ref = copy.deepcopy(model).double()
    queue = [d.astype(np.float64) for d in draws]
    _inject(monkeypatch, queue)
    step = make_step() if mesh is None else shard_train_step(make_step(), _cpu_mesh(*mesh),
                                                             n_batch_args)
    step(create_train_state(ref, lr=LR), *[torch.from_numpy(b).double() for b in batches], None)
    assert not queue
    return {k: p.grad for k, p in ref.named_parameters() if p.grad is not None}


def _worst_gap(grads, ref, floor_share=0.0):
    """The largest of each tensor's gap, in shares of the tensor's largest
    |gradient| in ``ref`` (at least ``floor_share`` of the model's largest,
    as ``_hold_against_one_device``)."""
    floor = floor_share * max(float(g.abs().max()) for g in ref.values())
    return max(float((grads[k].double() - g.double()).abs().max()
                     / max(float(g.abs().max()), floor)) for k, g in ref.items())


def _hold_exact_in_fp64(split_grads, one_grads, exact_one, exact_split, floor_share=0.0):
    """The witness of ``TILED_ONE_DEVICE_TOL``: in fp64 the split step's
    gradients equal the one-device step's within ``FP64_EXACT`` (the tiles
    compute the whole image's function), and in fp32 the split moves them
    from the one-device step's no more than twice as far as fp32 alone
    moves the one-device step from the exact one (each of the two fp32
    steps within that of the exact step), nor beyond the stated
    tolerance."""
    tiling_gap = _worst_gap(exact_split, exact_one, floor_share)
    fp32_error = _worst_gap(one_grads, exact_one, floor_share)
    split_gap = _worst_gap(split_grads, one_grads, floor_share)
    assert tiling_gap <= FP64_EXACT, tiling_gap
    assert split_gap <= min(max(ONE_DEVICE_TOL, 2 * fp32_error), TILED_ONE_DEVICE_TOL), \
        (split_gap, fp32_error)
    return tiling_gap, fp32_error, split_gap


def _hold_within_fp32_error(split_grads, one_grads, exact):
    """The witness of ``MSSSIM_ONE_DEVICE_TOL``: fp32 alone moves the
    one-device step's gradients more than ONE_DEVICE_TOL from the exact
    (fp64) step's, and the split moves them less than that from the
    one-device step's (and within the stated tolerance)."""
    fp32_error = _worst_gap(one_grads, exact)
    split_gap = _worst_gap(split_grads, one_grads)
    assert fp32_error > ONE_DEVICE_TOL, fp32_error
    assert split_gap <= min(fp32_error, MSSSIM_ONE_DEVICE_TOL), (split_gap, fp32_error)
    return fp32_error, split_gap


def _jtree_of(tree):
    return jax.tree_util.tree_map(lambda v: jnp.array(np.array(v)), tree)


def _balle17_case():
    """The Ballé-17 cases' batch, model and JAX's whole-batch noise."""
    x = np.random.default_rng(7).uniform(0, 1, (B, H, W, 3)).astype(np.float32)
    model = Balle17Compressor(N).init_(torch.Generator().manual_seed(5))
    jparams = _jtree_of(params_to_jax(model.state_dict()))
    draws = _jax_noise(JBalle17(out_channel_n=N), jparams, jax.random.PRNGKey(BALLE_KEY),
                       [((B, H // 16, W // 16, N), 0.5)], split=1)
    return x, model, draws


@pytest.mark.parametrize("distortion", ["mse", "msssim"])
@pytest.mark.parametrize("n_data,n_tile", [(4, 2), (8, 1), (1, 2)])
def test_balle17_split_step_matches_jax(n_data, n_tile, distortion, monkeypatch):
    x, model, draws = _balle17_case()
    initial = copy.deepcopy(model)
    jparams, jmodel = _jtree_of(params_to_jax(model.state_dict())), JBalle17(out_channel_n=N)
    key = jax.random.PRNGKey(BALLE_KEY)
    jax_ref = _jax_split_step(jmodel, jparams, jstate.make_balle17_train_step(LAM, distortion),
                              n_data, n_tile, [x], key)
    _check_split(model, lambda: make_balle17_train_step(LAM, distortion), n_data, n_tile, [x],
                 draws, jax_ref, params_to_jax, monkeypatch, msssim=distortion == "msssim")
    if distortion == "msssim" and n_data > 1:
        # MS-SSIM is a global statistic: the mean of the data parts' losses
        # is not the whole batch's loss
        rows = B // n_data
        losses = []
        for r in range(n_data):
            part = torch.from_numpy(x[r * rows:(r + 1) * rows])
            _inject(monkeypatch, [draws[0][r * rows:(r + 1) * rows].copy()])
            with torch.no_grad():
                out = initial(part, train=True)
            losses.append(float(LAM * (1.0 - ms_ssim(out["recon"], part, win_size=7))
                                + out["bpp"]))
        whole = jax_ref[0]["rd_loss"]
        assert abs(np.mean(losses) - whole) > LOSS_RTOL * abs(whole), (np.mean(losses), whole)


@pytest.mark.parametrize("n_data,n_tile", [(4, 2), (8, 1), (1, 2)])
def test_balle17_msssim_split_within_fp32_error(n_data, n_tile, monkeypatch):
    """The MS-SSIM cases of ``test_balle17_split_step_matches_jax`` (the
    same model, batch and noise) against the exact step: the fp32 one-device
    step and the fp32 split step, step 1."""
    x, model, draws = _balle17_case()
    make_step = lambda: make_balle17_train_step(LAM, "msssim")  # noqa: E731
    exact = _fp64_grads(model, make_step, [x], draws, monkeypatch)
    state = create_train_state(copy.deepcopy(model), lr=LR)
    _, one = _one_device(model, state, make_step, [x], draws, monkeypatch)
    _, split = _run(shard_train_step(make_step(), _cpu_mesh(n_data, n_tile)), state, [x], draws,
                    monkeypatch)
    _hold_within_fp32_error(split, one, exact)


@pytest.mark.parametrize("case", ["round", "joint"])
def test_hyperprior_and_joint_split_steps_match_jax(case, monkeypatch):
    from test_torch_hyper_train import M

    b = 4
    model = port_model(case, seed=2)
    x = np.stack([image(30 + i) for i in range(b)])
    to_jax = ((lambda sd: joint_params_to_jax(sd, N)) if case == "joint"
              else (lambda sd: hyperprior_params_to_jax(sd, N, M)))
    jparams, jmodel = _jtree_of(to_jax(model.state_dict())), jax_model(case)
    key = jax.random.PRNGKey(102)
    y = (b, 64 // 16, 64 // 16, N if case == "joint" else M)
    draws = _jax_noise(jmodel, jparams, key, [((b, 1, 1, N), 0.5), (y, 0.5)], split=2)
    jax_ref = _jax_split_step(jmodel, jparams, jstate.make_hyperprior_train_step(LAM), 4, 1,
                              [x], key)
    assert np.isfinite(jax_ref[0]["rd_loss"])
    _check_split(model, lambda: make_hyperprior_train_step(LAM), 4, 1, [x], draws, jax_ref,
                 to_jax, monkeypatch, floor_share=TINY_TENSOR)
    # the tile axis trains (test_hyperprior_and_joint_tiled_split_steps_match_jax) in
    # whole units of ẑ's downsampling: 64 columns on two tiles leave one without one
    split = shard_train_step(make_hyperprior_train_step(LAM), make_mesh(2, 2, ["cpu"] * 4))
    with pytest.raises(ValueError, match="tile unit of 64 columns"):
        split(create_train_state(model, lr=LR), torch.from_numpy(x), None)


@pytest.mark.parametrize("n_data,n_tile", [(2, 2), (1, 2)])
@pytest.mark.parametrize("case", ["round", "sigma-norm", "joint"])
def test_hyperprior_and_joint_tiled_split_steps_match_jax(case, n_data, n_tile, monkeypatch):
    """The tile axis of the hyperprior (both quantizers) and the joint
    codec: batch 4 of 64×128 images in 64-column W-tiles (ẑ one column a
    tile) through ``parallel.halo.tiled_hyperprior_train`` /
    ``tiled_joint_train``, against JAX's GSPMD split step and the
    one-device step (``TILED_ONE_DEVICE_TOL``, witnessed in fp64)."""
    from test_torch_hyper_train import M

    b, h, w = 4, 64, 128
    model = port_model(case, seed=3)
    x = np.stack([image(40 + i, h, w) for i in range(b)])
    to_jax = ((lambda sd: joint_params_to_jax(sd, N)) if case == "joint"
              else (lambda sd: hyperprior_params_to_jax(sd, N, M)))
    jparams, jmodel = _jtree_of(to_jax(model.state_dict())), jax_model(case)
    key = jax.random.PRNGKey(103)
    y = (b, h // 16, w // 16, N if case == "joint" else M)
    draws = _jax_noise(jmodel, jparams, key, [((b, h // 64, w // 64, N), 0.5), (y, 0.5)],
                       split=2)
    jax_step = jstate.make_hyperprior_train_step(LAM)
    jax_ref = _jax_split_step(jmodel, jparams, jax_step, n_data, n_tile, [x], key)
    assert np.isfinite(jax_ref[0]["rd_loss"])
    if n_data > 1:
        # JAX's GSPMD step on a data × tile mesh computes the hyper path's
        # gradients wrong (ROADMAP Queue 3): its one-device step, which its
        # 1×2 and 4×1 steps match within 1e-5, is the reference there
        one = _jax_split_step(jmodel, jparams, jax_step, 1, 1, [x], key)
        hyper = [k for k in one[1] if k.split("/")[0] in ("h_a", "h_s")]
        assert max(_rel_gap(jax_ref[1][k], one[1][k]) for k in hyper) > JAX_2X2_FAULT
        jax_ref = one
    tiled = tiled_joint_train if case == "joint" else tiled_hyperprior_train
    _check_split(model, lambda: make_hyperprior_train_step(LAM, tiled=tiled), n_data, n_tile,
                 [x], draws, jax_ref, to_jax, monkeypatch, floor_share=TINY_TENSOR,
                 tiled_sums=True)


def _rel_gap(a, b) -> float:
    return float(np.abs(np.asarray(a) - b).max() / max(float(np.abs(b).max()), 1e-30))
