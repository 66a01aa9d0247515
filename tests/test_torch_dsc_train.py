"""Port parity of DSC training against the JAX package, on the CPU in fp32:
the train forward, ``make_dsc_train_step`` with the plateau's ``set_lr``,
and a step of the residual stage's trainer ``reg_stage``.

Weights: the port's seeded init of the ``tiny`` presets (the
``temp_0031bpp`` topology at n = 16; GDNs moved off the identity, the code
spread over several steps), carried to JAX by ``dsc_params_to_jax``;
numpy-seeded 64×64 pairs, batch 2. Noise: torch and JAX draw different
bits, so the port is handed JAX's: the three draws of
``jax.random.split(key, 3)`` (the code at ± ``coarse_noise``, then the base
branch's z1 and z2 at ± ``fine_noise``), in that order, where ``key`` is the
``quant`` key the flax module makes from the step's rng.

Stated tolerances, fp32 on both sides with sums in another order, as in
``test_torch_train.py``: every forward output to atol 1e-4 + rtol 1e-5 (as
``test_torch_dsc_model.py``), the loss triplet to rtol 1e-4; in the steps
the losses to rtol 1e-4, the clamped gradients to 1e-4 of each tensor's
largest gradient (3e-4 with the MS-SSIM loss, see ``MSSSIM_GRAD_TOL``), the
parameters to 5% of one LR step where the gradient's sign is decided (|g|
above 1e-3 of the tensor's largest at every step: Adam's first updates are
about lr·sign(g), so an element with a gradient near 0 may move by 2·lr
between the frameworks and is held by its gradient only). For the same
reason each step starts from JAX's parameters (the port's Adam moments
carry on): at n = 16 an element moved by 2·lr moves other gradients past
1e-4 by the next step.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iclr_17_compression_tpu.models import DSC_PRESETS as JAX_PRESETS
from iclr_17_compression_tpu.models import DSCStereoModel as JaxModel
from iclr_17_compression_tpu.nn.layers import TorchConv as JaxTorchConv
from iclr_17_compression_tpu.ops import quant as jquant
from iclr_17_compression_tpu.train import trainers as jtrainers
from iclr_17_compression_tpu.train.state import TrainState as JaxTrainState
from iclr_17_compression_tpu.train.state import make_dsc_train_step as jax_dsc_step
from iclr_17_compression_tpu_torch.models.dsc import DSC_PRESETS, DSCStereoModel
from iclr_17_compression_tpu_torch.nn.layers import GDN
from iclr_17_compression_tpu_torch.ops import quant as tquant
from iclr_17_compression_tpu_torch.train import trainers as ttrainers
from iclr_17_compression_tpu_torch.train.state import create_train_state, make_dsc_train_step
from iclr_17_compression_tpu_torch.train.weights import (_dsc_flax_path, dsc_params_from_jax,
                                                         dsc_params_to_jax)

ATOL, RTOL = 1e-4, 1e-5
LOSS_RTOL = 1e-4
GRAD_TOL = 1e-4  # of the tensor's largest |gradient|
# MS-SSIM's ratios carry fp32 error further: on these inputs the port's own
# fp32 gradients stand up to 7e-5 of a tensor's largest from its fp64 ones
# (the first conv's bias, a sum over every pixel), and JAX's about as far
MSSSIM_GRAD_TOL = 3e-4
LR, LR_AFTER = 1e-4, 1e-5  # the LR of steps 1-2, and of step 3 after set_lr
PARAM_ATOL = 0.05 * LR
DECIDED = 1e-3
HW, B = 64, 2


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: at these sizes it is faster than many, and the
    test workers do not oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _images(seed):
    """A batch of smooth stereo-like pairs: (im1, im2), each (B, HW, HW, 3)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:HW, 0:HW].astype(np.float32)
    out = []
    for _ in range(2 * B):
        img = np.full((HW, HW, 3), 0.5, np.float32)
        for _ in range(4):
            f = rng.uniform(-3, 3, 2) / HW
            img += rng.uniform(0.05, 0.15, 3).astype(np.float32) * np.cos(
                2 * np.pi * (f[0] * yy + f[1] * xx) + rng.uniform(0, 6))[..., None]
        out.append(np.clip(img + 0.05 * rng.standard_normal((HW, HW, 3)), 0, 1))
    return np.stack(out[:B]).astype(np.float32), np.stack(out[B:]).astype(np.float32)


def _model(preset, seed=0, loss=None, spread=12.0):
    cfg = DSC_PRESETS[preset]
    if loss:
        cfg = dataclasses.replace(cfg, loss=loss)
    gen = torch.Generator().manual_seed(seed)
    model = DSCStereoModel(cfg).init_(gen)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, GDN):
                c = m.beta.shape[0]
                m.beta.copy_(0.7 + 0.6 * torch.rand(c, generator=gen))
                m.gamma.copy_(0.3 * torch.eye(c) + 0.1 * torch.rand((c, c), generator=gen))
        last = model.g_a22[max(i for i, s in enumerate(cfg.ga22) if s[0] == "conv3")]
        scale = spread / float(model.encode(torch.from_numpy(_images(0)[0])).std())
        last.weight.mul_(scale)
        last.bias.mul_(scale)
    return model


def _jax_cfg(model):
    return dataclasses.replace(JAX_PRESETS[model.config.name], loss=model.config.loss)


def _jtree(model):
    """The model's parameters as a JAX tree, copied (no buffer shared with
    the torch parameters, which the port's optimizer updates in place)."""
    return jax.tree_util.tree_map(lambda v: jnp.array(np.array(v)),
                                  dsc_params_to_jax(model.state_dict(), model.config))


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def _noises(jcfg, params, rng, shapes):
    """JAX's noise draws of a train forward with ``rngs={"quant": rng}``, in
    the model's order (the code, then z1 and z2), for the given shapes."""
    key = JaxModel(jcfg).apply(params, method=lambda m: m.make_rng("quant"),
                               rngs={"quant": rng})
    keys = jax.random.split(key, 3)
    halves = (jcfg.coarse_noise, jcfg.fine_noise, jcfg.fine_noise)
    return [np.array(jquant.add_uniform_noise(jnp.zeros(s, jnp.float32), k, h))
            for s, k, h in zip(shapes, keys, halves)]


def _inject(monkeypatch, queue):
    """The port's noise is popped from ``queue`` (front first)."""
    def draw(x, generator, half_width):
        return x + torch.from_numpy(queue.pop(0))

    monkeypatch.setattr(tquant, "add_uniform_noise", draw)


def _noise_shapes(cfg, hw=HW, b=B):
    code = (b, hw // cfg.code_div, hw // cfg.code_div, cfg.code_channels)
    z = (b, hw // cfg.latent_div, hw // cfg.latent_div, cfg.n)
    return [code, z, z] if cfg.base_branch else [code]


# preset, loss override, channel mask
FORWARD_CASES = {"tiny-mse": ("tiny", None, None), "tiny-l1": ("tiny", "l1", [True, False]),
                 "tiny-msssim": ("tiny", "msssim", None),
                 "tiny_reg": ("tiny_reg", None, [False, True])}


@pytest.mark.parametrize("case", sorted(FORWARD_CASES))
def test_train_forward_matches_jax(case, monkeypatch):
    preset, loss, mask = FORWARD_CASES[case]
    model = _model(preset, loss=loss)
    cfg, jcfg = model.config, _jax_cfg(model)
    params = {"params": _jtree(model)}
    im1, im2 = _images(1)
    rng = jax.random.PRNGKey(11)
    jmask = None if mask is None else jnp.asarray(mask)
    jout = JaxModel(jcfg).apply(params, jnp.asarray(im1), jnp.asarray(im2), train=True,
                                mask_channels=jmask, rngs={"quant": rng})
    queue = _noises(jcfg, params, rng, _noise_shapes(cfg))
    _inject(monkeypatch, queue)
    tmask = None if mask is None else torch.tensor(mask)
    with torch.no_grad():
        out = model(torch.from_numpy(im1), torch.from_numpy(im2), train=True,
                    mask_channels=tmask)
    assert not queue, "the port drew fewer noises than JAX"
    assert set(out) == set(jout)
    for key in out:
        tol = dict(rtol=LOSS_RTOL, atol=0) if key.startswith("loss") else dict(rtol=RTOL,
                                                                              atol=ATOL)
        np.testing.assert_allclose(out[key].numpy(), np.asarray(jout[key]), err_msg=key, **tol)
    if mask is not None:  # the masked channel carries the noise alone
        code_pre = model.encode(torch.from_numpy(im1)).detach()
        masked = int(np.argmax(mask))
        noise = out["code"][..., masked]
        assert float(noise.abs().max()) <= cfg.coarse_noise
        assert not torch.allclose(code_pre[..., masked], torch.zeros(()))
    # the train forward draws noise where the eval forward quantizes
    with torch.no_grad():
        code_eval = model(torch.from_numpy(im1), torch.from_numpy(im2))["code"]
    assert torch.equal(code_eval, torch.round(code_eval / cfg.coarse_step) * cfg.coarse_step)


def _load_jax_params(model, tree):
    """Set the port model's parameters to JAX's (in place: the optimizer's
    moments stay as they are)."""
    sd = dsc_params_from_jax(jax.tree_util.tree_map(np.asarray, tree), model.config)
    with torch.no_grad():
        for k, p in model.state_dict().items():
            p.copy_(sd[k])


def _compare_step(i, metrics, jmetrics, model, grads_j, jparams, undecided, grad_tol):
    """The losses, then the gradients and the decided parameters of step
    ``i`` (``grads_j`` None: the losses only)."""
    for key in ("loss", "loss_full", "loss_base", "loss_z"):
        np.testing.assert_allclose(float(metrics[key]), float(jmetrics[key]), rtol=LOSS_RTOL,
                                   err_msg=f"step {i + 1} {key}")
    if grads_j is None:
        return
    cfg = model.config
    grads_t = _flat(dsc_params_to_jax({k: (p.grad if p.grad is not None else torch.zeros_like(p))
                                       for k, p in model.named_parameters()}, cfg))
    params_t = _flat(dsc_params_to_jax(model.state_dict(), cfg))
    params_j = _flat(jparams)
    for k, gj in _flat(grads_j).items():
        gj = np.clip(gj, -5.0, 5.0)  # the port's gradients are clamped in place
        top = max(float(np.abs(gj).max()), 1e-30)
        np.testing.assert_allclose(grads_t[k], gj, rtol=0, atol=grad_tol * top,
                                   err_msg=f"step {i + 1} d{k}")
        undecided[k] = undecided.get(k, False) | (np.abs(gj) <= DECIDED * top)
        decided = ~undecided[k]
        np.testing.assert_allclose(params_t[k][decided], params_j[k][decided], rtol=0,
                                   atol=PARAM_ATOL, err_msg=f"step {i + 1} {k}")


STEP_CASES = {"tiny-mse": ("tiny", None), "tiny-l1": ("tiny", "l1"),
              "tiny-msssim": ("tiny", "msssim"), "tiny_reg": ("tiny_reg", None)}


class _RecordingState(JaxTrainState):
    """JAX's TrainState, keeping the gradients the JAX step applies."""

    def apply_gradients(self, *, grads, **kw):
        _RECORDED.append(grads)
        return super().apply_gradients(grads=grads, **kw)


_RECORDED = []


def _conv_outputs(model, run):
    """``run()``'s result, and the outputs of each conv module of ``model``
    in call order, by module name."""
    seen = {}
    hooks = [m.register_forward_hook(
        lambda mod, a, out, name=name: seen.setdefault(name, []).append(out.detach().numpy()))
        for name, m in model.named_modules() if isinstance(m, torch.nn.Conv2d)]
    try:
        return run(), seen
    finally:
        for h in hooks:
            h.remove()


def _jax_conv_outputs(jcfg):
    """A jitted ``(params, im1, im2, rng) → intermediates``: the outputs of
    every conv of JAX's train forward."""
    def run(params, im1, im2, rng):
        return JaxModel(jcfg).apply(
            params, im1, im2, train=True, rngs={"quant": rng},
            capture_intermediates=lambda mdl, method: isinstance(mdl, JaxTorchConv),
            mutable=["intermediates"])[1]

    return jax.jit(run)


def _kinks_straddled(model, state, outputs) -> int:
    """Conv outputs whose sign differs between the port's forward
    (``outputs``) and JAX's (``state``, its intermediates): an activation's
    input on the other side of its kink."""
    flips = 0
    for name, outs in outputs.items():
        node = state["intermediates"]
        for part in _dsc_flax_path(name + ".weight", model.config).split("/")[:-1]:
            node = node[part]
        jouts = node["__call__"]
        assert len(jouts) == len(outs), name
        flips += sum(int(np.sum((t >= 0) != (np.asarray(j) >= 0))) for t, j in zip(outs, jouts))
    return flips


@pytest.mark.parametrize("case", sorted(STEP_CASES))
def test_dsc_train_steps_match_jax(case, monkeypatch):
    """Three steps with a ``set_lr`` between steps 2 and 3. In a step in
    which a conv output, an activation's input, lies on the other side of 0
    in the port than in JAX (fp32 rounding of a value within 1e-7 of the
    kink), the two gradients differ by up to 0.99 of the upstream gradient
    there, and everything upstream of it moves: that step is held by its
    losses only (reported), and the next starts from JAX's parameters again.
    At least two of the three steps are held in full."""
    preset, loss = STEP_CASES[case]
    model = _model(preset, seed=3, loss=loss)
    cfg, jcfg = model.config, _jax_cfg(model)
    jstate = _RecordingState.create(apply_fn=JaxModel(jcfg).apply, params=_jtree(model),
                                    tx=jtrainers._injectable_optimizer(LR, 5.0))
    state = create_train_state(model, lr=LR)
    step = make_dsc_train_step()
    jax_forward = _jax_conv_outputs(jcfg)

    @jax.jit
    def jstep(jstate, im1, im2, rng):  # JAX's step, and the gradients it applied
        _RECORDED.clear()
        jstate, jmetrics = jax_dsc_step()(jstate, im1, im2, rng)
        return jstate, jmetrics, _RECORDED[0]

    queue = []
    _inject(monkeypatch, queue)
    undecided, held = {}, 0
    for i in range(3):
        if i == 2:
            jstate = jtrainers.set_lr(jstate, LR_AFTER)
            ttrainers.set_lr(state, LR_AFTER)
        im1, im2 = _images(10 + i)
        rng = jax.random.PRNGKey(100 + i)
        _load_jax_params(model, jstate.params)
        before = {"params": jstate.params}
        jstate, jmetrics, grads_j = jstep(jstate, jnp.asarray(im1), jnp.asarray(im2), rng)
        queue += _noises(jcfg, before, rng, _noise_shapes(cfg))
        metrics, outputs = _conv_outputs(model, lambda: step(state, torch.from_numpy(im1),
                                                             torch.from_numpy(im2), None))
        assert not queue and state.step == i + 1
        flips = _kinks_straddled(model, jax_forward(before, jnp.asarray(im1), jnp.asarray(im2),
                                                    rng), outputs)
        if flips:
            print(f"{case} step {i + 1}: {flips} conv outputs change sign")
        held += not flips
        _compare_step(i, metrics, jmetrics, model, None if flips else grads_j,
                      jstate.params, undecided,
                      MSSSIM_GRAD_TOL if cfg.loss == "msssim" else GRAD_TOL)
    assert held >= 2, f"{case}: gradients held at {held} of 3 steps"
    assert np.mean([np.mean(~u) for u in undecided.values()]) > 0.5
