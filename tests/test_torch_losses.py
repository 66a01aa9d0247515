"""Port parity: the loss library (``train/losses.py``) against the JAX
package's on the CPU in fp32.

Inputs are numpy draws from a seed: images in [0, 1] (NHWC, 4 channels so
that the depthwise blur of ``edge_loss`` is not the RGB case alone) and
latents of a batch of 3 whose pairwise distances straddle the margin, so
that every hinge has terms on both sides. Stated tolerance: each loss and
its gradient in both inputs to rtol 1e-4 (fp32 sums in another order; the
gradients atol 1e-4 of the largest too).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iclr_17_compression_tpu.train import losses as jl
from iclr_17_compression_tpu_torch.train import losses as tl

RTOL = 1e-4


def _inputs(seed: int = 0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 1, (2, 20, 24, 4)).astype(np.float32)
    y = np.clip(x + 0.1 * rng.standard_normal(x.shape), 0, 1).astype(np.float32)
    e1 = rng.standard_normal((3, 4, 5, 6)).astype(np.float32)
    # pair 0 close (under the margin), pairs 1 and 2 far
    e2 = (e1 + rng.standard_normal(e1.shape) * np.array([0.3, 1.5, 2.0])[:, None, None, None]
          ).astype(np.float32)
    return x, y, e1, e2


CASES = {
    "charbonnier": (jl.charbonnier_loss, tl.charbonnier_loss, "xy"),
    "contrastive_pairs_only": (jl.contrastive_loss_pairs_only, tl.contrastive_loss_pairs_only,
                               "ee"),
    "contrastive": (jl.contrastive_loss, tl.contrastive_loss, "ee"),
    "contrastive_margin_3": (lambda a, b: jl.contrastive_loss(a, b, margin=3.0),
                             lambda a, b: tl.contrastive_loss(a, b, margin=3.0), "ee"),
    "mse_and_pair_hamming": (jl.mse_and_pair_hamming_loss, tl.mse_and_pair_hamming_loss,
                             "xyee"),
    "l1_and_pair_hamming": (jl.l1_and_pair_hamming_loss, tl.l1_and_pair_hamming_loss, "xyee"),
    "mse_and_contrastive": (jl.mse_and_contrastive_loss, tl.mse_and_contrastive_loss, "xyee"),
    "l1_and_contrastive": (jl.l1_and_contrastive_loss, tl.l1_and_contrastive_loss, "xyee"),
    "mse_and_blank_contrastive": (jl.mse_and_blank_contrastive_loss,
                                  tl.mse_and_blank_contrastive_loss, "xyee"),
    "edge": (jl.edge_loss, tl.edge_loss, "xy"),
    "edge_and_charbonnier": (jl.edge_and_charbonnier_loss, tl.edge_and_charbonnier_loss, "xy"),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_loss_and_gradients_match_jax(name):
    jfn, tfn, kinds = CASES[name]
    x, y, e1, e2 = _inputs()
    args = {"xy": (x, y), "ee": (e1, e2), "xyee": (x, y, e1, e2)}[kinds]
    # gradients in the first two arguments (the recon and the target, or
    # the two latents)
    jval, jgrads = jax.value_and_grad(lambda a, b, *rest: jfn(a, b, *rest), argnums=(0, 1))(
        *(jnp.asarray(a) for a in args))
    targs = [torch.from_numpy(a).requires_grad_(i < 2) for i, a in enumerate(args)]
    tval = tfn(*targs)
    tval.backward()
    np.testing.assert_allclose(float(tval.detach()), float(jval), rtol=RTOL)
    for t, g in zip(targs[:2], jgrads):
        g = np.asarray(g)
        np.testing.assert_allclose(t.grad.numpy(), g, rtol=RTOL,
                                   atol=RTOL * float(np.abs(g).max()))


def test_gauss_kernel_and_hinges_cover_both_sides():
    np.testing.assert_array_equal(tl._gauss_kernel(), np.asarray(jl._gauss_kernel()))
    _, _, e1, e2 = _inputs()
    d = tl._pair_latent_mse(torch.from_numpy(e1), torch.from_numpy(e2)).numpy()
    assert d.min() < 1.0 < d.max()  # the margin splits the pairs
