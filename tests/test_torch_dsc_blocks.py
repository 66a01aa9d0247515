"""Port parity: the DSC building blocks (``nn/blocks.py``) against the JAX
package's, on the CPU in fp32.

Each case is a one-block stack, built by the port's ``build_stack`` and the
JAX ``_Stack`` from the same spec, with the port's seeded init (GDN
parameters moved off the identity) carried to the JAX tree by
``stack_params_to_jax``, on the same numpy-seeded 8×8 input at C = 16.
Stated tolerance: atol 1e-5 (fp32 convolutions summed in another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iclr_17_compression_tpu.models.dsc import _Stack
from iclr_17_compression_tpu.ops.conv import pixel_shuffle as jax_pixel_shuffle
from iclr_17_compression_tpu_torch.models.dsc import build_stack
from iclr_17_compression_tpu_torch.nn.blocks import init_dsc_
from iclr_17_compression_tpu_torch.nn.layers import GDN
from iclr_17_compression_tpu_torch.ops.conv import pixel_shuffle
from iclr_17_compression_tpu_torch.train.weights import _tree_from, stack_flax_path

ATOL = 1e-5

CASES = {
    "ResidualBlock": ((("rb", 16),), 16),
    "ResidualBlock_skip": ((("rb", 16),), 8),
    "ResidualBlockWithStride": ((("rbs", 16, 2),), 16),
    "ResidualBlockUpsample": ((("rbu", 16, 2),), 16),
    "SubpelConv": ((("subpel", 3, 2),), 16),
    "AttentionBlock": ((("att", 16),), 16),
    "att7": ((("att7", 16),), 16),
    "conv3_conv7": ((("conv3", 16, 2), ("conv7", 16, 1)), 16),
}


def stack_params_to_jax(state_dict, specs):
    """The port's state_dict of one stack (``build_stack(specs, …)``) → the
    params of the JAX ``_Stack(specs)``."""
    return _tree_from(state_dict, lambda key: stack_flax_path(specs, key))


def perturb_gdn_(module: torch.nn.Module, generator: torch.Generator) -> None:
    """Move every GDN's stored parameters off the identity init, keeping
    them positive, so that the tests see a real normalization."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, GDN):
                c = m.beta.shape[0]
                m.beta.copy_(0.7 + 0.6 * torch.rand(c, generator=generator))
                m.gamma.copy_(0.3 * torch.eye(c) + 0.1 * torch.rand((c, c), generator=generator))


@pytest.mark.parametrize("case", sorted(CASES))
def test_block_matches_jax(case):
    specs, cin = CASES[case]
    stack, _ = build_stack(specs, cin)
    gen = torch.Generator().manual_seed(7)
    init_dsc_(stack, gen)
    perturb_gdn_(stack, gen)
    x = np.random.default_rng(3).standard_normal((2, 8, 8, cin)).astype(np.float32)
    with torch.no_grad():
        out = stack(torch.from_numpy(x)).numpy()
    ref = np.asarray(_Stack(specs).apply(
        {"params": stack_params_to_jax(stack.state_dict(), specs)}, jnp.asarray(x)))
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=0, atol=ATOL)


@pytest.mark.parametrize("r", [1, 2, 3])
def test_pixel_shuffle_matches_jax(r):
    x = np.random.default_rng(r).standard_normal((2, 3, 5, 4 * r * r)).astype(np.float32)
    out = pixel_shuffle(torch.from_numpy(x), r).numpy()
    np.testing.assert_array_equal(out, np.asarray(jax_pixel_shuffle(jnp.asarray(x), r)))
