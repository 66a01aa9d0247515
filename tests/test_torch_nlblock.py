"""Port parity: ``NLBlock`` (models/attention.py) against the JAX module, on
the CPU in fp32.

Weights: the JAX module's init with every leaf (``w_z`` too, else the block
is the identity) redrawn from a numpy seed, carried to the port by
``model_params_from_jax``; inputs numpy-seeded. Stated tolerance: outputs
within rtol 1e-5 / atol 1e-5 (fp32 sums in another order; the concatenate
mode's w·[θ_i; φ_j] is split into w_θ·θ_i + w_φ·φ_j in the port).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iclr_17_compression_tpu.models.attention import NLBlock as JaxNLBlock
from iclr_17_compression_tpu_torch.models import NLBlock
from iclr_17_compression_tpu_torch.train.weights import (layout_of, model_params_from_jax,
                                                         model_params_to_jax)

RTOL = ATOL = 1e-5
SHAPES = {1: (2, 12, 8), 2: (2, 4, 5, 8), 3: (1, 3, 4, 4, 8)}
MODES = ("gaussian", "embedded", "dot", "concatenate")


def _jax_block(mode, dims, x, seed):
    """The JAX block and its params, every leaf redrawn from ``seed``."""
    jm = JaxNLBlock(in_channels=8, mode=mode, dims=dims)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_map(
        lambda v: jnp.asarray(rng.standard_normal(v.shape).astype(np.float32) * 0.3), params)
    return jm, params


@pytest.fixture(autouse=True, scope="module")
def _one_thread_fp32():
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("dims", [1, 2, 3])
@pytest.mark.parametrize("mode", MODES)
def test_nlblock_matches_jax(mode, dims):
    x = np.random.default_rng(dims).standard_normal(SHAPES[dims]).astype(np.float32)
    jm, params = _jax_block(mode, dims, x, seed=10 * dims + MODES.index(mode))
    block = NLBlock(8, mode=mode, dims=dims)
    sd = model_params_from_jax(block, params)
    block.load_state_dict(sd, strict=True)
    with torch.no_grad():
        out = block(torch.from_numpy(x)).numpy()
    ref = np.asarray(jm.apply(params, jnp.asarray(x)))
    np.testing.assert_allclose(out, ref, rtol=RTOL, atol=ATOL)
    assert not np.allclose(out, x, atol=1e-3)  # the block did something
    # the port's keys carry back to the JAX tree unchanged
    back = model_params_to_jax(block)
    flat = jax.tree_util.tree_leaves_with_path(params["params"])
    for path, v in flat:
        node = back
        for k in path:
            node = node[k.key]
        np.testing.assert_array_equal(node, np.asarray(v))


@pytest.mark.parametrize("dims", [1, 2, 3])
def test_nlblock_starts_as_identity_and_checks_rank(dims):
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(SHAPES[dims])
                         .astype(np.float32))
    for mode in MODES:
        block = NLBlock(8, mode=mode, dims=dims)
        assert not block.w_z.weight.any() and not block.w_z.bias.any()
        with torch.no_grad():
            assert torch.equal(block(x), x)
    wrong = SHAPES[1 if dims != 1 else 2]
    with pytest.raises(ValueError, match="rank"):
        NLBlock(8, dims=dims)(torch.zeros(wrong))
    with pytest.raises(ValueError):
        NLBlock(8, mode="cosine")
    with pytest.raises(ValueError, match="dims"):
        NLBlock(8, dims=4)
    assert layout_of(NLBlock(8, mode="concatenate")).path_of("concat_project.weight") \
        == "concat_project/weight"
