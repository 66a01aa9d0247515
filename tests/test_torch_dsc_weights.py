"""Port parity: the DSC weight bridge (``dsc_params_from_jax`` /
``dsc_params_to_jax``) against the JAX package's trees, on the CPU.

Stated tolerance: none, bit-equal both ways, every leaf checked, and the
port's keys are the reference PyTorch keys that ``import_dsc`` reads (it
maps the port's state_dict onto the same tree). The trees are the JAX
package's own ``DSCStereoModel.init`` at 64×64 (about 30 s a preset: eager
flax init compiles a random kernel per parameter shape).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from iclr_17_compression_tpu.models import DSC_PRESETS as JAX_PRESETS
from iclr_17_compression_tpu.models import DSCStereoModel as JaxModel
from iclr_17_compression_tpu.train.torch_import import import_dsc
from iclr_17_compression_tpu_torch.models.dsc import DSC_PRESETS, DSCStereoModel
from iclr_17_compression_tpu_torch.train.weights import (_flatten, dsc_params_from_jax,
                                                         dsc_params_to_jax)


@pytest.mark.parametrize("preset", ["tiny", "temp_0031bpp"])
def test_weights_round_trip_jax_init(preset):
    cfg = JAX_PRESETS[preset]
    x = jnp.zeros((1, 64, 64, 3), jnp.float32)
    key = jax.random.PRNGKey(3)
    tree = jax.tree_util.tree_map(
        np.asarray, JaxModel(cfg).init({"params": key, "quant": key}, x, x)["params"])
    sd = dsc_params_from_jax(tree, DSC_PRESETS[preset])
    back = _flatten(dsc_params_to_jax(sd, DSC_PRESETS[preset]))
    flat = _flatten(tree)
    assert set(back) == set(flat)
    for path, v in flat.items():
        assert back[path].dtype == v.dtype and np.array_equal(back[path], v), path
    model = DSCStereoModel(DSC_PRESETS[preset])
    model.load_state_dict(sd, strict=True)
    # the port's keys are the reference keys: import_dsc maps them onto the
    # same tree
    imported = _flatten(import_dsc({k: v.numpy() for k, v in sd.items()}, cfg))
    assert set(imported) == set(flat)
    assert all(np.array_equal(imported[p], flat[p]) for p in flat)


def test_weights_refuse_a_wrong_tree():
    cfg = DSC_PRESETS["temp_0031bpp"]
    tree = dsc_params_to_jax(DSCStereoModel(cfg).state_dict(), cfg)
    missing = {k: v for k, v in tree.items() if k != "g_s22"}
    with pytest.raises(KeyError, match="missing"):
        dsc_params_from_jax(missing, cfg)
    with pytest.raises(KeyError, match="unexpected"):
        dsc_params_from_jax({**tree, "extra": {"w": np.zeros(3, np.float32)}}, cfg)
    bad = {**tree, "g_s22": {**tree["g_s22"], "l1_conv3": {
        "weight": tree["g_s22"]["l1_conv3"]["weight"][..., :16],
        "bias": tree["g_s22"]["l1_conv3"]["bias"]}}}
    with pytest.raises(ValueError, match="shape"):
        dsc_params_from_jax(bad, cfg)
