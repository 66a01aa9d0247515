"""Port parity: ``models/extra.py`` (``ImageCompressorFC``,
``LatentCompressor``, ``AnalysisSmall``, ``SynthesisSmall``) against the JAX
package on the CPU in fp32, and their weight bridges.

Weights: the port's seeded ``init_`` carried to JAX twice, through the JAX
package's own importers (``torch_import.import_fc`` /
``import_latent_compressor`` / ``import_analysis_small`` /
``import_synthesis_small``, which take the reference's NCHW flatten order to
the JAX modules' NHWC one) and through the port's ``model_params_to_jax``;
the two trees are equal, and ``model_params_from_jax`` gives the state_dict
back.
Widths: ``ImageCompressorFC`` at n = 16 on 64×64 images (a 4×4 latent),
``LatentCompressor`` at its fixed 128 channels (its recon is 128 channels
and its MSE is taken against z1) on a 4×4 latent, ``AnalysisSmall`` /
``SynthesisSmall`` at n = 32, m = 4 (the 16×16 grid that SynthesisSmall's
4096-wide fc2 fixes), AnalysisSmall over 64 input channels. Each GDN and
IGDN is moved off its identity init. Stated tolerance: every output rtol
1e-5 and atol 1e-4 of its largest |value|; the rounded latent exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iclr_17_compression_tpu.models import extra as jextra
from iclr_17_compression_tpu.train import torch_import as ti
from iclr_17_compression_tpu_torch.models import extra as textra
from iclr_17_compression_tpu_torch.nn.layers import GDN
from iclr_17_compression_tpu_torch.train import weights as tw

RTOL, ATOL = 1e-5, 1e-4


def _close(got, want, what=""):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=RTOL,
                               atol=ATOL * max(1.0, float(np.abs(want).max())), err_msg=what)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def _gdn_off_identity_(model, gen):
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, GDN):
                c = m.beta.shape[0]
                m.beta.copy_(0.7 + 0.6 * torch.rand(c, generator=gen))
                m.gamma.copy_(0.3 * torch.eye(c) + 0.1 * torch.rand((c, c), generator=gen))
    return model


def _sd_np(model):
    return {k: v.detach().numpy() for k, v in model.state_dict().items()}


def _bridge(model, imported):
    """The JAX tree of ``model`` from the JAX importer; the port's bridge
    gives the same tree and reads it back."""
    tree = imported(_sd_np(model))
    mine = tw.model_params_to_jax(model)
    assert _flat(mine).keys() == _flat(tree).keys()
    for k, v in _flat(tree).items():
        np.testing.assert_array_equal(_flat(mine)[k], v, err_msg=k)
    back = tw.model_params_from_jax(model, {"params": mine})
    assert back.keys() == model.state_dict().keys()
    for k, v in model.state_dict().items():
        assert torch.equal(back[k], v), k
    return tree


def _image(seed, shape):
    return np.random.default_rng(seed).uniform(0, 1, shape).astype(np.float32)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_image_compressor_fc_matches_jax(train):
    gen = torch.Generator().manual_seed(0)
    model = _gdn_off_identity_(textra.ImageCompressorFC(16, (4, 4)).init_(gen), gen)
    tree = _bridge(model, lambda sd: ti.import_fc(sd, (4, 4)))
    img = _image(1, (2, 64, 64, 3))
    with torch.no_grad():
        out = model(torch.from_numpy(img), train=train)
    jout = jextra.ImageCompressorFC(16).apply({"params": tree}, jnp.asarray(img), train=train)
    assert out.keys() == jout.keys()
    if not train:
        np.testing.assert_array_equal(out["latent"].numpy(), np.asarray(jout["latent"]))
    for k in out:
        _close(out[k].numpy(), jout[k], k)


def test_latent_compressor_matches_jax():
    gen = torch.Generator().manual_seed(2)
    model = textra.LatentCompressor().init_(gen)
    tree = _bridge(model, ti.import_latent_compressor)
    rng = np.random.default_rng(3)
    z1, z2 = (rng.standard_normal((2, 4, 4, 128)).astype(np.float32) * 3 for _ in range(2))
    with torch.no_grad():
        out = model(torch.from_numpy(z1), torch.from_numpy(z2))
    jout = jextra.LatentCompressor().apply({"params": tree}, jnp.asarray(z1), jnp.asarray(z2))
    assert out.keys() == jout.keys()
    for k in out:
        _close(out[k].numpy(), jout[k], k)


def test_analysis_and_synthesis_small_match_jax():
    gen = torch.Generator().manual_seed(4)
    ana = _gdn_off_identity_(textra.AnalysisSmall(64, 32, 4).init_(gen), gen)
    syn = _gdn_off_identity_(textra.SynthesisSmall(32, 4).init_(gen), gen)
    atree = _bridge(ana, ti.import_analysis_small)
    stree = _bridge(syn, ti.import_synthesis_small)
    x = np.random.default_rng(5).standard_normal((2, 16, 16, 64)).astype(np.float32)
    with torch.no_grad():
        code = ana(torch.from_numpy(x))
        lat = syn(code)
    jcode = jextra.AnalysisSmall(32, 4).apply({"params": atree}, jnp.asarray(x))
    # the synthesis on the port's own code, so that each side is held alone
    jlat = jextra.SynthesisSmall(32, 4).apply({"params": stree}, jnp.asarray(code.numpy()))
    assert code.shape == (2, 1024) and lat.shape == (2, 16, 16, 1024)
    _close(code.numpy(), jcode, "code")
    _close(lat.numpy(), jlat, "latent")


def test_init_draws_the_jax_laws():
    """The port's init has the JAX initializers' laws: the linear layers
    LeCun-normal truncated at ±2σ (std 1/√fan_in) with zero bias, the
    convs xavier-normal with their gain and 0.01 biases."""
    ana = textra.AnalysisSmall(64, 32, 4).init_(torch.Generator().manual_seed(6))
    w = ana.fc1[0].weight.detach()
    assert float(w.std()) == pytest.approx(1 / np.sqrt(w.shape[1]), rel=0.02)
    assert float(w.abs().max()) <= 2 / np.sqrt(w.shape[1]) / textra._TRUNC_STD + 1e-6
    assert float(ana.fc1[0].bias.abs().max()) == 0.0
    c = ana.conv3.weight.detach()
    assert float(c.std()) == pytest.approx(np.sqrt(2) * np.sqrt(2 / (64 * 9)), rel=0.05)
    assert torch.all(ana.conv3.bias == 0.01)


def test_bridges_refuse_other_widths():
    model, wider = textra.SynthesisSmall(32, 4), textra.SynthesisSmall(64, 4)
    with pytest.raises(KeyError):
        tw.model_params_to_jax(wider, model.state_dict())
    tree = tw.model_params_to_jax(model)
    with pytest.raises(ValueError, match="shape"):
        tw.model_params_from_jax(wider, tree)
