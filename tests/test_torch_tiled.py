"""Port parity: tiled serving (``iclr_17_compression_tpu_torch/parallel``)
against the JAX package's ``parallel`` on the CPU, fp32.

The JAX side runs on the conftest's 8 virtual CPU devices (shard_map /
GSPMD); the port's tiles lie on ``["cpu"] * n``. Stated tolerances, as the
JAX package's own tests (tests/test_halo.py, test_tiled.py) hold its tiled
functions against its full ones:

- tiled conv2d / conv-transpose: rtol 1e-5 / atol 1e-5 of JAX's tiled op
  and of the port's full op;
- the tiled Ballé-17 (N = 16, 64×256, 4 and 8 tiles), the tiny DSC
  codec (2 tiles, W and H with PAM) and the fusion presets FIF,
  bottleneck and patch-match attention at n = 16 (2 W- or H-tiles): the
  latent / code equal to JAX's tiled one and to the port's untiled one; recon rtol 1e-4 / atol 1e-4 of
  the port's untiled one and (Ballé) of JAX's tiled one; the DSC recon
  within 2e-6 of the largest |pre-clip recon| of JAX's tiled one (the
  seeded tiny decoders reach ~1e3 before the clip);
- ring PAM within 1e-5 of JAX's ``pam_eval_ring`` and of the port's
  replicated ``PAM``;
- ``TiledStreams.serialize`` byte-equal to JAX's for the same symbols and
  tables, ragged tiles included; each package decodes the other's bytes.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh
from jax.sharding import NamedSharding, PartitionSpec as P

from iclr_17_compression_tpu import parallel as jpar
from iclr_17_compression_tpu.coding import build_cdf_tables_from_histogram as jtables
from iclr_17_compression_tpu.models import Balle17Compressor as JBalle17
from iclr_17_compression_tpu.models import DSC_PRESETS as JAX_PRESETS
from iclr_17_compression_tpu.models import DSCStereoModel as JaxDSC
from iclr_17_compression_tpu.models.passr import PAM as JPAM
from iclr_17_compression_tpu.ops import conv as jconv
from iclr_17_compression_tpu.parallel import halo as jhalo
from iclr_17_compression_tpu.parallel.ring_pam import pam_eval_ring as jpam_eval_ring
from iclr_17_compression_tpu_torch import parallel as tpar
from iclr_17_compression_tpu_torch.coding.api import build_cdf_tables_from_histogram
from iclr_17_compression_tpu_torch.models.balle17 import Balle17Compressor
from iclr_17_compression_tpu_torch.models.dsc import DSC_PRESETS, DSCStereoModel
from iclr_17_compression_tpu_torch.models.passr import PAM
from iclr_17_compression_tpu_torch.ops import conv as tconv
from iclr_17_compression_tpu_torch.ops.kernels import conv_gdn_kernel as tk2
from iclr_17_compression_tpu_torch.parallel import halo as thalo
from iclr_17_compression_tpu_torch.train.weights import dsc_params_to_jax, params_from_jax
from test_torch_dsc_codec import _model as dsc_model

TOL = 1e-5
RECON_TOL = 1e-4
RING_TOL = 1e-5
DSC_RAW_REL = 2e-6


def _cpu(n):
    return ["cpu"] * n


def _jrun(fn, n, x, *args):
    """``fn`` under JAX's shard_map over ``n`` virtual devices, x W-sharded."""
    mesh = JMesh(np.array(jax.devices()[:n]), ("tile",))
    f = jhalo._shard_map()(fn, mesh=mesh,
                            in_specs=(P(None, None, "tile", None),) + (P(),) * len(args),
                            out_specs=P(None, None, "tile", None))
    return np.asarray(jax.jit(f)(jnp.asarray(x), *args))


def _np(tiles):
    return tpar.gather_tiles(tiles).numpy()


def test_make_mesh_shapes():
    mesh = tpar.make_mesh(n_data=4, n_tile=2, devices=_cpu(8))
    assert mesh.shape == {"data": 4, "tile": 2}
    assert mesh.tile_devices() == [torch.device("cpu")] * 2
    mesh = tpar.make_mesh(n_tile=1, devices=_cpu(8))
    assert mesh.shape == {"data": 8, "tile": 1}
    assert mesh.shape == jpar.make_mesh(n_tile=1).shape
    with pytest.raises(ValueError):
        tpar.make_mesh(n_data=3, n_tile=2, devices=_cpu(8))
    with pytest.raises(ValueError, match="mesh 3x2"):
        jpar.make_mesh(n_data=3, n_tile=2)


def test_split_gather_ragged_and_replicated():
    x = torch.arange(1 * 2 * 10 * 3, dtype=torch.float32).reshape(1, 2, 10, 3)
    tiles = tpar.split_tiles(x, _cpu(4))
    assert [t.shape[2] for t in tiles] == [a.shape[2] for a in np.array_split(x.numpy(), 4, 2)]
    assert torch.equal(tpar.gather_tiles(tiles), x)
    rows = tpar.split_tiles(x, tpar.make_mesh(1, 2, _cpu(2)), axis="height")
    assert [t.shape[1] for t in rows] == [1, 1]
    model = PAM(4)
    assert tpar.replicated(model, _cpu(3)) == [model] * 3
    with pytest.raises(ValueError, match="GSPMD"):
        tpar.validate_tile_extent(64, 4, 32)
    jpar.validate_tile_extent(256, 4, 32)
    tpar.validate_tile_extent(256, 4, 32)


def test_halo_exchange_zero_pads_and_reads_past_narrow_tiles():
    """Each tile's halos are the full image's neighbouring columns, zeros
    beyond its edges, also where a halo is wider than the next tile."""
    x = torch.randn((1, 3, 10, 2), generator=torch.Generator().manual_seed(0))
    tiles = tpar.split_tiles(x, _cpu(4))  # widths 3, 3, 2, 2
    padded = torch.nn.functional.pad(x, (0, 0, 5, 4))
    start = 0
    for t, h in zip(tiles, tpar.halo_exchange_w(tiles, 5, 4)):
        assert torch.equal(h, padded[:, :, start: start + t.shape[2] + 9])
        start += t.shape[2]


@pytest.mark.parametrize("k,s,p", [(9, 4, 4), (5, 2, 2), (3, 1, 1), (1, 2, 0), (5, 1, 2)])
def test_tiled_conv2d_matches_jax(rng, k, s, p):
    x = rng.standard_normal((2, 16, 64, 6)).astype(np.float32)
    w = (rng.standard_normal((k, k, 6, 8)) * 0.1).astype(np.float32)
    b = rng.standard_normal((8,)).astype(np.float32)
    ref = _jrun(lambda xt, wt, bt: jhalo.tiled_conv2d(xt, wt, bt, stride=s, padding=p), 4,
                x, jnp.asarray(w), jnp.asarray(b))
    wt, bt = torch.from_numpy(tconv.hwio_to_oihw(w).copy()), torch.from_numpy(b)
    out = _np(tpar.tiled_conv2d(tpar.split_tiles(torch.from_numpy(x), _cpu(4)), wt, bt,
                                stride=s, padding=p))
    full = tconv.conv2d(torch.from_numpy(x), wt, bt, stride=s, padding=p).numpy()
    np.testing.assert_allclose(out, ref, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(out, full, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("k,s,p,op", [(5, 2, 2, 1), (9, 4, 4, 3), (4, 2, 1, 0)])
def test_tiled_conv_transpose2d_matches_jax(rng, k, s, p, op):
    x = rng.standard_normal((2, 8, 32, 6)).astype(np.float32)
    w = (rng.standard_normal((k, k, 6, 8)) * 0.1).astype(np.float32)
    b = rng.standard_normal((8,)).astype(np.float32)
    ref = _jrun(lambda xt, wt, bt: jhalo.tiled_conv_transpose2d(
        xt, wt, bt, stride=s, padding=p, output_padding=op), 4, x, jnp.asarray(w),
        jnp.asarray(b))
    wt, bt = torch.from_numpy(tconv.deconv_hwio_to_torch(w)), torch.from_numpy(b)
    out = _np(tpar.tiled_conv_transpose2d(tpar.split_tiles(torch.from_numpy(x), _cpu(4)), wt,
                                          bt, stride=s, padding=p, output_padding=op))
    full = tconv.conv_transpose2d(torch.from_numpy(x), wt, bt, stride=s, padding=p,
                                  output_padding=op).numpy()
    np.testing.assert_allclose(out, ref, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(out, full, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("k,s,p,inverse", [(9, 4, 4, False), (5, 2, 2, True), (3, 1, 1, False)])
def test_conv_gdn_padding_pair_matches_jax(rng, k, s, p, inverse):
    """K2's plain version with padding (p, 0), as a tile with halos runs it,
    against JAX's conv with that padding and its GDN."""
    from iclr_17_compression_tpu.ops.gdn import GDNParams, gdn as jgdn

    x = rng.standard_normal((1, 12, 20, 8)).astype(np.float32)
    w = (rng.standard_normal((k, k, 8, 32)) * 0.1).astype(np.float32)
    b = rng.standard_normal((32,)).astype(np.float32) * 0.1
    beta = (rng.uniform(0.5, 1.5, 32)).astype(np.float32)
    gamma = (0.1 * np.eye(32) + 0.02 * rng.uniform(size=(32, 32))).astype(np.float32)
    ref = jconv.conv2d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), stride=s,
                       padding=(p, 0))
    ref = np.asarray(jgdn(ref, GDNParams(beta=jnp.sqrt(jnp.asarray(beta) + 2.0 ** -36),
                                         gamma=jnp.sqrt(jnp.asarray(gamma) + 2.0 ** -36)),
                          inverse=inverse))
    out = tk2.conv_gdn(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b),
                       torch.from_numpy(gamma.T.copy()), torch.from_numpy(beta), s, (p, 0),
                       inverse).numpy()
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-5)


@pytest.fixture(scope="module")
def balle():
    key = jax.random.PRNGKey(1234)
    jmodel = JBalle17(out_channel_n=16)
    x = np.asarray(jax.random.uniform(key, (1, 64, 256, 3), jnp.float32))
    params = jmodel.init({"params": key, "quant": key}, jnp.asarray(x), train=False)
    model = Balle17Compressor(16).eval()
    model.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                                 params["params"])))
    with torch.no_grad():
        ref = model(torch.from_numpy(x))
    return jmodel, params, model, x, ref


@pytest.mark.parametrize("n_tile", [4, 8])
def test_tiled_balle17_matches_jax(balle, n_tile):
    """The per-op halo forward (``make_tiled_balle17``, 4 tiles as JAX's
    test_halo) and the codec pair (``make_tiled_codec``, 8 tiles as JAX's
    test_tiled) against JAX's and against the port's untiled model."""
    jmodel, params, model, x, ref = balle
    mesh = tpar.make_mesh(1, n_tile, _cpu(n_tile))
    jmesh = jpar.make_mesh(n_data=1, n_tile=n_tile, devices=jax.devices()[:n_tile])
    if n_tile == 4:
        x_sh = jax.device_put(jnp.asarray(x), NamedSharding(jmesh, P(None, None, "tile", None)))
        jrecon, jlatent = jpar.make_tiled_balle17(jmesh)(params, x_sh)
        with torch.no_grad():
            recon, latent = tpar.make_tiled_balle17(mesh)(model, torch.from_numpy(x))
    else:
        jenc, jdec = jpar.make_tiled_codec(jmodel, params, jmesh)
        jlatent = jenc(x)
        jrecon = jdec(jlatent)
        enc, dec = tpar.make_tiled_codec(model, mesh)
        latent = enc(x)
        assert len(latent) == n_tile and all(t.shape[2] == 16 // n_tile for t in latent)
        recon = dec(latent)
    latent, recon = _np(latent), _np(recon)
    np.testing.assert_array_equal(latent, np.asarray(jlatent))
    np.testing.assert_array_equal(latent, ref["latent"].numpy())
    np.testing.assert_allclose(recon, np.asarray(jrecon), rtol=RECON_TOL, atol=RECON_TOL)
    np.testing.assert_allclose(recon, ref["recon"].numpy(), rtol=RECON_TOL, atol=RECON_TOL)


def test_tiled_balle17_blocked_io(balle):
    """io_block = 4: the blocked conv1 and deconv3 exchange halos in the
    blocked grid; the same latent as the unblocked codec."""
    _, _, model, x, ref = balle
    blocked = Balle17Compressor(16, io_block=4).eval()
    blocked.load_state_dict(model.state_dict())
    enc, dec = tpar.make_tiled_codec(blocked, tpar.make_mesh(1, 4, _cpu(4)))
    xb = tconv.space_to_depth(torch.from_numpy(x), 4)
    latent = enc(xb)
    np.testing.assert_array_equal(_np(latent), ref["latent"].numpy())
    recon = tconv.depth_to_space(torch.from_numpy(_np(dec(latent))), 4).numpy()
    np.testing.assert_allclose(recon, ref["recon"].numpy(), rtol=RECON_TOL, atol=RECON_TOL)


def _stereo(key, h, w):
    k1, k2 = jax.random.split(key)
    im1 = jax.random.uniform(k1, (1, h, w, 3), jnp.float32)
    im2 = jnp.clip(jnp.roll(im1, 4, axis=2) + 0.05 * jax.random.normal(k2, im1.shape), 0, 1)
    return np.asarray(im1), np.asarray(im2)


def _dsc(preset_name, fusion_post=None):
    model = dsc_model(preset_name, 0, spread=40.0)
    if fusion_post is not None:
        cfg = dataclasses.replace(DSC_PRESETS[preset_name], fusion_post=fusion_post)
        wide = DSCStereoModel(cfg)
        gen = torch.Generator().manual_seed(3)
        wide.init_(gen)
        wide.load_state_dict(model.state_dict(), strict=False)
        model = wide.eval()
    jcfg = dataclasses.replace(JAX_PRESETS[preset_name], fusion_post=model.config.fusion_post)
    jparams = {"params": jax.tree_util.tree_map(
        jnp.asarray, dsc_params_to_jax(model.state_dict(), model.config))}
    return model, JaxDSC(jcfg), jparams


@pytest.mark.parametrize("axis,fusion_post,shape", [("width", None, (64, 256)),
                                                    ("height", "pam", (128, 128))])
def test_tiled_dsc_matches_jax(key, axis, fusion_post, shape):
    """DSC encode → per-tile rANS streams → decode over 2 tiles: W-tiles of
    the tiny preset (the flagship's topology), H-tiles of it with PAM
    fusion (H = 128: 4 latent rows a tile, under the 14-row overlap)."""
    model, jmodel, jparams = _dsc("tiny", fusion_post)
    _hold_tiled_dsc(model, jmodel, jparams, axis, _stereo(key, *shape))


def _hold_tiled_dsc(model, jmodel, jparams, axis, pair):
    """The port's ``make_tiled_dsc`` over 2 tiles along ``axis`` against
    JAX's and the port's untiled model on ``pair``: codes equal, per-tile
    streams byte-equal to JAX's and decoding to the code, the recon within
    ``RECON_TOL`` of the untiled one and within ``DSC_RAW_REL`` of the
    largest pre-clip value of JAX's tiled one."""
    im1, im2 = pair
    with torch.no_grad():
        ref = model(torch.from_numpy(im1), torch.from_numpy(im2))
    jmesh = jpar.make_mesh(n_data=1, n_tile=2, devices=jax.devices()[:2])
    jenc, jdec = jpar.make_tiled_dsc(jmodel, jparams, jmesh, axis=axis)
    enc, dec = tpar.make_tiled_dsc(model, tpar.make_mesh(1, 2, _cpu(2)), axis=axis)
    code_tiles = enc(im1)
    code = tpar.gather_tiles(code_tiles, axis).numpy()
    jcode = np.asarray(jenc(im1))
    np.testing.assert_array_equal(code, jcode)
    np.testing.assert_array_equal(code, ref["code"].numpy())
    assert np.unique(code).size > 3  # the code spreads over several symbols

    step = float(model.config.coarse_step)
    dim = 2 if axis == "width" else 1
    sym = np.round(code / step).astype(np.int64)
    codec = build_cdf_tables_from_histogram(sym)
    ts = tpar.encode_tiles_to_streams(code_tiles, codec, n_tiles=2, step=step, axis=dim)
    jts = jpar.encode_tiles_to_streams(jcode, jtables(sym, channel_axis=-1), n_tiles=2,
                                       step=step, axis=dim)
    assert ts.serialize() == jts.serialize()
    rec_code = tpar.decode_streams_to_code(ts, codec, step=step, axis=dim)
    np.testing.assert_array_equal(rec_code, code)

    recon = tpar.gather_tiles(dec(rec_code, im2), axis).numpy()
    jrecon = np.asarray(jdec(rec_code, im2))
    np.testing.assert_allclose(recon, ref["recon"].numpy(), rtol=RECON_TOL, atol=RECON_TOL)
    # these seeded decoders reach |recon_raw| ~ 1e3 before the clip, where
    # fp32 sums in another order move the clipped recon by ~1e-3 (JAX's own
    # tiled recon stands that far from its untiled one)
    raw_tol = DSC_RAW_REL * float(ref["recon_raw"].abs().max())
    np.testing.assert_allclose(recon, jrecon, rtol=0, atol=raw_tol)


def small_fusion(preset: str, seed: int = 0, spread: float = 40.0, loss=None):
    """``preset`` (a fusion preset) at n = 16: its fusion option, code
    channels, quantizer and loss, with the Cheng stacks at 16 channels and
    the tiny preset's g_a22 / g_s22 to its code width; the port's seeded
    init, GDNs and FIF's adaptive BatchNorms off their init, the
    patch-match ``scale_att`` at 0.5 (as ``test_torch_fusion``'s), the code
    spread over several steps; ``loss`` in place of the preset's. (model,
    JAX model, JAX variables)."""
    from test_torch_fusion import _perturb_abn_, _variables

    from iclr_17_compression_tpu_torch.models.dsc import _ga_specs, _gs_specs, _gz_specs
    from iclr_17_compression_tpu_torch.nn.layers import GDN

    base = DSC_PRESETS[preset]
    widths = dict(loss=loss or base.loss,n=16, ga=_ga_specs(16), gs=_gs_specs(16), gz=_gz_specs(16),
                  ga22=(("conv3", 8, 1), ("rbs", 8, 2), ("conv3", base.code_channels, 1)),
                  gs22=(("conv3", 8, 1), ("rbu", 16, 2), ("rb", 16)))
    gen = torch.Generator().manual_seed(seed)
    model = DSCStereoModel(dataclasses.replace(base, **widths)).init_(gen).eval()
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, GDN):
                c = m.beta.shape[0]
                m.beta.copy_(0.7 + 0.6 * torch.rand(c, generator=gen))
                m.gamma.copy_(0.3 * torch.eye(c) + 0.1 * torch.rand((c, c), generator=gen))
        _perturb_abn_(model, gen)
        if hasattr(model, "bot_mhsa"):  # as test_torch_fusion.port_model
            model.bot_mhsa.scale_att.fill_(0.5)
        last = model.g_a22[-1]
        x = np.random.default_rng(seed).uniform(0, 1, (1, 64, 128, 3)).astype(np.float32)
        scale = spread / float(model.encode(torch.from_numpy(x)).std())
        last.weight.mul_(scale)
        last.bias.mul_(scale)
    return (model, JaxDSC(dataclasses.replace(JAX_PRESETS[preset], **widths)),
            _variables(model))


@pytest.mark.parametrize("axis", ["width", "height"])
@pytest.mark.parametrize("preset", ["fif_0031bpp", "att_0031bpp", "bottleneck_att_1bpp"])
def test_tiled_fusion_presets_match_jax(key, preset, axis):
    """The fusion presets whose modules see the whole latent (FIF's
    circular dilated convs, the bottleneck and patch-match attention), at
    n = 16 over 2 W- or H-tiles: those modules on the gathered tiles
    (``TileRun.whole``), as GSPMD gathers them in JAX's
    ``make_tiled_dsc``. The patch-match preset on a latent of 10×20 (20×10
    along H): two 9×9 query patches, one a tile, attending over the whole
    latent's keys."""
    model, jmodel, jvariables = small_fusion(preset)
    if preset == "bottleneck_att_1bpp":
        shape = (160, 320) if axis == "width" else (320, 160)
    else:
        shape = (64, 256) if axis == "width" else (128, 128)
    _hold_tiled_dsc(model, jmodel, jvariables, axis, _stereo(key, *shape))


def test_tiled_dsc_refuses_what_is_not_local():
    """PAM along W, as JAX refuses it (``ring_pam`` is the W-tiled PAM);
    along H it tiles (``test_tiled_dsc_matches_jax``), and so do the other
    fusion presets on either axis (``test_tiled_fusion_presets_match_jax``)."""
    mesh = tpar.make_mesh(1, 2, _cpu(2))
    with pytest.raises(ValueError, match="pam"):
        tpar.make_tiled_dsc(DSCStereoModel(DSC_PRESETS["pam_0031bpp"]), mesh)
    with pytest.raises(ValueError, match="pam"):
        jpar.make_tiled_dsc(JaxDSC(JAX_PRESETS["pam_0031bpp"]), params=None,
                            mesh=jpar.make_mesh(n_data=1, n_tile=2, devices=jax.devices()[:2]))
    with pytest.raises(ValueError, match="not known to be local"):
        thalo.module_extent(torch.nn.Linear(2, 2))


def test_ring_pam_matches_jax_and_replicated(key):
    """The ring K/V exchange along W over 8 tiles: within 1e-5 of JAX's
    ring and of the port's replicated PAM, on the tiny PAM preset's PAM
    (C = 16) and its weights in both packages."""
    model, _, jparams = _dsc("tiny", "pam")
    pam, c = model.pam, model.config.n
    k1, k2 = jax.random.split(key)
    xl = np.asarray(jax.random.normal(k1, (2, 4, 64, c), jnp.float32))
    xr = np.asarray(jax.random.normal(k2, (2, 4, 64, c), jnp.float32))
    jpam = jparams["params"]["pam"]
    ref = np.asarray(JPAM(c).apply({"params": jpam}, jnp.asarray(xl), jnp.asarray(xr),
                                   train=False))
    jring = np.asarray(jpam_eval_ring(jpam, jnp.asarray(xl), jnp.asarray(xr),
                                      jpar.make_mesh(n_data=1, n_tile=8)))
    with torch.no_grad():
        replicated = pam(torch.from_numpy(xl), torch.from_numpy(xr)).numpy()
        ring = _np(tpar.pam_eval_ring(pam, torch.from_numpy(xl), torch.from_numpy(xr),
                                      tpar.make_mesh(1, 8, _cpu(8))))
    np.testing.assert_allclose(replicated, ref, rtol=RING_TOL, atol=RING_TOL)
    np.testing.assert_allclose(ring, jring, rtol=RING_TOL, atol=RING_TOL)
    np.testing.assert_allclose(ring, replicated, rtol=RING_TOL, atol=RING_TOL)


@pytest.mark.parametrize("shape,n_tiles,ragged", [((1, 8, 64, 8), 8, None),
                                                  ((1, 4, 10, 6), 4, [3, 3, 2, 2])])
def test_tiled_streams_equal_jax_bytes(rng, shape, n_tiles, ragged):
    """Per-tile streams of the same code and tables: the port's serialized
    ``TiledStreams`` equal JAX's bytes (ragged tiles included), and each
    package decodes the other's."""
    from iclr_17_compression_tpu.parallel import TiledStreams as JTiledStreams

    code = (rng.integers(-8, 9, size=shape) * 16).astype(np.float32)
    sym = np.round(code / 16).astype(np.int64)
    codec, jcodec = (build_cdf_tables_from_histogram(sym),
                     jtables(sym, channel_axis=-1))
    ts = tpar.encode_tiles_to_streams(code, codec, n_tiles=n_tiles, step=16.0)
    jts = jpar.encode_tiles_to_streams(code, jcodec, n_tiles=n_tiles, step=16.0)
    assert ts.n_tiles == n_tiles and ts.tile_shapes == jts.tile_shapes
    if ragged is not None:
        assert [s[2] for s in ts.tile_shapes] == ragged
    blob = ts.serialize()
    assert blob == jts.serialize()
    ts2 = tpar.TiledStreams.deserialize(blob)
    assert ts2.tile_shapes == ts.tile_shapes and ts2.total_bytes == ts.total_bytes
    np.testing.assert_array_equal(tpar.decode_streams_to_code(ts2, codec, step=16.0), code)
    np.testing.assert_array_equal(
        jpar.decode_streams_to_code(JTiledStreams.deserialize(blob), jcodec, step=16.0), code)
