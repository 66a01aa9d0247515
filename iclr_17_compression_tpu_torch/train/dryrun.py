"""A dry run of the device mesh: the split train steps and tiled serving on
a list of devices.

Counterpart of ``__graft_entry__.py``'s ``dryrun_multichip``: at its tiny
shapes, on a data × tile mesh (tile 2 where the devices pair up), one
split train step each of Ballé-17 (N = 64, 64×128 a part, λ 2048) and of
a DSC model of the ``tiny`` preset's topology (the flagship's) at the
narrowest widths the card's K2 takes (``DRYRUN_DSC``), then tiled
serving: Ballé-17 in one W-tile a device, that DSC in 2 W-tiles and
``pam_0031bpp`` (128×512) in 2 H-tiles, each through per-tile rANS streams
and against the untiled model. The same code runs on ``["cpu"] * 8`` and on
``["cuda:0"] * 8`` (one card, every slot on it):

  python -c "from iclr_17_compression_tpu_torch.train.dryrun import \\
      dryrun_multichip; dryrun_multichip(['cuda:0'] * 8)"

It raises on the first check that fails and returns what it measured.
"""

import dataclasses
from typing import Dict, Sequence

import numpy as np
import torch

from ..coding import api
from ..models.balle17 import Balle17Compressor
from ..models.dsc import (DSC_PRESETS, DSCDecoder, DSCStereoModel, _ga_specs, _gs_specs,
                          _gz_specs, quantize_code)
from ..parallel.mesh import Device, gather_tiles, make_mesh, training_mesh
from ..parallel.tiled import (decode_streams_to_code, encode_tiles_to_streams,
                              make_tiled_codec, make_tiled_dsc)
from .mesh_step import shard_train_step
from .state import (create_train_state, make_balle17_train_step, make_dsc_train_step,
                    step_generator)

# The DSC model of the dry run: the tiny preset (the flagship's topology at
# n = 16, its code stacks' K2 blocks at 8 and 16 channels) at n = 32 with
# those blocks at 32, the narrowest the card's K2 takes (Cout a multiple of
# 32); the same model on the CPU and on the card.
DRYRUN_DSC = dataclasses.replace(
    DSC_PRESETS["tiny"], name="tiny_n32", n=32, ga=_ga_specs(32), gs=_gs_specs(32),
    gz=_gz_specs(32), ga22=(("conv3", 32, 1), ("rbs", 32, 2), ("conv3", 2, 1)),
    gs22=(("conv3", 32, 1), ("rbu", 32, 2), ("rb", 32)))

# the tiled-serving criteria of a tile's K2 sums in another grouping: code
# flips (by one step) among the elements, and the recon against the untiled
# receiver on the same code
FLIP_SHARE = 1e-3
RECON_TOL = 1e-4


def _check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(f"dryrun_multichip: {what}")


def _finite(metrics: Dict[str, torch.Tensor], what: str) -> Dict[str, float]:
    out = {k: float(v) for k, v in metrics.items()}
    _check(all(np.isfinite(v) for v in out.values()), f"{what}: non-finite metrics {out}")
    return out


def _served(name: str, code, whole, decode, receiver, step: float, axis: int) -> dict:
    """The code tiles' per-tile streams decoding to them, their flips
    against the untiled ``whole``, and ``decode`` (the tiled receiver) of
    the decoded streams against ``receiver`` (the untiled one) on the same
    code."""
    joined = gather_tiles(code, axis).cpu()
    sym = np.round(joined.numpy() / step).astype(np.int64)
    codec = api.build_cdf_tables_from_histogram(sym)
    ts = encode_tiles_to_streams(code, codec, len(code), step=step, axis=axis)
    back = decode_streams_to_code(ts, codec, step=step, axis=axis)
    _check(np.array_equal(back, joined.numpy()), f"{name}: tile streams do not round-trip")
    flips = (joined != whole.cpu()).float().mean().item()
    _check(flips <= FLIP_SHARE, f"{name}: {flips:.2e} of the code differs from untiled")
    back = torch.from_numpy(back)
    with torch.no_grad():
        ref = receiver(back.to(whole.device)).cpu()
    err = float((gather_tiles(decode(back), axis).cpu() - ref).abs().max())
    _check(err <= RECON_TOL * (1.0 + float(ref.abs().max())),
           f"{name}: tiled recon {err:.2e} from untiled")
    return {"tiles": len(code), "rans_bytes": ts.total_bytes, "code_flip_share": flips,
            "recon_max_abs_err": err}


def dryrun_multichip(devices: Sequence[Device]) -> dict:
    """Run the dry run on ``devices`` (see the module docstring); prints a
    line a part and returns their numbers."""
    devices = [torch.device(d) for d in devices]
    n = len(devices)
    n_tile = 2 if n % 2 == 0 else 1
    n_data = n // n_tile
    batch_size = 2 * n_data
    dev = devices[0]
    gen = torch.Generator().manual_seed(0)
    res = {"mesh": {"data": n_data, "tile": n_tile}}

    # the Ballé-17 split train step (train/cli.py train_single_image's path)
    mesh = training_mesh(batch_size, n_data=n_data, n_tile=n_tile, devices=devices)
    batch = torch.rand((batch_size, 64, 64 * n_tile, 3), generator=gen)
    model = Balle17Compressor(64).init_(gen).to(dev)
    state = create_train_state(model, lr=1e-4)
    step = shard_train_step(make_balle17_train_step(train_lambda=2048.0), mesh)
    metrics = _finite(step(state, batch, step_generator(0, 0, dev)), "Ballé step")
    _check(state.step == 1, f"Ballé step: state.step {state.step}")
    res["balle17_step"] = metrics
    print(f"dryrun_multichip OK on mesh data={n_data} x tile={n_tile}: "
          + ", ".join(f"{k}={v:.4f}" for k, v in metrics.items()), flush=True)

    # the DSC flagship's topology (DRYRUN_DSC), train_dsc's path
    hw = 64  # a multiple of the code's ÷32
    im1 = torch.rand((batch_size, hw, hw * n_tile, 3), generator=gen)
    im2 = torch.clamp(torch.roll(im1, 4, dims=2), 0.0, 1.0)
    dsc = DSCStereoModel(DRYRUN_DSC).init_(gen).to(dev)
    dsc_state = create_train_state(dsc, lr=1e-4)
    dsc_step = shard_train_step(make_dsc_train_step(), mesh, n_batch_args=2)
    dsc_metrics = _finite(dsc_step(dsc_state, im1, im2, step_generator(0, 0, dev)),
                          "DSC step")
    _check(dsc_state.step == 1, f"DSC step: state.step {dsc_state.step}")
    res["dsc_step"] = dsc_metrics
    print(f"dryrun_multichip DSC OK on mesh data={n_data} x tile={n_tile}: "
          + ", ".join(f"{k}={v:.4f}" for k, v in dsc_metrics.items()), flush=True)

    # tiled serving of the trained Ballé-17, one W-tile a device
    model.eval()
    bimg = torch.rand((1, 64, 32 * n, 3), generator=gen)
    enc_b, dec_b = make_tiled_codec(model, make_mesh(1, n, devices))
    latent = enc_b(bimg)
    with torch.no_grad():
        whole = torch.round(model.Encoder(bimg.to(dev)))
    res["balle17_serving"] = _served(
        "tiled Ballé", latent, whole, dec_b,
        lambda y: torch.clamp(model.Decoder(y), 0.0, 1.0), 1.0, 2)
    print(f"dryrun_multichip tiled-serving Ballé OK: {res['balle17_serving']}", flush=True)

    # DRYRUN_DSC in 2 W-tiles, pam_0031bpp (128×512) in 2 H-tiles
    pim1 = torch.rand((1, 128, 512, 3), generator=gen)
    pam = DSCStereoModel(DSC_PRESETS["pam_0031bpp"]).init_(gen).to(dev)
    for name, preset, axis, img1, img2 in (
            ("DSC", dsc, "width", im1, im2),
            ("PAM", pam, "height", pim1, torch.clamp(torch.roll(pim1, 6, dims=2), 0.0, 1.0))):
        preset.eval()
        cfg = preset.config
        enc_d, dec_d = make_tiled_dsc(preset, make_mesh(1, 2, devices[:2]), axis=axis)
        code = enc_d(img1)
        with torch.no_grad():
            whole = quantize_code(preset.encode(img1.to(dev)), cfg)[1]
        receiver = DSCDecoder(cfg, model=preset)
        key = f"{name.lower()}_serving"
        res[key] = _served(f"tiled {name}", code, whole, lambda c: dec_d(c, img2),
                           lambda c: receiver(c, img2.to(dev)), float(cfg.coarse_step),
                           2 if axis == "width" else 1)
        print(f"dryrun_multichip tiled-serving {name} ({cfg.name}, {axis}) OK: {res[key]}",
              flush=True)
    return res
