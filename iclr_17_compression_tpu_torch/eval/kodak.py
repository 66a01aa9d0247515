"""Kodak-style eval: per-image and mean bpp / PSNR / MS-SSIM(-dB).

Counterpart of ``iclr_17_compression_tpu/eval/kodak.py`` (the reference's
periodic testKodak loop, train.py:157-198). The model's eval forward runs
under ``torch.no_grad()`` on the model's device: on CUDA through K2 and
K1. It takes a Ballé-17, hyperprior or joint-AR model (the metrics need
only ``recon``, ``latent`` and ``bpp``). ``use_rans`` (Ballé-17 only, as in
the JAX package) codes each latent with the port's rANS coder
(``coding/api.py``) and reports the measured stream size instead of the
estimate (the estimate's mean and the symbol bounds beside it).

``python -m iclr_17_compression_tpu_torch.eval.kodak`` is the R-D check of
archived Ballé-17 weights (``tools/rd_experiment.py``'s protocol): for each
checkpoint the estimated and the rANS bpp, PSNR, MS-SSIM and the per-image
rows over a folder of eval images (the 24 that
``tools/make_offline_data.py <root>`` writes to ``<root>/rd_data/eval24``, no
download), the latent range, the gap to the archived point of
``results/rd_points.json``, and the JPEG anchor on the same images
(``rd_plot.jpeg_anchor_curve``; it needs Pillow), as one JSON object:

    python tools/make_offline_data.py <root>
    python -m iclr_17_compression_tpu_torch.eval.kodak --data <root>/rd_data/eval24 \
        --device cpu --out rd_balle_port.json

``--ckpt`` takes one or more files (default: the four archived ones under
``results/ckpts``), flax checkpoints or reference ``.pth`` state_dicts.
"""

import argparse
import glob
import json
import os
import time
from typing import Dict, Iterable, Optional, Tuple

import numpy as np
import torch

from ..coding.api import build_cdf_tables_from_bit_estimator, encode_latent
from ..ops.metrics import ms_ssim, ms_ssim_db


def eval_kodak(
    model,
    images: Iterable[np.ndarray],
    use_rans: bool = False,
    rans_bounds: Optional[Tuple[int, int]] = None,
) -> Dict[str, float]:
    """images: HWC float arrays in [0, 1] (whole frames). Symbol bounds for
    ``use_rans`` default to the latent range over the set (two passes);
    explicit ``rans_bounds`` raise if a latent falls outside them, never
    clip (a clipped symbol would decode to another latent than the one the
    metrics were computed from). With ``use_rans`` the result also holds
    ``bpp_estimated`` (the model's mean estimate) and ``rans_bounds``."""
    if use_rans and not hasattr(model, "bitEstimator"):
        raise ValueError("use_rans codes a Ballé-17 latent against its factorized prior; "
                         f"{type(model).__name__} has none")
    device = next(model.parameters()).device

    def forward(img):
        x = torch.from_numpy(np.ascontiguousarray(img, np.float32)[None]).to(device)
        with torch.no_grad():
            out = model(x)
            mse = torch.mean((out["recon"] - x) ** 2)
        return x, out, mse

    images = list(images)
    if use_rans and rans_bounds is None:
        lo, hi = 0, 0
        for img in images:
            lat = forward(img)[1]["latent"]
            lo = min(lo, int(torch.floor(lat.min())))
            hi = max(hi, int(torch.ceil(lat.max())))
        rans_bounds = (lo, hi)

    codec = None
    per_image = []
    sum_est = 0.0
    for img in images:
        x, out, mse = forward(img)
        p = 10.0 * np.log10(1.0 / max(float(mse), 1e-12))
        with torch.no_grad():
            ms_t = ms_ssim(out["recon"], x)
        ms = float(ms_t)
        msdb = float(ms_ssim_db(ms_t))
        bpp = float(out["bpp"])
        sum_est += bpp
        if use_rans:
            if codec is None:
                codec = build_cdf_tables_from_bit_estimator(
                    model.bitEstimator.params(), rans_bounds[0], rans_bounds[1])
            lat = torch.round(out["latent"][0]).cpu().numpy().astype(np.int64)
            if lat.min() < rans_bounds[0] or lat.max() > rans_bounds[1]:
                raise ValueError(
                    f"latent range [{lat.min()}, {lat.max()}] exceeds rANS bounds "
                    f"{rans_bounds}; widen rans_bounds (clipping would corrupt the "
                    "decoded latent)")
            bpp = len(encode_latent(codec, lat)) * 8.0 / (x.shape[1] * x.shape[2])
        per_image.append({"bpp": bpp, "psnr": p, "ms_ssim": ms, "ms_ssim_db": msdb})

    n = len(per_image)
    mean = {k: sum(r[k] for r in per_image) / n for k in ("bpp", "psnr", "ms_ssim", "ms_ssim_db")}
    if use_rans:
        mean.update(bpp_estimated=sum_est / n, rans_bounds=tuple(rans_bounds))
    return {**mean, "per_image": per_image}


ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _name(ckpt: str) -> str:
    """``lam128_iter_10000.ckpt`` → ``lam128``; another file: its stem."""
    return os.path.splitext(os.path.basename(ckpt))[0].split("_iter_")[0]


def main(argv=None) -> dict:
    from ..data.datasets import KodakDataset
    from ..train.weights import load_balle17
    from .rd_plot import jpeg_anchor_curve

    ap = argparse.ArgumentParser(description="R-D points of Ballé-17 weights")
    ap.add_argument("--data", required=True, help="a folder of eval images (e.g. "
                    "<root>/rd_data/eval24 of tools/make_offline_data.py)")
    ap.add_argument("--ckpt", nargs="+", default=None,
                    help="Ballé-17 checkpoints (default: results/ckpts/*_iter_*.ckpt)")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--out", default="", help="also write the JSON here")
    args = ap.parse_args(argv)

    ds = KodakDataset(args.data, multiple=16)
    images = [ds[i] for i in range(len(ds))]
    files = [os.path.basename(p) for p in ds.paths]
    archive = os.path.join(ROOT, "results", "rd_points.json")
    archived = {}
    if os.path.exists(archive):
        with open(archive) as f:
            archived = {p["name"]: p for p in json.load(f)["trained_points"]}
    t0 = time.perf_counter()
    points = []
    for ckpt in args.ckpt or sorted(glob.glob(os.path.join(ROOT, "results", "ckpts",
                                                         "*_iter_*.ckpt"))):
        model = load_balle17(ckpt, args.device)
        res = eval_kodak(model, images, use_rans=True)
        pt = {"name": _name(ckpt), "ckpt": os.path.relpath(ckpt, ROOT),
              "n": model.Encoder.conv1.out_channels,
              "bpp_estimated": res["bpp_estimated"], "bpp_rans": res["bpp"],
              "psnr": res["psnr"], "ms_ssim": res["ms_ssim"], "ms_ssim_db": res["ms_ssim_db"],
              "latent_range": list(res["rans_bounds"]),
              "per_image": [dict(row, image=f) for f, row in zip(files, res["per_image"])]}
        ref = archived.get(pt["name"])
        if ref is not None:
            pt["archived"] = {k: ref[k] for k in ("bpp_rans", "psnr", "ms_ssim")}
            pt["gap"] = {"bpp_rans_rel": pt["bpp_rans"] / ref["bpp_rans"] - 1.0,
                         "psnr_db": pt["psnr"] - ref["psnr"],
                         "ms_ssim": pt["ms_ssim"] - ref["ms_ssim"]}
        points.append(pt)
    result = {"images": len(images), "files": files, "device": str(next(model.parameters()).device),
              "points": points, "jpeg_anchor": jpeg_anchor_curve(images, device=args.device),
              "seconds": time.perf_counter() - t0}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f)
    print(json.dumps({**result, "points": [{k: v for k, v in p.items() if k != "per_image"}
                                            for p in points]}, indent=1))
    return result


if __name__ == "__main__":
    main()
