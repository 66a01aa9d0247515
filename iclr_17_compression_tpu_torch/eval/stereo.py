"""DSC stereo eval: PSNR / MS-SSIM / measured bpp over a paired test set.

Counterpart of ``iclr_17_compression_tpu/eval/stereo.py`` (reference
NewTests/test_new_model_reconAndSimilarity.py:98-159): the eval forward,
PSNR and MS-SSIM against the target eye, and the rate of the transmitted
code, both as the reference's gzip proxy and as the real container payload
(``serialize_dsc_code``: shape/step header, per-channel tables, rANS).

``python -m iclr_17_compression_tpu_torch.eval.stereo`` is the R-D check of
archived DSC weights: the SI-assisted point, the code-only ablation (the
same code, the SI latent zeroed) and the two-stage 0.0625-bpp point, over
the 24 held-out pairs that ``tools/make_offline_data.py <root>`` writes to
``<root>/stereo_eval`` (no download), printed as one JSON object beside the
archived points of ``results/rd_points_dsc.json``:

    python tools/make_offline_data.py <root>
    python -m iclr_17_compression_tpu_torch.eval.stereo --data <root> \\
        --device cpu --out rd_dsc_port.json
"""

import argparse
import dataclasses
import json
import os
import time
from typing import Dict, Iterable, Tuple

import numpy as np
import torch

from ..coding.api import gzip_bpp
from ..coding.codec_cli import serialize_dsc_code
from ..ops.metrics import ms_ssim, ms_ssim_db

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def eval_stereo_dsc(model, pairs: Iterable[Tuple[np.ndarray, np.ndarray]],
                    msssim_win: int = 7) -> Dict[str, float]:
    """Per-image and mean psnr, ms_ssim, ms_ssim_db, bpp_gzip and bpp_rans
    of ``model`` (a ``DSCStereoModel``, on its device) over (left, right)
    HWC pairs whose sides are multiples of the code's stride."""
    device = next(model.parameters()).device
    cfg = model.config
    keys = ("psnr", "ms_ssim", "ms_ssim_db", "bpp_gzip", "bpp_rans")
    per_image = []
    for a, b in pairs:
        im1 = torch.from_numpy(np.ascontiguousarray(a, np.float32)[None]).to(device)
        im2 = torch.from_numpy(np.ascontiguousarray(b, np.float32)[None]).to(device)
        with torch.no_grad():
            out = model(im1, im2)
            mse = float(torch.mean((out["recon"] - im1) ** 2))
            ms = float(ms_ssim(out["recon"], im1, win_size=msssim_win))
        n_pix = im1.shape[1] * im1.shape[2]
        code = out["code"][0].cpu().numpy()
        sym = np.round(code / cfg.coarse_step).astype(np.int64)
        payload = serialize_dsc_code(sym, float(cfg.coarse_step), cfg.code_clip)
        per_image.append({
            "psnr": 10.0 * np.log10(1.0 / max(mse, 1e-12)),
            "ms_ssim": ms,
            "ms_ssim_db": float(ms_ssim_db(torch.tensor(ms, dtype=torch.float32))),
            "bpp_gzip": gzip_bpp(code, n_pix),
            "bpp_rans": len(payload) * 8.0 / n_pix,
        })
    out = {k: sum(r[k] for r in per_image) / len(per_image) for k in keys}
    out["per_image"] = per_image
    return out


def main(argv=None) -> dict:
    from ..data.datasets import StereoPairDataset
    from ..eval.reg_stage import eval_reg_stage
    from ..models.dsc import DSCStereoModel
    from ..train.weights import load_dsc

    ckpts = os.path.join(ROOT, "results", "ckpts")
    ap = argparse.ArgumentParser(description="R-D points of archived DSC weights")
    ap.add_argument("--data", required=True,
                    help="root written by tools/make_offline_data.py (uses <root>/stereo_eval)")
    ap.add_argument("--ckpt", default=os.path.join(ckpts, "dsc_flagship_params.msgpack"))
    ap.add_argument("--preset", default="temp_0031bpp")
    ap.add_argument("--reg-ckpt", default=os.path.join(ckpts, "dsc_reg0625_params.msgpack"))
    ap.add_argument("--reg-preset", default="reg_0_0625")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--out", default="", help="also write the JSON here")
    args = ap.parse_args(argv)

    ds = StereoPairDataset(os.path.join(args.data, "stereo_eval", "left"),
                           os.path.join(args.data, "stereo_eval", "right"),
                           train=False, multiple=32)
    pairs = [ds[k] for k in range(len(ds))]
    t0 = time.perf_counter()
    model = load_dsc(args.ckpt, args.preset, args.device)
    cfg = model.config
    si = eval_stereo_dsc(model, pairs, msssim_win=cfg.msssim_win)
    dev = next(model.parameters()).device
    code_only = DSCStereoModel(dataclasses.replace(cfg, si_mode="zero_si"))
    code_only.load_state_dict(model.state_dict())
    co = eval_stereo_dsc(code_only.to(dev).eval(), pairs, msssim_win=cfg.msssim_win)
    reg = load_dsc(args.reg_ckpt, args.reg_preset, args.device)
    two = eval_reg_stage(model, reg, pairs, msssim_win=cfg.msssim_win)

    def summary(res, keys):
        return {k: res[k] for k in keys}

    quality = ("psnr", "ms_ssim", "ms_ssim_db")
    result = {
        "pairs": len(pairs), "device": str(dev),
        "seconds": time.perf_counter() - t0,
        "points": [
            {"preset": args.preset, "bpp_rans": si["bpp_rans"], "bpp_gzip": si["bpp_gzip"],
             "si_assisted": summary(si, quality), "code_only": summary(co, quality)},
            {"preset": f"{args.preset}+{args.reg_preset}", "kind": "two_stage",
             **summary(two, ("bpp_rans", "bpp_gzip", "bpp_base", "bpp_reg")),
             "si_assisted": summary(two, quality)},
        ],
        "per_image": {"si_assisted": si["per_image"], "code_only": co["per_image"],
                      "two_stage": two["per_image"]},
    }
    archive = os.path.join(ROOT, "results", "rd_points_dsc.json")
    if os.path.exists(archive):
        with open(archive) as f:
            points = json.load(f)["points"]
        by_name = {p["preset"]: p for p in points}
        result["archived"] = [
            {k: by_name[name][k] for k in ("bpp_rans", "si_assisted", "code_only")
             if k in by_name[name]}
            for name in (args.preset, f"{args.preset}+{args.reg_preset}") if name in by_name]
    text = json.dumps(result)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)
    print(json.dumps({k: v for k, v in result.items() if k != "per_image"}, indent=1))
    return result


if __name__ == "__main__":
    main()
