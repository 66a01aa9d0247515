"""Metric CLI: PSNR / MS-SSIM between two images or two folders of images.

Counterpart of ``iclr_17_compression_tpu/eval/metric_cli.py`` (the
reference CLI, metric.py:16-22,221-229):

  python -m iclr_17_compression_tpu_torch.eval.metric_cli -m ssim -o ORIG -c CMP
  python -m iclr_17_compression_tpu_torch.eval.metric_cli -m psnr -o ORIG -c CMP

``-m both`` gives both. Folders pair their images in sorted order; each pair
is cropped to the common size. The metrics are the port's ``ops/metrics.py``
on the card (``--device cpu`` for the CPU), one image pair a call. Images
are read as the training loaders read them (PPM and 8-bit PNG without
Pillow, other formats with it). Prints one line an image and the means.
"""

import argparse
import os
from typing import Dict, List

import numpy as np
import torch

from ..data.datasets import _list_images, _load
from ..ops.metrics import ms_ssim, psnr
from ..utils.device import resolve_device


def _load_pairs(orig: str, cmp: str):
    o = _list_images(orig) if os.path.isdir(orig) else [orig]
    c = _list_images(cmp) if os.path.isdir(cmp) else [cmp]
    if len(o) != len(c):
        raise SystemExit(f"count mismatch: {len(o)} vs {len(c)}")
    for po, pc in zip(o, c):
        yield po, _load(po), _load(pc)


def main(argv=None) -> List[Dict[str, float]]:
    ap = argparse.ArgumentParser(prog="metric_cli", description=__doc__.split("\n\n")[0])
    ap.add_argument("-m", "--metric", default="ssim", choices=["ssim", "psnr", "both"])
    ap.add_argument("-o", "--original", required=True)
    ap.add_argument("-c", "--compared", required=True)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    rows = []
    for po, a, b in _load_pairs(args.original, args.compared):
        h, w = min(a.shape[0], b.shape[0]), min(a.shape[1], b.shape[1])
        ta = torch.from_numpy(np.ascontiguousarray(a[:h, :w])[None]).to(dev)
        tb = torch.from_numpy(np.ascontiguousarray(b[:h, :w])[None]).to(dev)
        vals = {}
        with torch.no_grad():
            if args.metric in ("ssim", "both"):
                vals["ms_ssim"] = float(ms_ssim(ta, tb))
            if args.metric in ("psnr", "both"):
                vals["psnr"] = float(psnr(ta, tb))
        rows.append(vals)
        print(os.path.basename(po), " ".join(f"{k}={v:.6f}" for k, v in vals.items()))
    for k in rows[0]:
        print(f"mean_{k}={np.mean([r[k] for r in rows]):.6f}")
    return rows


if __name__ == "__main__":
    main()
