"""R-D curve comparison and the JPEG anchor.

Counterpart of ``iclr_17_compression_tpu/eval/rd_plot.py`` (reference
test/jpeg.sh, test/draw_rd.py:1-43): JPEG at a quality sweep (Pillow,
4:2:0), bpp from the encoded size, PSNR / SSIM / MS-SSIM from the port's
metrics on ``device`` (``cuda`` unless given); the legacy LSTM codec's bpp
law; and plots of any set of (bpp, metric) curves to PNG (matplotlib).
Pillow and matplotlib are imported inside the functions that need them.
"""

import io
import os
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops.metrics import ms_ssim, psnr, ssim
from ..utils.device import resolve_device


def jpeg_anchor_point(img: np.ndarray, quality: int) -> Tuple[float, np.ndarray]:
    """Encode an HWC [0, 1] image as JPEG 4:2:0 at ``quality``; returns
    (bpp, decoded image)."""
    from PIL import Image

    pil = Image.fromarray((np.clip(img, 0, 1) * 255).astype(np.uint8))
    buf = io.BytesIO()
    pil.save(buf, format="JPEG", quality=quality, subsampling=2)  # 4:2:0
    data = buf.getvalue()
    bpp = len(data) * 8.0 / (img.shape[0] * img.shape[1])
    dec = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"), np.float32) / 255.0
    return bpp, dec


def jpeg_anchor_curve(images: Sequence[np.ndarray],
                      qualities: Iterable[int] = tuple(range(5, 101, 5)),
                      device: Optional[str] = None) -> List[Dict[str, float]]:
    """Mean R-D points over a set of images (the reference's 24×20 sweep,
    test/jpeg.sh:1-9)."""
    dev = resolve_device(device)
    curve = []
    for q in qualities:
        rows = []
        for img in images:
            bpp, dec = jpeg_anchor_point(img, q)
            a = torch.from_numpy(np.ascontiguousarray(img, np.float32)[None]).to(dev)
            b = torch.from_numpy(dec[None]).to(dev)
            with torch.no_grad():
                rows.append((bpp, float(psnr(a, b)), float(ssim(a, b)), float(ms_ssim(a, b))))
        mean = np.mean(rows, axis=0)
        curve.append({"quality": q, "bpp": float(mean[0]), "psnr": float(mean[1]),
                      "ssim": float(mean[2]), "ms_ssim": float(mean[3])})
    return curve


def lstm_bpp(iters: int) -> float:
    """The legacy LSTM codec's bpp law (reference test/draw_rd.py:13)."""
    return iters / 192.0 * 24.0


def plot_rd(curves: Dict[str, List[Tuple[float, float]]], out_path: str,
            ylabel: str = "MS-SSIM", title: str = "R-D comparison") -> str:
    """curves: name → [(bpp, metric), ...]; writes a PNG."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(8, 5))
    for name, pts in curves.items():
        pts = sorted(pts)
        ax.plot([p[0] for p in pts], [p[1] for p in pts], marker="o", label=name)
    ax.set_xlabel("bpp")
    ax.set_ylabel(ylabel)
    ax.set_title(title)
    ax.grid(True, alpha=0.3)
    ax.legend()
    fig.tight_layout()
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    fig.savefig(out_path, dpi=150)
    plt.close(fig)
    return out_path
