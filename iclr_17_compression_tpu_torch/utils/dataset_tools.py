"""Offline data-prep and audit tools (host side, the models on their device).

Counterpart of ``iclr_17_compression_tpu/utils/dataset_tools.py``:

- ``check_image_sizes``: a dataset's size audit (reference
  utils/checkImageSizes.py:1-38);
- ``create_diff_folder``: a diff-image dataset from a trained single-image
  codec, diff = clip(127 + (orig − recon)·255) (reference
  utils/create_diff_folder.py:31-44);
- ``save_both_direction_recons``: a DSC model's reconstructions in both
  conditioning directions, X|Y and Y|X (reference
  fast_image_filters/save_zx_zy_down.py);
- ``warp_side_information``: a feature-match homography warp of the SI image
  onto the reconstruction, for the FIF-enhancement triplets (reference
  utils/warp_final_image.py:12-62), with ORB (SURF is patent-encumbered and
  absent from stock OpenCV) and the same Lowe-ratio + RANSAC pipeline.

The images they write are PNGs from ``data.datasets.write_png`` (``zlib``
alone; a diff keeps its source's name with the suffix ``.png``). PNG and PPM
sizes are read from their headers; other formats need Pillow, and
``warp_side_information`` OpenCV, each imported only there.
"""

import os
import struct
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from ..data.datasets import _PNG_SIGNATURE, _list_images, _load, floor_to_multiple, write_png
from .device import image_batch


def _image_size(path: str) -> Optional[Tuple[int, int]]:
    """(h, w) of an image file, or None for a file no reader takes."""
    with open(path, "rb") as f:
        head = f.read(24)
    if head[:8] == _PNG_SIGNATURE and head[12:16] == b"IHDR":
        w, h = struct.unpack(">II", head[16:24])
        return h, w
    if head[:2] == b"P6":
        return _load(path).shape[:2]
    try:
        from PIL import Image

        with Image.open(path) as im:
            w, h = im.size
    except (ImportError, OSError):
        return None
    return h, w


def check_image_sizes(folder: str) -> Dict:
    """The least height and width and the distinct (h, w) sizes of the
    images in ``folder`` (not its subfolders); files no reader takes are
    skipped."""
    sizes: List[Tuple[int, int]] = []
    min_h = min_w = None
    for f in sorted(os.listdir(folder)):
        p = os.path.join(folder, f)
        hw = _image_size(p) if os.path.isfile(p) else None
        if hw is None:
            continue
        h, w = hw
        if (h, w) not in sizes:
            sizes.append((h, w))
        min_h = h if min_h is None else min(min_h, h)
        min_w = w if min_w is None else min(min_w, w)
    return {"min_h": min_h, "min_w": min_w, "sizes": sizes}


def _recon(model, *imgs: np.ndarray) -> np.ndarray:
    with torch.no_grad():
        return model(*(image_batch(model, x) for x in imgs))["recon"][0].cpu().numpy()


def create_diff_folder(model, src_dir: str, out_dir: str, multiple: int = 16) -> List[str]:
    """For each image under ``src_dir``, floored to ``multiple``: run the
    codec and write the centred residual ``clip(127 + (orig − recon)·255)``
    as a uint8 PNG of the source's name."""
    os.makedirs(out_dir, exist_ok=True)
    written = []
    for p in _list_images(src_dir):
        img = floor_to_multiple(_load(p), multiple)
        recon = _recon(model, img)
        diff = np.clip(127.0 + (img - recon) * 255.0, 0, 255).astype(np.uint8)
        out = os.path.join(out_dir, os.path.splitext(os.path.basename(p))[0] + ".png")
        write_png(out, diff)
        written.append(out)
    return written


def save_both_direction_recons(model, pairs: Iterable[Tuple[np.ndarray, np.ndarray]],
                               out_dir: str) -> List[str]:
    """Write recon(X|Y) and recon(Y|X) of each stereo pair as
    ``<i:04d>_x_from_y.png`` / ``<i:04d>_y_from_x.png``."""
    os.makedirs(out_dir, exist_ok=True)
    written = []
    for i, (a, b) in enumerate(pairs):
        for tag, (x, y) in (("x_from_y", (a, b)), ("y_from_x", (b, a))):
            out = os.path.join(out_dir, f"{i:04d}_{tag}.png")
            write_png(out, (np.clip(_recon(model, x, y), 0, 1) * 255).astype(np.uint8))
            written.append(out)
    return written


def warp_side_information(recon_path: str, si_path: str, out_path: Optional[str] = None,
                          min_matches: int = 10, ratio: float = 0.7) -> Optional[str]:
    """Warp the SI image onto the reconstruction's frame by a feature-match
    homography and write it (default: ``si_path`` with ``SI`` → ``SI_warped``);
    returns the output path, or None when too few features match."""
    try:
        import cv2
    except ImportError as e:
        raise RuntimeError("warp_side_information requires OpenCV") from e

    orig = cv2.imread(recon_path, 0)
    skew = cv2.imread(si_path, 0)
    orb = cv2.ORB_create(4000)
    kp1, des1 = orb.detectAndCompute(orig, None)
    kp2, des2 = orb.detectAndCompute(skew, None)
    if des1 is None or des2 is None:
        return None
    matches = cv2.BFMatcher(cv2.NORM_HAMMING).knnMatch(des1, des2, k=2)
    good = [m for m, n in (p for p in matches if len(p) == 2) if m.distance < ratio * n.distance]
    if len(good) < min_matches:
        return None
    src = np.float32([kp1[m.queryIdx].pt for m in good]).reshape(-1, 1, 2)
    dst = np.float32([kp2[m.trainIdx].pt for m in good]).reshape(-1, 1, 2)
    m_h, _ = cv2.findHomography(src, dst, cv2.RANSAC, 5.0)
    if m_h is None:
        return None
    warped = cv2.warpPerspective(cv2.imread(si_path), np.linalg.inv(m_h),
                                 (orig.shape[1], orig.shape[0]))
    out_path = out_path or si_path.replace("SI", "SI_warped")
    write_png(out_path, np.ascontiguousarray(cv2.cvtColor(warped, cv2.COLOR_BGR2RGB)))
    return out_path
