"""Training and eval data: NHWC float32 in [0, 1], numpy only.

Counterpart of the single-image parts of
``iclr_17_compression_tpu/data/datasets.py`` and of its generic stereo
loader: ``ImageFolderDataset`` (random-resized crop + flips, reference
``Datasets``), ``KodakDataset`` (whole images floor-cropped to a multiple),
``StereoPairDataset`` (left/right folders paired in sorted order; the eval
floor-crop to ×32, the training joint crop and vflip), ``batch_iterator``
(shuffle, batch, thread prefetch, ``skip`` for an exact mid-epoch resume)
and their helpers. For the same seed, epoch and index they produce the same crops as
the JAX package: both draw from Python's ``random`` seeded by
(seed, epoch, index), and the bilinear resize here is Pillow's 8-bit
two-pass resampler (``Resample.c``: horizontal then vertical, 22-bit fixed
point coefficients, rounded and clamped to uint8 between the passes),
written in numpy, so it gives Pillow's bytes without Pillow.

``_load`` reads binary PPM (P6, maxval 255) with numpy and any other file
with Pillow, imported only then.
"""

import math
import os
import random
from typing import Iterator, List, Optional, Tuple

import numpy as np

_EXTS = (".png", ".jpg", ".jpeg", ".bmp", ".ppm")
_PRECISION_BITS = 32 - 8 - 2  # Pillow's fixed point for 8-bit resampling


def _list_images(d: str) -> List[str]:
    out = []
    for root, _, files in os.walk(d):
        for f in sorted(files):
            if f.lower().endswith(_EXTS):
                out.append(os.path.join(root, f))
    return sorted(out)


def _read_ppm(data: bytes) -> Optional[np.ndarray]:
    """An HWC uint8 array from binary PPM bytes, or None for another format
    (or maxval other than 255)."""
    if data[:2] != b"P6":
        return None
    fields, pos = [], 2
    while len(fields) < 3:
        while data[pos:pos + 1].isspace():
            pos += 1
        if data[pos:pos + 1] == b"#":
            pos = data.index(b"\n", pos)
            continue
        end = pos
        while not data[end:end + 1].isspace():
            end += 1
        fields.append(int(data[pos:end]))
        pos = end
    w, h, maxval = fields
    if maxval != 255:
        return None
    pos += 1  # the single whitespace byte before the raster
    raster = np.frombuffer(data, np.uint8, count=h * w * 3, offset=pos)
    return raster.reshape(h, w, 3)


def write_ppm(path: str, img: np.ndarray) -> None:
    """Write an HWC image in [0, 1] as binary PPM (rounded to 8 bits)."""
    u8 = np.clip(np.rint(np.asarray(img, np.float64) * 255.0), 0, 255).astype(np.uint8)
    with open(path, "wb") as f:
        f.write(b"P6\n%d %d\n255\n" % (u8.shape[1], u8.shape[0]))
        f.write(np.ascontiguousarray(u8).tobytes())


def _load(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        data = f.read()
    arr = _read_ppm(data)
    if arr is None:
        from PIL import Image

        arr = np.asarray(Image.open(path).convert("RGB"))
    return arr.astype(np.float32) / 255.0


def _bilinear_coeffs(in_size: int, out_size: int):
    """Pillow's ``precompute_coeffs`` + ``normalize_coeffs_8bpc`` for the
    bilinear filter: (source index, integer weight), each (out_size, ksize),
    in the same double arithmetic (the weights summed tap by tap)."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = filterscale  # the bilinear filter's support is 1
    ksize = int(math.ceil(support)) * 2 + 1
    center = (np.arange(out_size) + 0.5) * scale
    xmin = np.maximum(np.trunc(center - support + 0.5), 0).astype(np.int64)
    xmax = np.minimum(np.trunc(center + support + 0.5), in_size).astype(np.int64) - xmin
    taps = np.arange(ksize)
    inside = taps[None, :] < xmax[:, None]
    ss = 1.0 / filterscale
    w = np.maximum(0.0, 1.0 - np.abs((taps[None, :] + xmin[:, None] - center[:, None] + 0.5)
                                     * ss))
    w = np.where(inside, w, 0.0)
    ww = np.zeros(out_size)
    for t in range(ksize):
        ww = ww + w[:, t]
    w = np.where(ww[:, None] != 0.0, w / np.where(ww == 0.0, 1.0, ww)[:, None], w)
    kk = np.trunc(np.where(w < 0, -0.5, 0.5) + w * (1 << _PRECISION_BITS)).astype(np.int32)
    idx = np.where(inside, xmin[:, None] + taps[None, :], 0)
    return idx, kk


def _round_clip8(acc: np.ndarray) -> np.ndarray:
    return np.clip((acc + (1 << (_PRECISION_BITS - 1))) >> _PRECISION_BITS, 0, 255).astype(
        np.uint8)


def resize_uint8(img: np.ndarray, h: int, w: int) -> np.ndarray:
    """Pillow's ``Image.resize((w, h), BILINEAR)`` of an HWC uint8 image:
    the horizontal pass, then the vertical one, each a sum over the filter's
    taps in 32-bit integers, as Pillow's."""
    ih, iw = img.shape[:2]
    if (ih, iw) == (h, w):
        return img.copy()
    out = img
    if w != iw:  # on a transposed copy, so that each tap gathers whole rows
        out = _resample_rows(np.ascontiguousarray(out.transpose(1, 0, 2)), w).transpose(1, 0, 2)
    if h != ih:
        out = _resample_rows(out, h)
    return np.ascontiguousarray(out)


def _resample_rows(img: np.ndarray, n: int) -> np.ndarray:
    """One pass of Pillow's resampler along the first axis, to ``n`` rows."""
    idx, kk = _bilinear_coeffs(img.shape[0], n)
    acc = np.zeros((n,) + img.shape[1:], np.int32)
    for t in range(idx.shape[1]):
        acc += img[idx[:, t]] * kk[:, t, None, None]
    return _round_clip8(acc)


def _resize(img: np.ndarray, h: int, w: int) -> np.ndarray:
    """Bilinear resize, float32 [0,1]."""
    u8 = (np.clip(img, 0, 1) * 255).astype(np.uint8)
    return resize_uint8(u8, h, w).astype(np.float32) / 255.0


def _rand_crop(img: np.ndarray, ch: int, cw: int, rng: random.Random) -> np.ndarray:
    h, w = img.shape[:2]
    if h < ch or w < cw:  # upscale-pad via resize fallback
        img = resize_uint8((img * 255).astype(np.uint8), max(ch, h), max(cw, w)).astype(
            np.float32) / 255.0
        h, w = img.shape[:2]
    top = rng.randint(0, h - ch)
    left = rng.randint(0, w - cw)
    return img[top: top + ch, left: left + cw]


def _random_resized_crop(
    img: np.ndarray, size: int, rng: random.Random,
    scale=(0.08, 1.0), ratio=(3 / 4, 4 / 3),
) -> np.ndarray:
    """torchvision RandomResizedCrop semantics (area-scale + aspect jitter,
    fallback to center crop)."""
    h, w = img.shape[:2]
    area = h * w
    for _ in range(10):
        target = area * rng.uniform(*scale)
        ar = np.exp(rng.uniform(np.log(ratio[0]), np.log(ratio[1])))
        cw = int(round(np.sqrt(target * ar)))
        ch = int(round(np.sqrt(target / ar)))
        if 0 < cw <= w and 0 < ch <= h:
            top = rng.randint(0, h - ch)
            left = rng.randint(0, w - cw)
            return _resize(img[top: top + ch, left: left + cw], size, size)
    s = min(h, w)
    top, left = (h - s) // 2, (w - s) // 2
    return _resize(img[top: top + s, left: left + s], size, size)


def floor_to_multiple(img: np.ndarray, m: int) -> np.ndarray:
    """Center-crop H and W down to multiples of m (reference
    train_2StepsNet.py:160-168, datasets.py:182-184)."""
    h, w = img.shape[:2]
    nh, nw = (h // m) * m, (w // m) * m
    top, left = (h - nh) // 2, (w - nw) // 2
    return img[top: top + nh, left: left + nw]


class _EpochSeeded:
    """Stateless per-item augmentation RNG: a pure function of
    (seed, epoch, index), so augmentations do not depend on call history
    (threaded prefetch) and reproduce after a resume.
    ``batch_iterator(..., epoch=e)`` calls ``set_epoch``."""

    seed: int = 1234
    _epoch: int = 0

    def set_epoch(self, epoch: int):
        self._epoch = int(epoch)

    def _item_rng(self, i: int) -> random.Random:
        # int-tuple hash is deterministic across processes (PYTHONHASHSEED
        # only randomizes str/bytes hashing)
        return random.Random(hash((self.seed, self._epoch, i)))


class ImageFolderDataset(_EpochSeeded):
    """RandomResizedCrop + H/V flips for codec training (reference
    ``Datasets``, datasets.py:21-28)."""

    def __init__(self, root: str, image_size: int = 256, seed: int = 1234,
                 random_resized: bool = True):
        self.paths = _list_images(root)
        if not self.paths:
            raise FileNotFoundError(f"no images under {root}")
        self.image_size = image_size
        self.seed = seed
        self.random_resized = random_resized

    def __len__(self):
        return len(self.paths)

    def __getitem__(self, i: int) -> np.ndarray:
        rng = self._item_rng(i)
        img = _load(self.paths[i % len(self.paths)])
        s = self.image_size
        if self.random_resized:
            img = _random_resized_crop(img, s, rng)
        else:
            img = _rand_crop(img, s, s, rng)
        if rng.random() < 0.5:
            img = img[:, ::-1]
        if rng.random() < 0.5:
            img = img[::-1, :]
        return np.ascontiguousarray(img)


class KodakDataset:
    """Whole images, floor-cropped to a stride multiple."""

    def __init__(self, root: str, multiple: int = 16):
        self.paths = _list_images(root)
        if not self.paths:
            raise FileNotFoundError(f"no images under {root}")
        self.multiple = multiple

    def __len__(self):
        return len(self.paths)

    def __getitem__(self, i: int) -> np.ndarray:
        return np.ascontiguousarray(floor_to_multiple(_load(self.paths[i]), self.multiple))


def _fit_for_crop(ch: int, cw: int, *imgs: np.ndarray):
    """Jointly upscale ``imgs`` so that a (ch, cw) crop fits in all of them,
    every view to one common size: (h, w, *imgs)."""
    h = min(im.shape[0] for im in imgs)
    w = min(im.shape[1] for im in imgs)
    if h >= ch and w >= cw:
        return (h, w) + tuple(imgs)
    s = max(ch / h, cw / w)
    nh = max(ch, int(round(h * s)))
    nw = max(cw, int(round(w * s)))
    return (nh, nw) + tuple(_resize(im, nh, nw) for im in imgs)


class StereoPairDataset(_EpochSeeded):
    """Left/right folders paired by sorted order. ``train``: a joint random
    (ch, cw) crop of both eyes (upscaled first where it does not fit) and a
    joint vertical flip half the time; always floor-cropped to a multiple of
    ``multiple`` (the eval protocol's ×32)."""

    def __init__(
        self,
        left_dir: str,
        right_dir: str,
        crop: Optional[Tuple[int, int]] = (320, 320),
        multiple: int = 32,
        train: bool = True,
        seed: int = 1234,
    ):
        self.left = _list_images(left_dir)
        self.right = _list_images(right_dir)
        if len(self.left) != len(self.right) or not self.left:
            raise ValueError(f"pair mismatch: {len(self.left)} left vs {len(self.right)} right")
        self.crop = crop
        self.multiple = multiple
        self.train = train
        self.seed = seed

    def __len__(self):
        return len(self.left)

    def __getitem__(self, i: int) -> Tuple[np.ndarray, np.ndarray]:
        rng = self._item_rng(i)
        a, b = _load(self.left[i]), _load(self.right[i])
        if self.train and self.crop is not None:
            ch, cw = self.crop
            h, w, a, b = _fit_for_crop(ch, cw, a, b)
            top = rng.randint(0, h - ch)
            left = rng.randint(0, w - cw)
            a = a[top: top + ch, left: left + cw]
            b = b[top: top + ch, left: left + cw]
            if rng.random() < 0.5:
                a, b = a[::-1], b[::-1]
        a = floor_to_multiple(a, self.multiple)
        b = floor_to_multiple(b, self.multiple)
        return np.ascontiguousarray(a), np.ascontiguousarray(b)


def batch_iterator(
    dataset,
    batch_size: int,
    shuffle: bool = True,
    seed: int = 0,
    drop_last: bool = True,
    num_workers: int = 0,
    prefetch: int = 4,
    epoch: Optional[int] = None,
    skip: int = 0,
) -> Iterator[np.ndarray]:
    """DataLoader replacement: yields stacked numpy batches.

    ``num_workers > 0`` loads items on a thread pool and keeps ``prefetch``
    batches in flight; batch order and contents are those of the synchronous
    path. ``epoch`` is folded into the shuffle seed and forwarded to the
    dataset's ``set_epoch``. ``skip`` drops the first N batches without
    loading them (an exact mid-epoch resume).
    """
    if epoch is not None:
        seed = seed + epoch
        if hasattr(dataset, "set_epoch"):
            dataset.set_epoch(epoch)
    idx = list(range(len(dataset)))
    rng = random.Random(seed)
    if shuffle:
        rng.shuffle(idx)
    chunks = []
    for start in range(0, len(idx), batch_size):
        chunk = idx[start: start + batch_size]
        if drop_last and len(chunk) < batch_size:
            break
        chunks.append(chunk)
    chunks = chunks[skip:]

    if num_workers <= 0:
        for chunk in chunks:
            yield np.stack([dataset[i] for i in chunk])
        return

    import collections
    import concurrent.futures as futures

    ex = futures.ThreadPoolExecutor(max_workers=num_workers)
    try:
        pending = collections.deque()
        it = iter(chunks)
        for chunk in chunks[: max(prefetch, 1)]:
            next(it)
            pending.append([ex.submit(dataset.__getitem__, i) for i in chunk])
        while pending:
            futs = pending.popleft()
            nxt = next(it, None)
            if nxt is not None:
                pending.append([ex.submit(dataset.__getitem__, i) for i in nxt])
            yield np.stack([f.result() for f in futs])
    finally:
        ex.shutdown(wait=False, cancel_futures=True)
