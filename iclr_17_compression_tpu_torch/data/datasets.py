"""Training and eval data: NHWC float32 in [0, 1], numpy only.

Counterpart of the single-image and stereo loaders of
``iclr_17_compression_tpu/data/datasets.py``: ``ImageFolderDataset``
(random-resized crop + flips, reference ``Datasets``), ``KodakDataset``
(whole images floor-cropped to a multiple), ``StereoPairDataset``
(left/right folders paired in sorted order; the eval floor-crop to ×32, the
training joint crop and vflip), ``StereoKittiDataset`` (KITTI 2012/2015
``image_2``/``image_3`` pairs, test split ``*_10.png``, joint crop, vflip and
one colour jitter for both eyes), ``StereoHoloPixDataset`` (``left`` →
``right`` path pairs, floor to ×32, optional joint crop),
``FIFEnhanceDataset`` (the enhancement nets' (warped SI, reconstruction,
original) triplets), ``StereoPassrDataset`` (stereo SR's (blurred left,
right, left)), ``StereoPlusDataset`` (a stereo pair and a random-resized
crop of a third image, the contrastive negative), ``batch_iterator``
(shuffle, batch, thread prefetch, ``skip`` for an exact mid-epoch resume;
tuple items give a tuple of batches) and their helpers. For the same seed,
epoch and index they produce the same crops as the JAX package: both draw
from Python's ``random`` seeded by (seed, epoch, index), and the bilinear
resize here is Pillow's 8-bit two-pass resampler (``Resample.c``:
horizontal then vertical, 22-bit fixed point coefficients, rounded and
clamped to uint8 between the passes), written in numpy, so it gives
Pillow's bytes without Pillow.

``_load`` reads binary PPM (P6, maxval 255) and 8-bit non-interlaced gray,
gray+alpha, RGB and RGBA PNG (``zlib`` and the five row filters, as
Pillow's ``convert("RGB")`` gives them) with numpy and the standard
library, and any other file with Pillow, imported only then. Decoded files
are kept, up to ``DECODE_CACHE_BYTES``, as the JAX package keeps them.
``write_png`` writes 8-bit gray or RGB PNG with ``zlib`` alone: the eval and
dataset tools write their images with it where the JAX package uses Pillow.
"""

import math
import os
import random
import struct
import threading
import zlib
from collections import OrderedDict
from typing import Iterator, List, Optional, Sequence, Tuple

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


_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_PNG_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}  # colour type → bytes a pixel at depth 8


def _read_png(data: bytes) -> Optional[np.ndarray]:
    """An HWC uint8 RGB array from the bytes of an 8-bit non-interlaced
    gray, gray+alpha, RGB or RGBA PNG (gray replicated, alpha dropped, as
    Pillow's ``convert("RGB")``), or None for any other file."""
    if data[:8] != _PNG_SIGNATURE:
        return None
    pos, header, chunks = 8, None, []
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length  # length, type, body, CRC
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            chunks.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        return None
    w, h, depth, colour, _, _, interlace = header
    if depth != 8 or interlace or colour not in _PNG_CHANNELS:
        return None
    bpp = _PNG_CHANNELS[colour]
    rows = np.frombuffer(zlib.decompress(b"".join(chunks)), np.uint8, count=h * (1 + w * bpp))
    rows = rows.reshape(h, 1 + w * bpp)
    img = _unfilter(rows[:, 0], rows[:, 1:].reshape(h, w, bpp))
    return np.repeat(img[..., :1], 3, axis=2) if bpp <= 2 else img[..., :3].copy()


def _png_chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def write_png(path: str, u8: np.ndarray) -> None:
    """Write an (h, w) gray or (h, w, 3) RGB uint8 image as an 8-bit PNG,
    every row unfiltered, with ``zlib`` alone."""
    u8 = np.asarray(u8)
    if u8.dtype != np.uint8 or not (u8.ndim == 2 or (u8.ndim == 3 and u8.shape[2] == 3)):
        raise ValueError(f"write_png takes (h, w) or (h, w, 3) uint8, got {u8.dtype} "
                         f"{u8.shape}")
    h, w = u8.shape[:2]
    colour = 0 if u8.ndim == 2 else 2
    rows = np.concatenate([np.zeros((h, 1), np.uint8), u8.reshape(h, -1)], axis=1)
    with open(path, "wb") as f:
        f.write(_PNG_SIGNATURE
                + _png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, colour, 0, 0, 0))
                + _png_chunk(b"IDAT", zlib.compress(np.ascontiguousarray(rows).tobytes(), 6))
                + _png_chunk(b"IEND", b""))


def _unfilter(types: np.ndarray, filtered: np.ndarray) -> np.ndarray:
    """Undo PNG's row filters (0 none, 1 sub, 2 up, 3 average, 4 Paeth) of
    an (h, w, bytes a pixel) image. A pixel depends on its left, upper and
    upper-left neighbours only, so each anti-diagonal is undone at once."""
    h, w, bpp = filtered.shape
    if int(types.max(initial=0)) > 4:
        raise ValueError(f"PNG row filter {int(types.max())} is not one of 0-4")
    # r[y + 1, x + 1] is pixel (y, x): row 0 and column 0 are the zeros the
    # filters see beyond the image
    r = np.zeros((h + 1, w + 1, bpp), np.int16)
    f = filtered.astype(np.int16)
    t = types.astype(np.int16)
    for d in range(h + w - 1):
        y = np.arange(max(0, d - w + 1), min(h - 1, d) + 1)
        x = d - y
        a, b, c = r[y + 1, x], r[y, x + 1], r[y, x]
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        kind = t[y][:, None]
        pred = np.select([kind == 1, kind == 2, kind == 3, kind == 4],
                         [a, b, (a + b) >> 1, paeth], 0)
        r[y + 1, x + 1] = (f[y, x] + pred) & 255
    return r[1:, 1:].astype(np.uint8)


DECODE_CACHE_BYTES = 1 << 30
_decoded: "OrderedDict[str, np.ndarray]" = OrderedDict()  # path → HWC uint8 RGB
_decoded_lock = threading.Lock()


def _load(path: str) -> np.ndarray:
    """The image at ``path`` as HWC float32 in [0, 1]. Decoded files are kept
    (uint8, read only) in a least-recently-used cache of
    ``DECODE_CACHE_BYTES``."""
    with _decoded_lock:
        arr = _decoded.get(path)
        if arr is not None:
            _decoded.move_to_end(path)
    if arr is None:
        with open(path, "rb") as f:
            data = f.read()
        arr = _read_ppm(data)
        if arr is None:
            arr = _read_png(data)
        if arr is None:
            from PIL import Image

            arr = np.asarray(Image.open(path).convert("RGB"))
        with _decoded_lock:
            _decoded[path] = arr
            while sum(a.nbytes for a in _decoded.values()) > DECODE_CACHE_BYTES:
                _decoded.popitem(last=False)
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
            a, b = _joint_crop(rng, *self.crop, a, b)
            if rng.random() < 0.5:
                a, b = a[::-1], b[::-1]
        a = floor_to_multiple(a, self.multiple)
        b = floor_to_multiple(b, self.multiple)
        return np.ascontiguousarray(a), np.ascontiguousarray(b)


def _color_jitter(img: np.ndarray, rng: random.Random,
                  brightness=0.1, contrast=0.1, saturation=0.1) -> np.ndarray:
    """Brightness, contrast and saturation factors drawn from ``rng``; call
    it with the same ``rng`` state for both eyes so that they get the same
    transform (reference datasets.py:259-263 stacks the eyes before the
    jitter)."""
    b = 1.0 + rng.uniform(-brightness, brightness)
    c = 1.0 + rng.uniform(-contrast, contrast)
    s = 1.0 + rng.uniform(-saturation, saturation)
    img = img * b
    mean = img.mean(axis=(0, 1), keepdims=True)
    img = (img - mean) * c + mean
    gray = img.mean(axis=2, keepdims=True)
    img = (img - gray) * s + gray
    return np.clip(img, 0.0, 1.0)


def _joint_crop(rng: random.Random, ch: int, cw: int, a: np.ndarray, b: np.ndarray):
    """The same random (ch, cw) window of both eyes, upscaled first where it
    does not fit."""
    h, w, a, b = _fit_for_crop(ch, cw, a, b)
    top = rng.randint(0, h - ch)
    left = rng.randint(0, w - cw)
    return a[top: top + ch, left: left + cw], b[top: top + ch, left: left + cw]


class StereoKittiDataset(_EpochSeeded):
    """KITTI-style pairs ``<root>/image_2/<f>`` and ``<root>/image_3/<f>``
    over several roots, with the reference's split: train = every frame,
    test = ``*_10.png`` only (reference datasets.py:221-225). Training: a
    joint 315×1215 crop, a joint vertical flip half the time and one colour
    jitter for both eyes; always floor-cropped to ×``multiple``."""

    def __init__(
        self,
        roots: Sequence[str],
        train: bool = True,
        crop: Optional[Tuple[int, int]] = (315, 1215),
        multiple: int = 32,
        jitter: bool = True,
        seed: int = 1234,
    ):
        self.pairs: List[Tuple[str, str]] = []
        for root in roots:
            l_dir, r_dir = os.path.join(root, "image_2"), os.path.join(root, "image_3")
            if not (os.path.isdir(l_dir) and os.path.isdir(r_dir)):
                continue
            rights = {os.path.basename(p): p for p in _list_images(r_dir)}
            for lp in _list_images(l_dir):
                base = os.path.basename(lp)
                if (train or base.endswith("_10.png")) and base in rights:
                    self.pairs.append((lp, rights[base]))
        if not self.pairs:
            raise FileNotFoundError(f"no KITTI pairs under {roots}")
        self.crop = crop
        self.multiple = multiple
        self.train = train
        self.jitter = jitter and train
        self.seed = seed

    def __len__(self):
        return len(self.pairs)

    def __getitem__(self, i: int) -> Tuple[np.ndarray, np.ndarray]:
        rng = self._item_rng(i)
        lp, rp = self.pairs[i]
        a, b = _load(lp), _load(rp)
        if self.train and self.crop is not None:
            a, b = _joint_crop(rng, *self.crop, a, b)
            if rng.random() < 0.5:
                a, b = a[::-1], b[::-1]
            if self.jitter:
                # the same factors for both eyes: a copy of the item's rng state
                st = rng.getstate()
                jr = random.Random()
                jr.setstate(st)
                a = _color_jitter(a, jr)
                jr.setstate(st)
                b = _color_jitter(b, jr)
        a = floor_to_multiple(a, self.multiple)
        b = floor_to_multiple(b, self.multiple)
        return np.ascontiguousarray(a), np.ascontiguousarray(b)


class StereoHoloPixDataset(_EpochSeeded):
    """HoloPix50k pairs: each jpg under ``left_dir`` and the file at its path
    with ``left`` replaced by ``right``, floor-cropped to ×``multiple``, then
    with ``random_crop`` a joint random crop (reference
    StereoDataset_HoloPix50k, datasets.py:147-196)."""

    def __init__(
        self,
        left_dir: str,
        random_crop: bool = False,
        crop: Tuple[int, int] = (320, 320),
        multiple: int = 32,
        seed: int = 1234,
    ):
        self.left = [p for p in _list_images(left_dir) if p.lower().endswith((".jpg", ".jpeg"))]
        if not self.left:
            raise FileNotFoundError(f"no jpg images under {left_dir}")
        self.random_crop = random_crop
        self.crop = crop
        self.multiple = multiple
        self.seed = seed

    def __len__(self):
        return len(self.left)

    def __getitem__(self, i: int) -> Tuple[np.ndarray, np.ndarray]:
        rng = self._item_rng(i)
        lp = self.left[i]
        rp = lp.replace("left", "right")
        if not os.path.exists(rp):
            raise FileNotFoundError(f"missing right image {rp} (left/right names must match)")
        a = floor_to_multiple(_load(lp), self.multiple)
        b = floor_to_multiple(_load(rp), self.multiple)
        if self.random_crop:
            a, b = _joint_crop(rng, *self.crop, a, b)
        return np.ascontiguousarray(a), np.ascontiguousarray(b)


class FIFEnhanceDataset(_EpochSeeded):
    """(SI_warped, reconstructed, original) triplets: each image under
    ``reconstructed_dir`` and the files at its path with ``reconstructed``
    replaced by ``original`` and by ``SI_warped``; with ``random_crop`` the
    same random (ch, cw) window of all three, upscaled first where it does
    not fit (reference StereoDataset_FIF_enhance, datasets.py:284-316)."""

    def __init__(self, reconstructed_dir: str, random_crop: bool = False,
                 crop: Tuple[int, int] = (320, 1216), seed: int = 1234):
        self.rec = _list_images(reconstructed_dir)
        if not self.rec:
            raise FileNotFoundError(f"no images under {reconstructed_dir}")
        self.random_crop = random_crop
        self.crop = crop
        self.seed = seed

    def __len__(self):
        return len(self.rec)

    def __getitem__(self, i: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        rng = self._item_rng(i)
        rp = self.rec[i]
        im_rec = _load(rp)
        im_orig = _load(rp.replace("reconstructed", "original"))
        im_si = _load(rp.replace("reconstructed", "SI_warped"))
        if self.random_crop:
            ch, cw = self.crop
            h, w, im_rec, im_orig, im_si = _fit_for_crop(ch, cw, im_rec, im_orig, im_si)
            top = rng.randint(0, h - ch)
            left = rng.randint(0, w - cw)
            sl = np.s_[top: top + ch, left: left + cw]
            im_rec, im_orig, im_si = im_rec[sl], im_orig[sl], im_si[sl]
        return (np.ascontiguousarray(im_si), np.ascontiguousarray(im_rec),
                np.ascontiguousarray(im_orig))


class StereoPassrDataset(_EpochSeeded):
    """(LR left, HR right, HR left) for stereo SR training: KITTI-layout
    pairs (``StereoKittiDataset``'s list, no jitter), the same (ch, cw)
    window of both eyes (random in training, centred otherwise; upscaled
    first where it does not fit), the left eye blurred by a ÷2 bilinear
    resize round trip (reference StereoDataset_passrNet, datasets.py:319-362)."""

    def __init__(self, roots: Sequence[str], train: bool = True,
                 crop: Tuple[int, int] = (320, 320), seed: int = 1234):
        self.pairs = StereoKittiDataset(roots, train=train, crop=None, jitter=False,
                                        seed=seed).pairs
        self.train = train
        self.crop = crop
        self.seed = seed

    def __len__(self):
        return len(self.pairs)

    def __getitem__(self, i: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        rng = self._item_rng(i)
        lp, rp = self.pairs[i]
        ch, cw = self.crop
        h, w, left, right = _fit_for_crop(ch, cw, _load(lp), _load(rp))
        if self.train:
            top = rng.randint(0, h - ch)
            lft = rng.randint(0, w - cw)
        else:
            top, lft = (h - ch) // 2, (w - cw) // 2
        left = left[top: top + ch, lft: lft + cw]
        right = right[top: top + ch, lft: lft + cw]
        blurry = _resize(_resize(left, ch // 2, cw // 2), ch, cw)
        return (np.ascontiguousarray(blurry), np.ascontiguousarray(right),
                np.ascontiguousarray(left))


class StereoPlusDataset(_EpochSeeded):
    """A stereo pair (the right eye matched to the left by basename) and a
    random-resized crop of a third image, the contrastive negative
    (reference StereoPlusDataset, datasets.py:365-410). ``random_crop``: the
    same (ch, cw) window of both eyes (upscaled first where it does not
    fit)."""

    def __init__(self, left_dir: str, right_dir: str, contrast_dir: str,
                 random_crop: bool = False, crop: Tuple[int, int] = (368, 368),
                 contrast_size: int = 368, seed: int = 1234):
        self.left = _list_images(left_dir)
        self.right_dir = right_dir
        self.contrast = _list_images(contrast_dir)
        if not self.left or not self.contrast:
            raise FileNotFoundError("empty stereo or contrast folder")
        self.random_crop = random_crop
        self.crop = crop
        self.contrast_size = contrast_size
        self.seed = seed

    def __len__(self):
        return len(self.left)

    def __getitem__(self, i: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        rng = self._item_rng(i)
        lp = self.left[i]
        a, b = _load(lp), _load(os.path.join(self.right_dir, os.path.basename(lp)))
        c = _random_resized_crop(_load(self.contrast[i % len(self.contrast)]),
                                 self.contrast_size, rng)
        if self.random_crop:
            ch, cw = self.crop
            h, w, a, b = _fit_for_crop(ch, cw, a, b)
            top = rng.randint(0, h - ch)
            left = rng.randint(0, w - cw)
            a = a[top: top + ch, left: left + cw]
            b = b[top: top + ch, left: left + cw]
        return np.ascontiguousarray(a), np.ascontiguousarray(b), c


def _assemble_batch(items):
    if isinstance(items[0], tuple):
        return tuple(np.stack([it[j] for it in items]) for j in range(len(items[0])))
    return np.stack(items)


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
    """DataLoader replacement: yields stacked numpy batches (for items that
    are tuples, a tuple of stacked arrays).

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
            yield _assemble_batch([dataset[i] for i in chunk])
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
            yield _assemble_batch([f.result() for f in futs])
    finally:
        ex.shutdown(wait=False, cancel_futures=True)
