"""The port's stereo loaders and PNG decoder against the JAX package's and
Pillow's, on the CPU.

Stated tolerance: none, bit-equal. ``StereoKittiDataset`` (train and test
splits, the default 315×1215 crop with its upscale of smaller frames, and a
crop that fits), ``StereoHoloPixDataset`` (with and without its joint crop)
and ``_color_jitter`` give JAX's arrays for the same files, seed and epoch;
``batch_iterator`` gives JAX's tuple batches; the PNG decoder gives Pillow's
``convert("RGB")`` bytes for gray, gray+alpha, RGB and RGBA files that Pillow
writes with its adaptive filters (``optimize=True``: every one of the five
row filters appears in them).
"""

import io
import os
import random
import struct
import zlib

import numpy as np
import pytest
from PIL import Image

from iclr_17_compression_tpu.data import datasets as jdata
from iclr_17_compression_tpu_torch.data import datasets as tdata


def _frame(rng, h, w):
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img = 0.5 + 0.3 * np.sin(xx / 9.0 + rng.uniform(0, 6))[..., None] * rng.uniform(0.3, 1, 3)
    img = img + 0.2 * np.cos(yy / 7.0)[..., None] + 0.05 * rng.standard_normal((h, w, 3))
    return np.round(np.clip(img, 0, 1) * 255).astype(np.uint8)


@pytest.fixture(scope="module")
def stereo_dirs(tmp_path_factory):
    """Two KITTI roots (frames of two sizes, one smaller than the crop) and
    a HoloPix layout (left/right jpg folders)."""
    d = tmp_path_factory.mktemp("stereo")
    rng = np.random.default_rng(0)
    roots = []
    for r, (h, w) in enumerate(((80, 120), (330, 1230))):
        root = d / f"kitti{r}"
        for side in ("image_2", "image_3"):
            os.makedirs(root / side)
        for i in range(2):
            for t in (10, 11):
                a = _frame(rng, h, w)
                Image.fromarray(a).save(root / "image_2" / f"{i:06d}_{t}.png")
                Image.fromarray(np.roll(a, 4, axis=1)).save(root / "image_3" / f"{i:06d}_{t}.png")
        roots.append(str(root))
    holo = d / "holo"
    for side in ("left", "right"):
        os.makedirs(holo / side)
    for i in range(3):
        a = _frame(rng, 100, 140)
        Image.fromarray(a).save(holo / "left" / f"{i}_left.jpg", quality=90)
        Image.fromarray(np.roll(a, 5, axis=1)).save(holo / "right" / f"{i}_right.jpg", quality=90)
    return roots, str(holo / "left")


def _same_items(ours, ref, epochs=(0, 1)):
    assert len(ours) == len(ref)
    for epoch in epochs:
        ours.set_epoch(epoch)
        ref.set_epoch(epoch)
        for i in range(len(ours)):
            for x, y in zip(ours[i], ref[i]):
                assert x.dtype == y.dtype and x.shape == y.shape, (epoch, i)
                assert np.array_equal(x, y), (epoch, i)


@pytest.mark.parametrize("kw", [dict(train=True), dict(train=False),
                                dict(train=True, crop=(64, 96), multiple=16),
                                dict(train=True, jitter=False)],
                         ids=["train", "test", "crop64", "nojitter"])
def test_kitti_dataset_equals_jax(stereo_dirs, kw):
    roots, _ = stereo_dirs
    ours = tdata.StereoKittiDataset(roots, seed=7, **kw)
    ref = jdata.StereoKittiDataset(roots, seed=7, **kw)
    assert ours.pairs == ref.pairs
    if not kw["train"]:
        assert all(os.path.basename(p).endswith("_10.png") for p, _ in ours.pairs)
    _same_items(ours, ref, epochs=(0, 1) if kw["train"] else (0,))


@pytest.mark.parametrize("random_crop", [False, True])
def test_holopix_dataset_equals_jax(stereo_dirs, random_crop):
    _, left = stereo_dirs
    kw = dict(random_crop=random_crop, crop=(64, 64), seed=3)
    _same_items(tdata.StereoHoloPixDataset(left, **kw), jdata.StereoHoloPixDataset(left, **kw))


def test_color_jitter_equals_jax():
    img = np.random.default_rng(1).uniform(0, 1, (24, 40, 3)).astype(np.float32)
    for seed in range(5):
        ours = tdata._color_jitter(img, random.Random(seed))
        ref = jdata._color_jitter(img, random.Random(seed))
        assert ours.dtype == ref.dtype and np.array_equal(ours, ref)


def test_stereo_batches_equal_jax(stereo_dirs):
    roots, _ = stereo_dirs
    ours = tdata.StereoKittiDataset(roots[:1], crop=(64, 64), seed=2)
    ref = jdata.StereoKittiDataset(roots[:1], crop=(64, 64), seed=2)
    got = list(tdata.batch_iterator(ours, 2, seed=2, epoch=1, num_workers=2))
    want = list(jdata.batch_iterator(ref, 2, seed=2, epoch=1))
    assert len(got) == len(want) == 2
    for (a1, a2), (b1, b2) in zip(got, want):
        assert np.array_equal(a1, b1) and np.array_equal(a2, b2) and a1.shape == (2, 64, 64, 3)


def _filters(data):
    """The row filter types of a PNG written by Pillow."""
    pos, chunks, header = 8, [], None
    while pos < len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", data[pos + 8:pos + 8 + length])
        elif kind == b"IDAT":
            chunks.append(data[pos + 8:pos + 8 + length])
        pos += 12 + length
    rows = np.frombuffer(zlib.decompress(b"".join(chunks)), np.uint8)
    return set(rows.reshape(header[1], -1)[:, 0].tolist())


def test_png_decoder_equals_pillow():
    rng = np.random.default_rng(2)
    yy, xx = np.mgrid[0:48, 0:64]
    smooth = (128 + 100 * np.sin(xx / 7.0 + yy / 5.0))[..., None] + rng.normal(0, 2, (48, 64, 4))
    images = {"smooth": smooth, "noise": rng.integers(0, 256, (48, 64, 4)),
              "blocks": np.kron(rng.integers(0, 256, (6, 8, 4)), np.ones((8, 8, 1))) + xx[..., None]}
    filters = set()
    for name, img in images.items():
        img = np.clip(img, 0, 255).astype(np.uint8)
        for mode, arr in (("L", img[..., 0]), ("LA", img[..., :2]), ("RGB", img[..., :3]),
                          ("RGBA", img)):
            for optimize in (False, True):
                buf = io.BytesIO()
                Image.fromarray(arr, mode).save(buf, "PNG", optimize=optimize)
                data = buf.getvalue()
                filters |= _filters(data)
                want = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
                got = tdata._read_png(data)
                assert got.dtype == np.uint8 and np.array_equal(got, want), (name, mode)
    assert filters == {0, 1, 2, 3, 4}
    # not handled here (palette, 16 bits): None, so _load hands them to Pillow
    buf = io.BytesIO()
    Image.fromarray(np.zeros((4, 4), np.uint8), "L").convert("P").save(buf, "PNG")
    assert tdata._read_png(buf.getvalue()) is None
    buf = io.BytesIO()
    Image.fromarray(np.zeros((4, 4), np.uint16)).save(buf, "PNG")
    assert tdata._read_png(buf.getvalue()) is None
    assert tdata._read_png(b"P6\n1 1\n255\n\0\0\0") is None


def test_load_reads_png_as_pillow_does(tmp_path):
    img = _frame(np.random.default_rng(3), 30, 50)
    path = str(tmp_path / "a.png")
    Image.fromarray(img).save(path, optimize=True)
    assert np.array_equal(tdata._load(path), jdata._load(path))
