"""Port parity of the training data: the same crops, flips, batches and
order as the JAX package's ``data/datasets.py`` for the same seed, epoch and
skip, bit for bit, without Pillow on the port's side for PPM files.

The port's bilinear resize is Pillow's 8-bit resampler written in numpy,
held here byte for byte against Pillow at random sizes, up and down; its
PPM reader equals Pillow's pixels.
"""

import numpy as np
import pytest
from PIL import Image

from iclr_17_compression_tpu.data import datasets as jdata
from iclr_17_compression_tpu_torch.data import datasets as tdata


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    """Seven images of assorted sizes, PNG and PPM, one smaller than a
    64-pixel crop."""
    d = tmp_path_factory.mktemp("imgs")
    rng = np.random.default_rng(0)
    sizes = [(80, 96), (64, 64), (120, 72), (50, 90), (96, 160), (70, 70), (100, 64)]
    for i, (h, w) in enumerate(sizes):
        img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        if i % 2:
            tdata.write_ppm(str(d / f"{i}.ppm"), img / 255.0)
        else:
            Image.fromarray(img).save(d / f"{i}.png")
    return str(d)


def test_resize_is_pillows_bilinear():
    rng = np.random.default_rng(1)
    for _ in range(40):
        h, w, oh, ow = (int(v) for v in rng.integers(1, 200, 4))
        img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        ref = np.asarray(Image.fromarray(img).resize((ow, oh), Image.BILINEAR))
        np.testing.assert_array_equal(tdata.resize_uint8(img, oh, ow), ref)


def test_ppm_reader_equals_pillow(tmp_path):
    img = np.random.default_rng(2).random((37, 53, 3))
    path = str(tmp_path / "x.ppm")
    tdata.write_ppm(path, img)
    with open(path, "rb") as f:
        ours = tdata._read_ppm(f.read())
    np.testing.assert_array_equal(ours, np.asarray(Image.open(path).convert("RGB")))
    np.testing.assert_array_equal(tdata._load(path), jdata._load(path))


@pytest.mark.parametrize("random_resized", [True, False])
def test_crops_equal_jax(folder, random_resized):
    jset = jdata.ImageFolderDataset(folder, 64, seed=7, random_resized=random_resized)
    tset = tdata.ImageFolderDataset(folder, 64, seed=7, random_resized=random_resized)
    assert len(tset) == len(jset) == 7
    for epoch in (0, 3):
        jset.set_epoch(epoch)
        tset.set_epoch(epoch)
        for i in range(len(tset)):
            a, b = tset[i], jset[i]
            assert a.dtype == b.dtype == np.float32 and a.shape == (64, 64, 3)
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("num_workers,skip", [(0, 0), (2, 1)])
def test_batch_iterator_equals_jax(folder, num_workers, skip):
    jset = jdata.ImageFolderDataset(folder, 64, seed=3)
    tset = tdata.ImageFolderDataset(folder, 64, seed=3)
    for epoch in (0, 1):
        jb = list(jdata.batch_iterator(jset, 2, seed=3, epoch=epoch, skip=skip))
        tb = list(tdata.batch_iterator(tset, 2, seed=3, epoch=epoch, skip=skip,
                                       num_workers=num_workers))
        assert len(tb) == len(jb) == 3 - skip
        for a, b in zip(tb, jb):
            np.testing.assert_array_equal(a, b)


def test_kodak_set_and_floor_to_multiple_equal_jax(folder):
    jset, tset = jdata.KodakDataset(folder), tdata.KodakDataset(folder)
    for i in range(len(tset)):
        np.testing.assert_array_equal(tset[i], jset[i])
        assert tset[i].shape[0] % 16 == 0 and tset[i].shape[1] % 16 == 0
    img = np.zeros((37, 53, 3), np.float32)
    assert tdata.floor_to_multiple(img, 8).shape == jdata.floor_to_multiple(img, 8).shape
