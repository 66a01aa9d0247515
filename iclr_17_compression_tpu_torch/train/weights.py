"""Weights of the JAX package, read and carried into the port.

``msgpack_restore`` reads a flax msgpack file (``flax.serialization``, as
written by ``iclr_17_compression_tpu/train/checkpoint.py``) with Python and
numpy alone: maps, arrays, strings, binaries, integers, floats, nil, bools
and flax's ext types, 1 = ndarray packed as msgpack ``(shape, dtype name,
buffer)`` and 3 = numpy scalar packed the same way. Chunked arrays (flax
splits leaves above 2 GB) are joined back.

``params_from_jax`` turns a JAX Ballé-17 parameter tree into the port's
``state_dict`` (reference PyTorch keys and layouts; the inverse of
``import_balle17`` in ``iclr_17_compression_tpu/train/torch_import.py``). It
checks every leaf's shape and dtype, and raises on a missing or extra key.
"""

import struct
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..models.balle17 import Balle17Compressor
from ..ops.conv import deconv_hwio_to_torch, hwio_to_oihw
from ..utils.device import resolve_device


class _Unpacker:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.off = 0
        n = self._num
        # type byte → reader, for the types outside the fix* ranges
        self._readers = {
            0xC0: lambda: None, 0xC2: lambda: False, 0xC3: lambda: True,
            0xC4: lambda: self._take(n("B")), 0xC5: lambda: self._take(n("H")),
            0xC6: lambda: self._take(n("I")),
            0xC7: lambda: self._ext(n("B")), 0xC8: lambda: self._ext(n("H")),
            0xC9: lambda: self._ext(n("I")),
            0xCA: lambda: n("f"), 0xCB: lambda: n("d"),
            0xCC: lambda: n("B"), 0xCD: lambda: n("H"), 0xCE: lambda: n("I"),
            0xCF: lambda: n("Q"),
            0xD0: lambda: n("b"), 0xD1: lambda: n("h"), 0xD2: lambda: n("i"),
            0xD3: lambda: n("q"),
            0xD4: lambda: self._ext(1), 0xD5: lambda: self._ext(2),
            0xD6: lambda: self._ext(4), 0xD7: lambda: self._ext(8),
            0xD8: lambda: self._ext(16),
            0xD9: lambda: self._take(n("B")).decode(),
            0xDA: lambda: self._take(n("H")).decode(),
            0xDB: lambda: self._take(n("I")).decode(),
            0xDC: lambda: self._array(n("H")), 0xDD: lambda: self._array(n("I")),
            0xDE: lambda: self._map(n("H")), 0xDF: lambda: self._map(n("I")),
        }

    def _take(self, n: int) -> bytes:
        if self.off + n > len(self.data):
            raise ValueError("truncated msgpack data")
        b = self.data[self.off: self.off + n]
        self.off += n
        return bytes(b)

    def _num(self, fmt: str):
        return struct.unpack(">" + fmt, self._take(struct.calcsize(fmt)))[0]

    def value(self):
        t = self._take(1)[0]
        if t <= 0x7F:
            return t
        if t >= 0xE0:
            return t - 0x100
        if 0x80 <= t <= 0x8F:
            return self._map(t & 0x0F)
        if 0x90 <= t <= 0x9F:
            return self._array(t & 0x0F)
        if 0xA0 <= t <= 0xBF:
            return self._take(t & 0x1F).decode()
        reader = self._readers.get(t)
        if reader is None:
            raise ValueError(f"unsupported msgpack type byte 0x{t:02x}")
        return reader()

    def _map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.value()
            out[k] = self.value()
        return out

    def _array(self, n: int) -> list:
        return [self.value() for _ in range(n)]

    def _ext(self, n: int):
        code = self._num("b")
        payload = self._take(n)
        if code in (1, 3):  # flax ndarray / numpy scalar
            shape, dtype, buf = _Unpacker(payload).value()
            if isinstance(dtype, bytes):
                dtype = dtype.decode()
            arr = np.frombuffer(buf, dtype=np.dtype(dtype)).reshape(shape)
            return arr if code == 1 else arr[()]
        raise ValueError(f"unsupported msgpack ext type {code}")


def _unchunk(tree):
    if isinstance(tree, dict):
        if "__msgpack_chunked_array__" in tree:
            shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
            chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
            return np.concatenate(chunks).reshape(shape)
        return {k: _unchunk(v) for k, v in tree.items()}
    return tree


def msgpack_restore(data: bytes):
    """Decode flax msgpack bytes into nested dicts of numpy arrays."""
    u = _Unpacker(data)
    tree = u.value()
    if u.off != len(u.data):
        raise ValueError(f"{len(u.data) - u.off} trailing bytes after the msgpack object")
    return _unchunk(tree)


def read_checkpoint(path: str):
    with open(path, "rb") as f:
        return msgpack_restore(f.read())


def _expected_balle17(n: int) -> Dict[str, tuple]:
    """JAX leaf path → shape, for a Ballé-17 model of width n."""
    shapes = {
        "encoder/conv1/weight": (9, 9, 3, n), "encoder/conv1/bias": (n,),
        "encoder/conv2/weight": (5, 5, n, n), "encoder/conv2/bias": (n,),
        "encoder/conv3/weight": (5, 5, n, n),
        "decoder/deconv1/weight": (5, 5, n, n), "decoder/deconv1/bias": (n,),
        "decoder/deconv2/weight": (5, 5, n, n), "decoder/deconv2/bias": (n,),
        "decoder/deconv3/weight": (9, 9, n, 3), "decoder/deconv3/bias": (3,),
    }
    for g in ("encoder/gdn1", "encoder/gdn2", "decoder/igdn1", "decoder/igdn2"):
        shapes[f"{g}/beta"] = (n,)
        shapes[f"{g}/gamma"] = (n, n)
    for f in ("f1", "f2", "f3", "f4"):
        for leaf in ("h", "b") + (("a",) if f != "f4" else ()):
            shapes[f"bit_estimator/{f}_{leaf}"] = (n,)
    return shapes


def _flatten(tree: Dict[str, Any], prefix: str = "") -> Dict[str, Any]:
    out = {}
    for k, v in tree.items():
        path = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_flatten(v, path + "/"))
        else:
            out[path] = v
    return out


def _port_key(path: str) -> str:
    """JAX leaf path → reference PyTorch state_dict key."""
    top, *rest = path.split("/")
    if top == "bit_estimator":
        f, leaf = rest[0].split("_")
        return f"bitEstimator.{f}.{leaf}"
    return {"encoder": "Encoder", "decoder": "Decoder"}[top] + "." + ".".join(rest)


def params_from_jax(tree: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX Ballé-17 params (nested dicts of arrays, bare or under "params")
    → the port's ``Balle17Compressor`` state_dict."""
    if set(tree) == {"params"}:
        tree = tree["params"]
    flat = _flatten(tree)
    w = flat.get("encoder/conv1/weight")
    if w is None or np.ndim(w) != 4:
        raise KeyError("encoder/conv1/weight missing: not a Ballé-17 parameter tree")
    expected = _expected_balle17(int(np.shape(w)[-1]))
    missing = sorted(set(expected) - set(flat))
    extra = sorted(set(flat) - set(expected))
    if missing or extra:
        raise KeyError(f"Ballé-17 params: missing {missing}, unexpected {extra}")
    sd = {}
    for path, shape in expected.items():
        v = np.asarray(flat[path])
        if v.dtype != np.float32:
            raise TypeError(f"{path}: dtype {v.dtype}, expected float32")
        if v.shape != shape:
            raise ValueError(f"{path}: shape {v.shape}, expected {shape}")
        if path.endswith("weight") and "/conv" in path:
            v = hwio_to_oihw(v)
        elif path.endswith("weight"):
            v = deconv_hwio_to_torch(v)
        sd[_port_key(path)] = torch.from_numpy(np.array(v, order="C"))
    return sd


def load_balle17(path: str, device: Optional[str] = None):
    """A ``Balle17Compressor`` in eval mode on ``device`` (default ``cuda``)
    with the weights of a JAX checkpoint or params file."""
    dev = resolve_device(device)
    sd = params_from_jax(read_checkpoint(path))
    model = Balle17Compressor(sd["Encoder.conv1.weight"].shape[0])
    model.load_state_dict(sd, strict=True)
    return model.to(dev).eval()
