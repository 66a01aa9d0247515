"""A frozen reader of flax msgpack files (``flax.serialization``), with the
standard library and numpy alone: maps, arrays, strings, binaries,
integers, floats, nil, bools and flax's ext types 1 (ndarray) and 3 (numpy
scalar), each packed as msgpack ``(shape, dtype name, buffer)``. The
benchmark reads the archived weights with it, so that what the port's own
reader does cannot change what the benchmark feeds both sides.
"""

import struct

import numpy as np


class _Unpacker:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.off = 0
        n = self._num
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
        if code in (1, 3):
            shape, dtype, buf = _Unpacker(payload).value()
            if isinstance(dtype, bytes):
                dtype = dtype.decode()
            arr = np.frombuffer(buf, dtype=np.dtype(dtype)).reshape(shape)
            return arr if code == 1 else arr[()]
        raise ValueError(f"unsupported msgpack ext type {code}")


def read(path: str):
    """The nested dicts of numpy arrays a flax msgpack file holds."""
    with open(path, "rb") as f:
        u = _Unpacker(f.read())
    tree = u.value()
    if u.off != len(u.data):
        raise ValueError(f"{path}: {len(u.data) - u.off} trailing bytes")
    return tree
