"""File-level image codec, Ballé-17 kind: HWC image → ``.icz`` bytes → image.

Counterpart of the Ballé-17 parts of
``iclr_17_compression_tpu/coding/codec_cli.py``; the byte layout is the same
``KIND_BALLE17`` container:

  b"ICZ1" | kind u8 | len(name) u8 | name | N u16 | H u32 | W u32 |
  lat_h u16 | lat_w u16 | lat_c u16 | zmin i16 | zmax i16 | len u32 | rANS

Encode on CUDA: pad to a multiple of 16, the encoder as three K2 launches,
K3 (step 1, lim 32767, 16-bit symbols: every latent the header's i16
zmin/zmax can describe, as the JAX codec codes) turns the latent into
symbols on the device and only those cross to the host, then the CDF tables
and rANS. Decode:
rANS, then the decoder (deconvs with a K1 IGDN after each of the first
two), clipped to [0, 1].

Usage (PIL is needed for PNG files only):
  python -m iclr_17_compression_tpu_torch.coding.codec_cli \
      encode in.png out.icz --ckpt results/ckpts/lam2048_iter_19000.ckpt
  python -m iclr_17_compression_tpu_torch.coding.codec_cli \
      decode out.icz rec.png --ckpt results/ckpts/lam2048_iter_19000.ckpt
"""

import argparse
import struct
from typing import Optional, Tuple

import numpy as np
import torch

from ..ops.kernels.quant_pack_kernel import quantize_pack
from ..utils.device import resolve_device
from .api import build_cdf_tables_from_bit_estimator, decode_latent, encode_latent

MAGIC = b"ICZ1"
KIND_BALLE17 = 1
PAD_MULTIPLE = 16
SYMBOL_LIM = 32767  # K3 at step 1, 16 bits: symbols 0..65534 stand for latents ±32767


def pad_to_multiple(img: np.ndarray, m: int) -> np.ndarray:
    h, w = img.shape[:2]
    ph = (-h) % m
    pw = (-w) % m
    if ph == 0 and pw == 0:
        return img
    return np.pad(img, ((0, ph), (0, pw), (0, 0)), mode="edge")


def _pack_bytes(b: bytes) -> bytes:
    return struct.pack("<I", len(b)) + b


class _Reader:
    def __init__(self, data: bytes):
        self.data = data
        self.off = 0

    def take(self, fmt: str):
        vals = struct.unpack_from("<" + fmt, self.data, self.off)
        self.off += struct.calcsize("<" + fmt)
        return vals if len(vals) > 1 else vals[0]

    def take_bytes(self) -> bytes:
        n = self.take("I")
        b = self.data[self.off: self.off + n]
        self.off += n
        return b


def _header(kind: int, name: str, n: int, h: int, w: int) -> bytes:
    nb = name.encode()
    return MAGIC + struct.pack("<BB", kind, len(nb)) + nb + struct.pack("<HII", n, h, w)


def _read_header(r: _Reader) -> Tuple[int, str, int, int, int]:
    if r.data[:4] != MAGIC:
        raise ValueError("not an ICZ1 bitstream")
    r.off = 4
    kind, nlen = r.take("BB")
    name = r.data[r.off: r.off + nlen].decode()
    r.off += nlen
    n, h, w = r.take("HII")
    return kind, name, n, h, w


def encode_image(image: np.ndarray, model, device: Optional[str] = None) -> bytes:
    """image: HWC float in [0, 1] → ICZ1 bytes. ``model`` is a
    ``Balle17Compressor``; it is moved to ``device`` (default ``cuda``)."""
    dev = resolve_device(device)
    model = model.to(dev)
    h0, w0 = image.shape[:2]
    x = torch.from_numpy(np.ascontiguousarray(pad_to_multiple(image, PAD_MULTIPLE)[None],
                                              np.float32)).to(dev)
    with torch.no_grad():
        symbols, _ = quantize_pack(model.Encoder(x), 1.0, float(SYMBOL_LIM), bits=16)
    sym = symbols[0].cpu().numpy()
    if sym.min() == 0 or sym.max() == 2 * SYMBOL_LIM:
        # beyond what the i16 header fields hold; the JAX codec cannot write
        # such a latent either
        raise ValueError(f"latent reaches ±{SYMBOL_LIM} and may have been clipped")
    lat = sym.astype(np.int64) - SYMBOL_LIM
    zmin, zmax = int(lat.min()), int(lat.max())
    codec = build_cdf_tables_from_bit_estimator(model.bitEstimator.params(), zmin, zmax)
    stream = encode_latent(codec, lat)
    lh, lw, lc = lat.shape
    return (
        _header(KIND_BALLE17, "balle17", model.out_channel_n, h0, w0)
        + struct.pack("<HHHhh", lh, lw, lc, zmin, zmax)
        + _pack_bytes(stream)
    )


def read_latent(data: bytes, model) -> Tuple[np.ndarray, int, int]:
    """Parse an ICZ1 Ballé-17 file and rANS-decode its latent:
    (latent (h, w, c) int64, image height, image width)."""
    r = _Reader(data)
    kind, name, n, h0, w0 = _read_header(r)
    if kind != KIND_BALLE17:
        raise ValueError(f"kind {kind} ({name!r}) is not a Ballé-17 file; the port "
                         "decodes only that kind so far")
    if n != model.out_channel_n:
        raise ValueError(f"file has N={n}, model has N={model.out_channel_n}")
    lh, lw, lc, zmin, zmax = r.take("HHHhh")
    stream = r.take_bytes()
    codec = build_cdf_tables_from_bit_estimator(model.bitEstimator.params(), zmin, zmax)
    return decode_latent(codec, stream, (lh, lw, lc)), h0, w0


def decode_image(data: bytes, model, device: Optional[str] = None) -> np.ndarray:
    """ICZ1 bytes → HWC float reconstruction in [0, 1]. ``model`` is a
    ``Balle17Compressor``; it is moved to ``device`` (default ``cuda``)."""
    dev = resolve_device(device)
    model = model.to(dev)
    lat, h0, w0 = read_latent(data, model)
    z = torch.from_numpy(lat.astype(np.float32)[None]).to(dev)
    with torch.no_grad():
        recon = model.Decoder(z)
    return np.clip(recon[0, :h0, :w0].cpu().numpy(), 0.0, 1.0)


def main(argv=None):
    from PIL import Image

    from ..train.weights import load_balle17

    ap = argparse.ArgumentParser(prog="codec_cli", description=__doc__.split("\n\n")[0])
    ap.add_argument("cmd", choices=["encode", "decode"])
    ap.add_argument("src")
    ap.add_argument("dst")
    ap.add_argument("--ckpt", required=True, help="flax msgpack params of a Ballé-17 model")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    model = load_balle17(args.ckpt, device=args.device)
    if args.cmd == "encode":
        img = np.asarray(Image.open(args.src).convert("RGB"), np.float32) / 255.0
        data = encode_image(img, model, device=args.device)
        with open(args.dst, "wb") as f:
            f.write(data)
        print(f"{args.dst}: {len(data)} bytes, {8 * len(data) / (img.shape[0] * img.shape[1]):.4f} bpp")
    else:
        with open(args.src, "rb") as f:
            rec = decode_image(f.read(), model, device=args.device)
        u8 = np.clip(rec * 255.0 + 0.5, 0, 255).astype(np.uint8)
        Image.fromarray(u8).save(args.dst)


if __name__ == "__main__":
    main()
