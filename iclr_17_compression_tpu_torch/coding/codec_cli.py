"""File-level image codec: HWC image → ``.icz`` bytes → image.

Counterpart of the Ballé-17 and DSC parts of
``iclr_17_compression_tpu/coding/codec_cli.py``; the byte layouts are the
same containers. Common header:

  b"ICZ1" | kind u8 | len(name) u8 | name | N u16 | H u32 | W u32

``KIND_BALLE17`` (1): lat_h u16 | lat_w u16 | lat_c u16 | zmin i16 |
zmax i16 | len u32 | rANS. Encode on CUDA: pad to a multiple of 16, the
encoder as three K2 launches, K3 (step 1, lim 32767, 16-bit symbols: every
latent the header's i16 zmin/zmax can describe, as the JAX codec codes)
turns the latent into symbols on the device and only those cross to the
host, then the CDF tables and rANS. Decode: rANS, then the decoder (deconvs
with a K1 IGDN after each of the first two), clipped to [0, 1].

``KIND_DSC`` (7), the DSC stereo codec: the transmitted coarse code alone,
as ``serialize_dsc_code`` writes it (code h, w, c u16 | step f32 | offset
i16 | nsym u16 | per-channel histogram tables uint16 | len u32 | rANS).
Encode on CUDA: pad to a multiple of the preset's ``code_div``, ``g_a`` (3 K2
launches at the flagship) and ``g_a22`` (1), then K3 at the preset's step
and clip (uint8 symbols at step 16 / clip 128), and only the symbols cross
to the host. Decode needs the receiver's own side-information image: the
code and the SI image (padded alike) go through ``DSCDecoder`` (``g_a`` on
the SI image, ``g_s22``, the fusion, ``g_s``: 7 K2 launches). The header's
N is 0, what the JAX CLI writes there by default (its ``--n``; neither
decoder reads it for DSC), so that the files are byte-equal.

``KIND_DSC_COMPOSITE`` (8), the two-stage 0.0625-bpp point: the base
preset's name in the header, then len u8 | the regression preset's name |
len u32 | base payload | len u32 | regression payload. Decode adds the
regression stage's unclipped output to the base reconstruction and clips.

Usage (inputs are read as the training loaders read them: PPM and 8-bit
PNG without Pillow, other formats with it; a ``.ppm`` output is written
without Pillow; ``--device cpu`` runs the plain path on the CPU; ``--ckpt``
of a DSC model may also be a train state the port's trainer wrote):
  python -m iclr_17_compression_tpu_torch.coding.codec_cli \
      encode in.png out.icz --ckpt results/ckpts/lam2048_iter_19000.ckpt
  python -m iclr_17_compression_tpu_torch.coding.codec_cli \
      decode out.icz rec.png --ckpt results/ckpts/lam2048_iter_19000.ckpt
  python -m iclr_17_compression_tpu_torch.coding.codec_cli \
      encode left.png out.icz --model temp_0031bpp --ckpt flagship.msgpack
  python -m iclr_17_compression_tpu_torch.coding.codec_cli \
      decode out.icz rec.png --ckpt flagship.msgpack --si right.png
  (add --reg-ckpt reg.msgpack [--reg-model reg_0_0625] to both for the
  two-stage file)
"""

import argparse
import struct
from typing import Optional, Tuple

import numpy as np
import torch

from ..models.dsc import (DSC_PRESETS, UNCLIPPED_LIM, DSCDecoder, DSCStereoModel, code_symbols,
                          quantize_code)
from ..ops.kernels.quant_pack_kernel import quantize_pack
from ..utils.device import resolve_device
from .api import (RansCodec, build_cdf_tables_from_bit_estimator,
                  build_cdf_tables_from_histogram, decode_latent, encode_latent)

MAGIC = b"ICZ1"
KIND_BALLE17 = 1
KIND_DSC = 7  # DSC coarse code, uint16 freq tables
KIND_DSC_COMPOSITE = 8  # base DSC code + rate-regression residual code
PAD_MULTIPLE = 16
SYMBOL_LIM = UNCLIPPED_LIM  # K3 at step 1, 16 bits: symbols 0..65534 stand for latents ±32767


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


def _image_tensor(image: np.ndarray, mult: int, dev: torch.device) -> torch.Tensor:
    x = pad_to_multiple(image, mult)[None]
    return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(dev)


def encode_image(image: np.ndarray, model, device: Optional[str] = None) -> bytes:
    """image: HWC float in [0, 1] → ICZ1 bytes. ``model`` is a
    ``Balle17Compressor`` or a ``DSCStereoModel``; it is moved to ``device``
    (default ``cuda``)."""
    dev = resolve_device(device)
    model = model.to(dev)
    h0, w0 = image.shape[:2]
    if isinstance(model, DSCStereoModel):
        cfg = model.config
        return (_header(KIND_DSC, cfg.name, 0, h0, w0)
                + _encode_dsc_payload(_image_tensor(image, cfg.code_div, dev), model))
    x = _image_tensor(image, PAD_MULTIPLE, dev)
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
        raise ValueError(f"kind {kind} ({name!r}) is not a Ballé-17 file")
    if n != model.out_channel_n:
        raise ValueError(f"file has N={n}, model has N={model.out_channel_n}")
    lh, lw, lc, zmin, zmax = r.take("HHHhh")
    stream = r.take_bytes()
    codec = build_cdf_tables_from_bit_estimator(model.bitEstimator.params(), zmin, zmax)
    return decode_latent(codec, stream, (lh, lw, lc)), h0, w0


def serialize_dsc_code(syms: np.ndarray, step: float, code_clip) -> bytes:
    """One DSC coarse code (h, w, c) of integer symbols (code / step) → the
    payload the container carries: shape, step and table header, the
    per-channel histogram tables as uint16, the rANS stream. Symbols are
    clipped to ±code_clip/step first (the JAX package's function)."""
    syms = np.asarray(syms, np.int64)
    if code_clip is not None:
        lim = int(code_clip / step)
        syms = np.clip(syms, -lim, lim)
        offset, nsym = -lim, 2 * lim + 1
    else:
        offset, nsym = int(syms.min()), int(syms.max()) - int(syms.min()) + 1
    codec = build_cdf_tables_from_histogram(syms, offset=offset, nsym=nsym)
    stream = encode_latent(codec, syms)
    ch, cw, cc = syms.shape
    payload = struct.pack("<HHHfhH", ch, cw, cc, float(step), offset, nsym)
    payload += codec.freqs.astype(np.uint16).tobytes()
    return payload + _pack_bytes(stream)


def dsc_symbols(x: torch.Tensor, model: DSCStereoModel) -> Tuple[np.ndarray, torch.Tensor]:
    """The transmitter on a padded NHWC batch of one: (the code's integer
    symbols (h, w, c) on the host, the dequantized code on the device).
    K3 makes both in one pass; only its uint8/uint16 symbols cross to the
    host."""
    with torch.no_grad():
        symbols, code = quantize_code(model.encode(x), model.config)
    lim, _ = code_symbols(model.config)
    return symbols[0].cpu().numpy().astype(np.int64) - lim, code


def _encode_dsc_payload(x: torch.Tensor, model: DSCStereoModel) -> bytes:
    syms, _ = dsc_symbols(x, model)
    return serialize_dsc_code(syms, float(model.config.coarse_step), model.config.code_clip)


def decode_dsc_payload(payload: bytes) -> np.ndarray:
    """The inverse of ``serialize_dsc_code``: the dequantized code (1, h, w, c)."""
    r = _Reader(payload)
    ch, cw, cc, step, offset, nsym = r.take("HHHfhH")
    freqs = np.frombuffer(r.data[r.off: r.off + 2 * cc * nsym], np.uint16).reshape(cc, nsym)
    r.off += 2 * cc * nsym
    stream = r.take_bytes()
    codec = RansCodec(freqs.astype(np.uint32), offset=offset)
    syms = decode_latent(codec, stream, (ch, cw, cc))
    return (syms.astype(np.float32) * step)[None]


def read_dsc_code(data: bytes) -> Tuple[np.ndarray, str, int, int]:
    """Parse an ICZ1 DSC file: (dequantized code (1, h, w, c), preset
    name, image height, image width)."""
    r = _Reader(data)
    kind, name, _, h0, w0 = _read_header(r)
    if kind != KIND_DSC:
        raise ValueError(f"kind {kind} ({name!r}) is not a DSC file")
    return decode_dsc_payload(data[r.off:]), name, h0, w0


def read_dsc_composite(data: bytes) -> Tuple[str, str, np.ndarray, np.ndarray, int, int]:
    """Parse a two-stage file: (base preset, regression preset, base code,
    regression code, image height, image width); the codes dequantized,
    (1, h, w, c) each."""
    r = _Reader(data)
    kind, base_name, _, h0, w0 = _read_header(r)
    if kind != KIND_DSC_COMPOSITE:
        raise ValueError("not a two-stage (composite) DSC file")
    nlen = r.take("B")
    reg_name = r.data[r.off: r.off + nlen].decode()
    r.off += nlen
    base_code = decode_dsc_payload(r.take_bytes())
    return base_name, reg_name, base_code, decode_dsc_payload(r.take_bytes()), h0, w0


def _check_preset(model, name: str) -> None:
    if not isinstance(model, DSCStereoModel) or model.config.name != name:
        got = model.config.name if isinstance(model, DSCStereoModel) else type(model).__name__
        raise ValueError(f"the file is coded with the DSC preset {name!r}, not {got}")


def _decode_dsc(model: DSCStereoModel, code: np.ndarray, si: torch.Tensor,
                clip: bool = True) -> torch.Tensor:
    decoder = DSCDecoder(model.config, clip=clip, model=model)
    with torch.no_grad():
        return decoder(torch.from_numpy(code).to(si.device), si)


def decode_image(data: bytes, model, device: Optional[str] = None,
                 si_image: Optional[np.ndarray] = None) -> np.ndarray:
    """ICZ1 bytes → HWC float reconstruction in [0, 1]. ``model`` is the
    ``Balle17Compressor`` or ``DSCStereoModel`` the file was coded with; it
    is moved to ``device`` (default ``cuda``). A DSC file also needs the
    receiver's side-information image ``si_image`` (HWC in [0, 1])."""
    dev = resolve_device(device)
    model = model.to(dev)
    if _read_header(_Reader(data))[0] == KIND_DSC:
        code, name, h0, w0 = read_dsc_code(data)
        _check_preset(model, name)
        if si_image is None:
            raise ValueError(f"{name!r} is a DSC codec: decoding needs the receiver's "
                             "side-information image")
        recon = _decode_dsc(model, code, _image_tensor(si_image, model.config.code_div, dev))
        return recon[0, :h0, :w0].cpu().numpy()
    lat, h0, w0 = read_latent(data, model)
    z = torch.from_numpy(lat.astype(np.float32)[None]).to(dev)
    with torch.no_grad():
        recon = model.Decoder(z)
    return np.clip(recon[0, :h0, :w0].cpu().numpy(), 0.0, 1.0)


def encode_composite(image: np.ndarray, base_model: DSCStereoModel, reg_model: DSCStereoModel,
                     device: Optional[str] = None) -> bytes:
    """Two-stage encode: the base model's coarse code and the regression
    stage's code of the same image in one container (the 0.0625-bpp point)."""
    dev = resolve_device(device)
    base_model, reg_model = base_model.to(dev), reg_model.to(dev)
    base, reg = base_model.config, reg_model.config
    h0, w0 = image.shape[:2]
    x = _image_tensor(image, max(base.code_div, reg.code_div), dev)
    rb = reg.name.encode()
    return (_header(KIND_DSC_COMPOSITE, base.name, 0, h0, w0)
            + struct.pack("<B", len(rb)) + rb
            + _pack_bytes(_encode_dsc_payload(x, base_model))
            + _pack_bytes(_encode_dsc_payload(x, reg_model)))


def decode_composite(data: bytes, base_model: DSCStereoModel, reg_model: DSCStereoModel,
                     si_image: np.ndarray, device: Optional[str] = None) -> np.ndarray:
    """clip(base recon + residual) from a two-stage file and the SI image."""
    dev = resolve_device(device)
    base_model, reg_model = base_model.to(dev), reg_model.to(dev)
    base_name, reg_name, base_code, reg_code, h0, w0 = read_dsc_composite(data)
    _check_preset(base_model, base_name)
    _check_preset(reg_model, reg_name)
    si = _image_tensor(si_image, max(base_model.config.code_div, reg_model.config.code_div), dev)
    final = torch.clamp(_decode_dsc(base_model, base_code, si)
                        + _decode_dsc(reg_model, reg_code, si, clip=False), 0.0, 1.0)
    return final[0, :h0, :w0].cpu().numpy()


def main(argv=None):
    from ..data.datasets import _load as load_image
    from ..train.weights import load_balle17, load_dsc

    ap = argparse.ArgumentParser(prog="codec_cli", description=__doc__.split("\n\n")[0])
    ap.add_argument("cmd", choices=["encode", "decode"])
    ap.add_argument("src")
    ap.add_argument("dst")
    ap.add_argument("--ckpt", required=True,
                    help="flax msgpack params of a Ballé-17 or DSC model, or a DSC train "
                         "state the port's trainer wrote")
    ap.add_argument("--model", default="balle17",
                    help="encode: balle17 or a DSC preset name (decode reads it from the file)")
    ap.add_argument("--si", default="", help="side-information image (DSC decode)")
    ap.add_argument("--reg-ckpt", default="",
                    help="rate-regression stage params: a two-stage file (0.0625 bpp)")
    ap.add_argument("--reg-model", default="reg_0_0625", help="regression-stage DSC preset")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = args.device
    if args.cmd == "encode":
        img = load_image(args.src)
        if args.model == "balle17":
            data = encode_image(img, load_balle17(args.ckpt, device=dev), device=dev)
        elif args.reg_ckpt:
            data = encode_composite(img, load_dsc(args.ckpt, args.model, dev),
                                    load_dsc(args.reg_ckpt, args.reg_model, dev), device=dev)
        else:
            data = encode_image(img, load_dsc(args.ckpt, args.model, dev), device=dev)
        with open(args.dst, "wb") as f:
            f.write(data)
        print(f"{args.dst}: {len(data)} bytes, "
              f"{8 * len(data) / (img.shape[0] * img.shape[1]):.4f} bpp")
        return
    with open(args.src, "rb") as f:
        data = f.read()
    kind, name, _, _, _ = _read_header(_Reader(data))
    si = load_image(args.si) if args.si else None
    if kind == KIND_BALLE17:
        rec = decode_image(data, load_balle17(args.ckpt, device=dev), device=dev)
    elif kind == KIND_DSC_COMPOSITE:
        if si is None or not args.reg_ckpt:
            raise SystemExit("a two-stage file needs --si and --reg-ckpt")
        reg_name = read_dsc_composite(data)[1]
        rec = decode_composite(data, load_dsc(args.ckpt, name, dev),
                               load_dsc(args.reg_ckpt, reg_name, dev), si, device=dev)
    elif kind == KIND_DSC and name in DSC_PRESETS:
        rec = decode_image(data, load_dsc(args.ckpt, name, dev), device=dev, si_image=si)
    else:
        raise SystemExit(f"kind {kind} ({name!r}): the port decodes Ballé-17 and DSC files")
    u8 = np.clip(rec * 255.0 + 0.5, 0, 255).astype(np.uint8)
    if args.dst.lower().endswith(".ppm"):
        with open(args.dst, "wb") as f:
            f.write(b"P6\n%d %d\n255\n" % (u8.shape[1], u8.shape[0]) + u8.tobytes())
    else:
        from PIL import Image

        Image.fromarray(u8).save(args.dst)


if __name__ == "__main__":
    main()
