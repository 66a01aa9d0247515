"""File-level image codec: HWC image → ``.icz`` bytes → image.

Counterpart of ``iclr_17_compression_tpu/coding/codec_cli.py`` (the
Ballé-17, hyperprior, joint-AR and DSC kinds, ``build_model`` and the
``encode`` / ``decode`` / ``roundtrip`` commands); the byte layouts are the
same containers. Common header:

  b"ICZ1" | kind u8 | len(name) u8 | name | N u16 | H u32 | W u32

``KIND_BALLE17`` (1): lat_h u16 | lat_w u16 | lat_c u16 | zmin i16 |
zmax i16 | len u32 | rANS. Encode on CUDA: pad to a multiple of 16, the
encoder as three K2 launches, K3 (step 1, lim 32767, 16-bit symbols: every
latent the header's i16 zmin/zmax can describe, as the JAX codec codes)
turns the latent into symbols on the device and only those cross to the
host, then the CDF tables and rANS. Decode: rANS, then the decoder (deconvs
with a K1 IGDN after each of the first two), clipped to [0, 1].

``KIND_HYPERPRIOR`` (5), the scale hyperprior (header name ``hyperprior``
or ``hyperprior-sigma``, the quantizer): M u16 | y h, w, c u16 | z h, w, c
u16 | max_sym u32 | zmin i16 | zmax i16 | len u32 | y rANS | len u32 | z
rANS. ``KIND_JOINT`` (6), the joint-AR codec (name ``joint``): y h, w, c u16
| z h, w, c u16 | max_sym u16 | zmin i16 | zmax i16 | the two streams. Both
pad to a multiple of 64. Encode on CUDA: the analysis transform (three K2
launches for either model), the hyper path and, for ``joint``, the host AR
context pass over wavefronts (``--ar-backend``, ``native`` by default, or
``numpy``: a file decodes only with the backend that encoded it). Decode:
the z stream, σ from the hyper decoder, the y stream (for ``joint``
symbol by symbol through the AR context), then the synthesis (three K1
IGDNs for the hyperprior, three K2 launches for ``joint``).

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
may also be a train state the port's trainer wrote, or a reference PyTorch
state_dict, ``.pth`` / ``.pth.tar`` / ``.pt``, loaded by its suffix under the
reference's partial load, ``train/weights.load_torch_state_dict``):
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
  python -m iclr_17_compression_tpu_torch.coding.codec_cli \
      encode in.png out.icz --model joint --ckpt joint.msgpack
  python -m iclr_17_compression_tpu_torch.coding.codec_cli \
      decode out.icz rec.png --ckpt joint.msgpack
  python -m iclr_17_compression_tpu_torch.coding.codec_cli \
      roundtrip in.png --model hyperprior --ckpt hyperprior.msgpack
(``--model hyperprior-sigma`` for σ-normalized symbols; ``--n`` / ``--m``
give the widths the checkpoint was trained at, 0 for the defaults 192 /
320; ``roundtrip`` prints the file's bytes and bpp and the decode's PSNR.)
"""

import argparse
import json
import struct
from typing import Optional, Tuple

import numpy as np
import torch

from ..models import cheng2020, hyperprior
from ..models.balle17 import Balle17Compressor
from ..models.cheng2020 import JointAutoregressive
from ..models.dsc import (DSC_PRESETS, UNCLIPPED_LIM, DSCDecoder, DSCStereoModel, code_symbols,
                          quantize_code)
from ..models.hyperprior import ScaleHyperprior
from ..ops.kernels.quant_pack_kernel import quantize_pack
from ..utils.device import resolve_device
from .api import (RansCodec, build_cdf_tables_from_bit_estimator,
                  build_cdf_tables_from_histogram, decode_latent, encode_latent)

MAGIC = b"ICZ1"
KIND_BALLE17 = 1
KIND_HYPERPRIOR = 5  # scale hyperprior: factorized z + Laplace(0, sigma) y
KIND_JOINT = 6  # joint-AR, wavefront symbol order
KIND_DSC = 7  # DSC coarse code, uint16 freq tables
KIND_DSC_COMPOSITE = 8  # base DSC code + rate-regression residual code
PAD_MULTIPLE = 16
HYPER_PAD_MULTIPLE = 64  # hyperprior and joint: ÷16 latent, ÷4 again for z
SYMBOL_LIM = UNCLIPPED_LIM  # K3 at step 1, 16 bits: symbols 0..65534 stand for latents ±32767


def pad_to_multiple(img: np.ndarray, m: int) -> np.ndarray:
    h, w = img.shape[:2]
    ph = (-h) % m
    pw = (-w) % m
    if ph == 0 and pw == 0:
        return img
    return np.pad(img, ((0, ph), (0, pw), (0, 0)), mode="edge")


def build_model(spec: str, n: int = 0, m: int = 0):
    """(kind, a model of ``spec`` with the port's default weights, pad
    multiple). ``n`` / ``m`` 0 are the model's defaults: Ballé-17 N 128,
    hyperprior and joint N 192, hyperprior M 320."""
    if spec == "balle17":
        return KIND_BALLE17, Balle17Compressor(n or 128), PAD_MULTIPLE
    if spec == "joint":
        return KIND_JOINT, JointAutoregressive(n or 192), HYPER_PAD_MULTIPLE
    if spec in ("hyperprior", "hyperprior-sigma"):
        quant = "sigma-norm" if spec.endswith("-sigma") else "round"
        return (KIND_HYPERPRIOR, ScaleHyperprior(n or 192, m or 320, quant=quant),
                HYPER_PAD_MULTIPLE)
    if spec in DSC_PRESETS:
        cfg = DSC_PRESETS[spec]
        return KIND_DSC, DSCStereoModel(cfg), cfg.code_div
    raise ValueError(f"unknown model {spec!r}; choose balle17, hyperprior, hyperprior-sigma, "
                     f"joint or one of {sorted(DSC_PRESETS)}")


def _hyper_name(model: ScaleHyperprior) -> str:
    return "hyperprior-sigma" if model.quant == "sigma-norm" else "hyperprior"


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


def encode_image(image: np.ndarray, model, device: Optional[str] = None,
                 ar_backend: str = "native") -> bytes:
    """image: HWC float in [0, 1] → ICZ1 bytes. ``model`` is a
    ``Balle17Compressor``, ``ScaleHyperprior``, ``JointAutoregressive`` or
    ``DSCStereoModel``; it is moved to ``device`` (default ``cuda``).
    ``ar_backend`` is the joint-AR codec's host backend."""
    dev = resolve_device(device)
    model = model.to(dev)
    h0, w0 = image.shape[:2]
    if isinstance(model, ScaleHyperprior):
        comp = hyperprior.compress(model, _image_tensor(image, HYPER_PAD_MULTIPLE, dev))
        return (_header(KIND_HYPERPRIOR, _hyper_name(model), model.out_channel_n, h0, w0)
                + struct.pack("<HHHHHHHIhh", model.out_channel_m, *comp.y_shape, *comp.z_shape,
                              comp.max_sym, comp.z_min, comp.z_max)
                + _pack_bytes(comp.y_stream) + _pack_bytes(comp.z_stream))
    if isinstance(model, JointAutoregressive):
        comp = cheng2020.compress(model, _image_tensor(image, HYPER_PAD_MULTIPLE, dev),
                                  backend=ar_backend)
        return (_header(KIND_JOINT, "joint", model.n, h0, w0)
                + struct.pack("<HHHHHHHhh", *comp.y_shape, *comp.z_shape, comp.max_sym,
                              comp.z_min, comp.z_max)
                + _pack_bytes(comp.y_stream) + _pack_bytes(comp.z_stream))
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


def read_hyperprior(data: bytes) -> Tuple[hyperprior.CompressedHyper, str, int, int, int, int]:
    """Parse a kind-5 file: (its streams, model name, N, M, image height,
    image width)."""
    r = _Reader(data)
    kind, name, n, h0, w0 = _read_header(r)
    if kind != KIND_HYPERPRIOR:
        raise ValueError(f"kind {kind} ({name!r}) is not a hyperprior file")
    m, *vals = r.take("HHHHHHHIhh")
    comp = hyperprior.CompressedHyper(
        y_stream=r.take_bytes(), z_stream=r.take_bytes(), y_shape=tuple(vals[:3]),
        z_shape=tuple(vals[3:6]), max_sym=vals[6], z_min=vals[7], z_max=vals[8],
        quant="sigma-norm" if name.endswith("-sigma") else "round")
    return comp, name, n, m, h0, w0


def read_joint(data: bytes) -> Tuple[cheng2020.CompressedImage, int, int, int]:
    """Parse a kind-6 file: (its streams, N, image height, image width)."""
    r = _Reader(data)
    kind, name, n, h0, w0 = _read_header(r)
    if kind != KIND_JOINT:
        raise ValueError(f"kind {kind} ({name!r}) is not a joint-AR file")
    vals = r.take("HHHHHHHhh")
    comp = cheng2020.CompressedImage(
        y_stream=r.take_bytes(), z_stream=r.take_bytes(), y_shape=tuple(vals[:3]),
        z_shape=tuple(vals[3:6]), max_sym=vals[6], z_min=vals[7], z_max=vals[8])
    return comp, n, h0, w0


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
                 si_image: Optional[np.ndarray] = None, ar_backend: str = "native") -> np.ndarray:
    """ICZ1 bytes → HWC float reconstruction in [0, 1]. ``model`` is the
    model the file was coded with; it is moved to ``device`` (default
    ``cuda``). A DSC file also needs the receiver's side-information image
    ``si_image`` (HWC in [0, 1]); a joint-AR file the ``ar_backend`` that
    encoded it."""
    dev = resolve_device(device)
    model = model.to(dev)
    kind = _read_header(_Reader(data))[0]
    if kind == KIND_HYPERPRIOR:
        comp, name, n, m, h0, w0 = read_hyperprior(data)
        if not isinstance(model, ScaleHyperprior) or (_hyper_name(model), model.out_channel_n,
                                                      model.out_channel_m) != (name, n, m):
            raise ValueError(f"the file is coded with {name} N={n} M={m}, not this model")
        return hyperprior.decompress(model, comp)[0, :h0, :w0]
    if kind == KIND_JOINT:
        comp, n, h0, w0 = read_joint(data)
        if not isinstance(model, JointAutoregressive) or model.n != n:
            raise ValueError(f"the file is coded with the joint-AR model at N={n}, not this model")
        return cheng2020.decompress(model, comp, backend=ar_backend)[0, :h0, :w0]
    if kind == KIND_DSC:
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


def _load_model(spec: str, ckpt: str, dev: Optional[str], n: int = 0, m: int = 0):
    """The model ``spec`` with the weights of ``ckpt``, in eval mode on
    ``dev``. Ballé-17 and DSC take their widths from the checkpoint; the
    hyperprior and joint models are built at ``n`` / ``m`` (0: 192 / 320)
    and the checkpoint must match them. A reference ``.pth`` goes by its
    suffix through ``load_torch_state_dict``, as the JAX CLI routes it
    through ``torch_import``."""
    from ..train.weights import load_balle17, load_dsc, load_weights

    if spec == "balle17":
        return load_balle17(ckpt, device=dev)
    if spec in DSC_PRESETS:
        return load_dsc(ckpt, spec, dev)
    dev = resolve_device(dev)
    _, model, _ = build_model(spec, n, m)
    return load_weights(model, ckpt).to(dev).eval()


def _decode_file(data: bytes, args, si: Optional[np.ndarray], reg_model=None, model=None):
    """Decode a file as the CLI's ``decode`` does, loading the model the
    header names unless one is given."""
    dev = args.device
    kind, name, n, _, _ = _read_header(_Reader(data))
    if kind == KIND_DSC_COMPOSITE:
        if si is None or not args.reg_ckpt:
            raise SystemExit("a two-stage file needs --si and --reg-ckpt")
        reg_name = read_dsc_composite(data)[1]
        return decode_composite(data, model or _load_model(name, args.ckpt, dev),
                                reg_model or _load_model(reg_name, args.reg_ckpt, dev), si,
                                device=dev)
    if kind == KIND_HYPERPRIOR:
        spec, m = name, read_hyperprior(data)[3]
    elif kind == KIND_JOINT:
        spec, m = "joint", 0
    elif kind == KIND_BALLE17 or (kind == KIND_DSC and name in DSC_PRESETS):
        spec = "balle17" if kind == KIND_BALLE17 else name
    else:
        raise SystemExit(f"kind {kind} ({name!r}): the port decodes the Ballé-17, hyperprior, "
                         "joint-AR and DSC files")
    if model is None:
        model = (_load_model(spec, args.ckpt, dev, n, m) if kind in (KIND_HYPERPRIOR, KIND_JOINT)
                 else _load_model(spec, args.ckpt, dev))
    return decode_image(data, model, device=dev, si_image=si, ar_backend=args.ar_backend)


def main(argv=None):
    from ..data.datasets import _load as load_image

    ap = argparse.ArgumentParser(prog="codec_cli", description=__doc__.split("\n\n")[0])
    ap.add_argument("cmd", choices=["encode", "decode", "roundtrip"])
    ap.add_argument("src")
    ap.add_argument("dst", nargs="?", help="the output file (encode, decode)")
    ap.add_argument("--ckpt", required=True,
                    help="flax msgpack params of a Ballé-17, hyperprior, joint-AR or DSC model, "
                         "a train state the port's trainer wrote, or a reference PyTorch "
                         "state_dict (.pth, .pth.tar, .pt)")
    ap.add_argument("--model", default="balle17",
                    help="encode / roundtrip: balle17, hyperprior, hyperprior-sigma, joint or a "
                         "DSC preset name (decode reads it from the file)")
    ap.add_argument("--n", type=int, default=0, help="hyperprior / joint N (0: 192)")
    ap.add_argument("--m", type=int, default=0, help="hyperprior M (0: 320)")
    ap.add_argument("--ar-backend", default="native", choices=["native", "numpy"],
                    help="the joint-AR host backend; a file decodes only with its encoder's")
    ap.add_argument("--si", default="", help="side-information image (DSC decode)")
    ap.add_argument("--reg-ckpt", default="",
                    help="rate-regression stage params: a two-stage file (0.0625 bpp)")
    ap.add_argument("--reg-model", default="reg_0_0625", help="regression-stage DSC preset")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if args.cmd != "roundtrip" and args.dst is None:
        ap.error(f"{args.cmd} needs an output file")
    dev = args.device
    si = load_image(args.si) if args.si else None
    if args.cmd == "decode":
        with open(args.src, "rb") as f:
            rec = _decode_file(f.read(), args, si)
        u8 = np.clip(rec * 255.0 + 0.5, 0, 255).astype(np.uint8)
        if args.dst.lower().endswith(".ppm"):
            with open(args.dst, "wb") as f:
                f.write(b"P6\n%d %d\n255\n" % (u8.shape[1], u8.shape[0]) + u8.tobytes())
        else:
            from PIL import Image

            Image.fromarray(u8).save(args.dst)
        return
    img = load_image(args.src)
    model = _load_model(args.model, args.ckpt, dev, args.n, args.m)
    reg_model = None
    if args.reg_ckpt:
        reg_model = _load_model(args.reg_model, args.reg_ckpt, dev)
        data = encode_composite(img, model, reg_model, device=dev)
    else:
        data = encode_image(img, model, device=dev, ar_backend=args.ar_backend)
    bpp = 8.0 * len(data) / (img.shape[0] * img.shape[1])
    if args.cmd == "encode":
        with open(args.dst, "wb") as f:
            f.write(data)
        print(f"{args.dst}: {len(data)} bytes, {bpp:.4f} bpp")
        return
    rec = _decode_file(data, args, si, reg_model=reg_model, model=model)
    mse = float(np.mean((rec - img) ** 2))
    print(json.dumps({"bytes": len(data), "bpp": round(bpp, 5),
                      "psnr": round(10.0 * np.log10(1.0 / max(mse, 1e-12)), 3)}))


if __name__ == "__main__":
    main()
