"""Weights of the JAX package, read and carried into the port, and back.

``msgpack_restore`` reads a flax msgpack file (``flax.serialization``, as
written by ``iclr_17_compression_tpu/train/checkpoint.py``) with Python and
numpy alone: maps, arrays, strings, binaries, integers, floats, nil, bools
and flax's ext types, 1 = ndarray packed as msgpack ``(shape, dtype name,
buffer)`` and 3 = numpy scalar packed the same way. Chunked arrays (flax
splits leaves above 2 GB) are joined back.

``msgpack_dumps`` writes the same format (``flax.serialization.to_bytes``
of a tree of float arrays gives the same bytes), with the standard library
and numpy alone.

``params_from_jax`` turns a JAX Ballé-17 parameter tree into the port's
``state_dict`` (reference PyTorch keys and layouts; the inverse of
``import_balle17`` in ``iclr_17_compression_tpu/train/torch_import.py``). It
checks every leaf's shape and dtype, and raises on a missing or extra key.
``params_to_jax`` is its inverse: a port state_dict as the JAX tree, in the
JAX model's key order.

``dsc_params_from_jax`` / ``dsc_params_to_jax`` do the same for a DSC model
of a given ``DSCConfig`` (the inverse of ``import_dsc``): the flax tree
``g_a/l1_rbs/conv1/weight`` (HWIO) is the port's ``g_a.1.conv1.weight``
(OIHW), ``…/l4_att/a_ru0/conv_in`` is ``….4.conv_a.0.conv.0``,
``…/l2_rbu/subpel_conv/conv`` is ``….2.subpel_conv.0``. ``load_dsc`` and
``load_weights`` read a bare params file (the archived
``results/ckpts/dsc_*_params.msgpack``), a JAX TrainState dict with
``params``, or the port's own train-state file (``train/checkpoint.py``'s
``save_train_state``: a ``torch.save`` zip whose ``model`` is the state_dict,
read with ``weights_only=True``).

The fusion presets' modules map as the JAX package names them: FIF's
``fif.conv8.convblk.0.weight`` is flax ``fif/conv5/weight`` (the reference
calls the fifth block ``conv8``), ``….convblk.2.bn.weight`` ``…/abn/bn/scale``;
``bot_mhsa.q_patches.0.weight`` is ``bot_mhsa/q_patches/weight``;
``pam.rb.body.2.weight`` is ``pam/rb/conv2/weight``; ``final_conv`` is a
stack. FIF's running statistics (``….bn.running_mean`` / ``running_var``)
are buffers in the port and flax's ``batch_stats`` collection
(``fif/conv1/abn/bn/mean`` / ``var``): ``dsc_batch_stats_{from,to}_jax``
carry them, and ``dsc_params_{from,to}_jax`` carry the parameters alone.

``hyperprior_params_{from,to}_jax`` and ``joint_params_{from,to}_jax`` do the
same for the scale hyperprior (the inverse of ``import_hyperprior``: flax
``g_a/conv1`` is the port's ``Encoder.conv1``, ``h_s/deconv1``
``priorDecoder.deconv1``, ``bit_estimator_z/f1_h`` ``bitEstimator_z.f1.h``)
and the joint-AR model (the flax names ``g_a/rbs0``, ``h_s/subpel1/conv``,
``entropy_parameters/conv2`` are the CompressAI indices ``g_a.0``,
``h_s.2.0``, ``entropy_parameters.4``, as ``import_joint`` maps them).
``load_hyperprior`` and ``load_joint`` read a JAX params file or TrainState
checkpoint, or the port's own train-state file.

Every port model, the auxiliary ones included, goes through
``model_params_{from,to}_jax(model, …)``: ``layout_of(model)`` names its JAX
layout, for each the inverse of its ``torch_import`` map (``import_fc``,
``import_latent_compressor``, ``import_analysis_small``,
``import_synthesis_small``, ``import_passr``, ``import_fif``,
``import_final_enhance``; ``NLBlock``'s 1×1 convs are flax's ``g``, ``theta``,
``phi``, ``concat_project`` and ``w_z``, HWIO). A linear layer's weight (out, in) is flax's
``kernel`` (in, out); where the reference flattens a latent in NCHW order and
the JAX module in NHWC order (``fc``, AnalysisSmall's ``fc1``,
SynthesisSmall's ``fc2``) its rows or columns go through ``_fc_perm``, as
``import_fc`` / ``import_analysis_small`` / ``import_synthesis_small`` take
them.

A reference PyTorch checkpoint (``.pth``, ``.pth.tar``, ``.pt``: a bare
state_dict, or one under ``model_state_dict``) holds the port's own keys, so
``load_torch_state_dict`` loads it as it is, under the reference's partial
load (reference model.py:26-27, ``torch_import.merge_partial``): a key the
model and the file share is loaded, a shape that differs raises, a key the
file lacks keeps the model's value. ``read_weights`` alone decides a file's
format: such a file by its suffix, as the JAX codec CLI does
(``_is_torch_ckpt``), the port's own train-state file (``.ckpt``, a
``torch.save`` zip too) and a flax msgpack by their contents; ``load_weights``
and the ``load_*`` entry points dispatch on what it says, and load the
train state and the JAX files strictly.
"""

import struct
import zipfile
from typing import Any, Callable, Dict, Mapping, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..models.attention import NLBlock, PatchMatchAttention
from ..models.balle17 import Analysis17, Balle17Compressor, Synthesis17
from ..models.cheng2020 import JointAutoregressive
from ..models.dsc import DSC_PRESETS, GREC_SPECS, DSCConfig, DSCStereoModel, final_conv_specs
from ..models.enhance import FIFEnhance, FinalEnhanceNet
from ..models.extra import AnalysisSmall, ImageCompressorFC, LatentCompressor, SynthesisSmall
from ..models.hyperprior import ScaleHyperprior
from ..models.passr import PASSRnet
from ..ops.conv import deconv_hwio_to_torch, hwio_to_oihw, oihw_to_hwio
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


def _pack_len(n: int, fix: int, fix_max: int, codes: tuple) -> bytes:
    """The header of a msgpack str/bin/array/map/ext of length ``n``:
    ``fix | n`` when ``fix`` is given and n <= fix_max, else the smallest of
    the 8/16/32-bit length forms in ``codes`` (None where a form is absent)."""
    if fix is not None and n <= fix_max:
        return bytes([fix | n])
    for code, fmt in zip(codes, ("B", "H", "I")):
        if code is not None and n < 1 << (8 * struct.calcsize(fmt)):
            return bytes([code]) + struct.pack(">" + fmt, n)
    raise ValueError(f"msgpack object of length {n} is too long")


def _pack_int(v: int) -> bytes:
    if 0 <= v < 128:
        return bytes([v])
    if -32 <= v < 0:
        return struct.pack(">b", v)
    forms = ((0xCC, "B"), (0xCD, "H"), (0xCE, "I"), (0xCF, "Q")) if v >= 0 else \
        ((0xD0, "b"), (0xD1, "h"), (0xD2, "i"), (0xD3, "q"))
    for code, fmt in forms:
        try:
            return bytes([code]) + struct.pack(">" + fmt, v)
        except struct.error:
            continue
    raise ValueError(f"integer {v} does not fit msgpack")


def _pack(obj, out: list) -> None:
    if obj is None:
        out.append(b"\xc0")
    elif isinstance(obj, bool):
        out.append(b"\xc3" if obj else b"\xc2")
    elif isinstance(obj, int):
        out.append(_pack_int(obj))
    elif isinstance(obj, float):
        out.append(b"\xcb" + struct.pack(">d", obj))
    elif isinstance(obj, str):
        b = obj.encode()
        out += [_pack_len(len(b), 0xA0, 31, (0xD9, 0xDA, 0xDB)), b]
    elif isinstance(obj, bytes):
        out += [_pack_len(len(obj), None, 0, (0xC4, 0xC5, 0xC6)), obj]
    elif isinstance(obj, (list, tuple)):
        out.append(_pack_len(len(obj), 0x90, 15, (None, 0xDC, 0xDD)))
        for v in obj:
            _pack(v, out)
    elif isinstance(obj, dict):
        # keys sorted, as flax writes them (a JAX pytree flattens a dict so)
        out.append(_pack_len(len(obj), 0x80, 15, (None, 0xDE, 0xDF)))
        for k, v in sorted(obj.items()):
            _pack(k, out)
            _pack(v, out)
    elif isinstance(obj, (np.ndarray, np.generic)):
        # flax's ext types: 1 = ndarray, 3 = numpy scalar, each packed as
        # msgpack (shape, dtype name, C-order buffer)
        arr = np.asarray(obj)
        payload = msgpack_dumps((arr.shape, arr.dtype.name, arr.tobytes("C")))
        code = 1 if isinstance(obj, np.ndarray) else 3
        n = len(payload)
        fixext = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}.get(n)
        head = bytes([fixext]) if fixext else _pack_len(n, None, 0, (0xC7, 0xC8, 0xC9))
        out += [head, struct.pack(">b", code), payload]
    else:
        raise TypeError(f"cannot pack {type(obj).__name__} as msgpack")


def msgpack_dumps(obj) -> bytes:
    """Encode nested dicts/lists of numpy arrays, strings, bytes and numbers
    as flax msgpack bytes (arrays under 2 GB: flax chunks larger ones)."""
    out = []
    _pack(obj, out)
    return b"".join(out)


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


def _leaf_to_port(path: str, v) -> Optional[tuple]:
    """One JAX leaf → (port state_dict key, tensor in the port's layout), or
    None for a path outside the Ballé-17 tree."""
    try:
        key = _port_key(path)
    except (KeyError, ValueError, IndexError):
        return None
    v = np.asarray(v)
    if path.endswith("weight") and v.ndim != 4:
        return None
    if path.endswith("weight") and "/conv" in path:
        v = hwio_to_oihw(v)
    elif path.endswith("weight"):
        v = deconv_hwio_to_torch(v)
    return key, torch.from_numpy(np.array(v, order="C"))


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
        key, t = _leaf_to_port(path, v)
        sd[key] = t
    return sd


def _jax_path(key: str) -> str:
    """Reference PyTorch state_dict key → JAX leaf path (``_port_key``'s
    inverse)."""
    top, *rest = key.split(".")
    if top == "bitEstimator":
        return f"bit_estimator/{rest[0]}_{rest[1]}"
    return {"Encoder": "encoder", "Decoder": "decoder"}[top] + "/" + "/".join(rest)


def params_to_jax(state_dict: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """A port ``Balle17Compressor`` state_dict → the JAX Ballé-17 param tree
    (nested dicts of float32 numpy arrays, JAX layouts), the inverse of
    ``params_from_jax``."""
    tree: Dict[str, Any] = {}
    for key, t in state_dict.items():
        v = t.detach().to("cpu", torch.float32).numpy()
        path = _jax_path(key)
        if path.endswith("weight") and "/conv" in path:
            v = oihw_to_hwio(v)
        elif path.endswith("weight"):
            v = np.flip(v, axis=(2, 3)).transpose(2, 3, 0, 1)  # deconv_hwio_to_torch⁻¹
        *parents, leaf = path.split("/")
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = np.array(v, order="C")  # ascontiguousarray would make a scalar 1-D
    return tree


def load_balle17(path: str, device: Optional[str] = None):
    """A ``Balle17Compressor`` in eval mode on ``device`` (default ``cuda``)
    with the weights of a JAX checkpoint or params file, of the port's
    train-state file or of a reference ``.pth``; N comes from its shapes."""
    dev = resolve_device(device)
    kind, sd = read_weights(path)
    if kind == "jax":
        sd = params_from_jax(read_checkpoint(path))
    model = Balle17Compressor(sd["Encoder.conv1.weight"].shape[0])
    if kind == "pth":
        load_torch_state_dict(model, sd)
    else:
        _load_strict(model, sd)
    return model.to(dev).eval()


# The torch name of each DSC stack → (its flax name, its specs).
def _dsc_stacks(cfg: DSCConfig) -> Dict[str, tuple]:
    return {"g_a": ("g_a", cfg.ga), "g_a_Y": ("g_a_y", cfg.ga), "g_s": ("g_s", cfg.gs),
            "g_a22": ("g_a22", cfg.ga22), "g_s22": ("g_s22", cfg.gs22),
            "g_z1hat_z2": ("g_z1hat_z2", cfg.gz),
            "g_z1hat_z2_freq2": ("g_z1hat_z2_freq2", cfg.gz2),
            "g_rec1_im2_new": ("g_rec1_im2_new", GREC_SPECS),
            "final_conv": ("final_conv", final_conv_specs(cfg))}


# FIF: the reference's block names → the JAX package's; the
# AdaptiveBatchNorm's leaves → flax's; the running statistics → the
# batch_stats leaves
_FIF_BLOCKS = {"conv1": "conv1", "conv2": "conv2", "conv3": "conv3", "conv4": "conv4",
               "conv8": "conv5"}
_FIF_LEAVES = {"0.weight": "weight", "0.bias": "bias", "2.a": "abn/a", "2.b": "abn/b",
               "2.bn.weight": "abn/bn/scale", "2.bn.bias": "abn/bn/bias",
               "2.bn.running_mean": "abn/bn/mean", "2.bn.running_var": "abn/bn/var"}
_STAT_LEAVES = ("running_mean", "running_var")


def _is_stat(key: str) -> bool:
    """A running-statistics buffer (flax ``batch_stats``), not a parameter."""
    return key.rsplit(".", 1)[-1] in _STAT_LEAVES


def _fusion_flax_path(top: str, rest: str) -> str:
    """A key below ``fif``, ``bot_mhsa`` or ``pam`` → its JAX leaf path."""
    if top == "fif":
        block, tail = rest.split(".convblk.")
        return f"fif/{_FIF_BLOCKS[block]}/{_FIF_LEAVES[tail]}"
    parts = rest.split(".")
    if top == "bot_mhsa":  # q_patches.0.weight: Sequential(conv, ReLU)
        return "/".join(["bot_mhsa"] + ([parts[0], parts[2]] if len(parts) == 3 else parts))
    if parts[0] == "rb":  # pam.rb.body.{0,2}.weight
        return f"pam/rb/conv{1 + int(parts[2]) // 2}/{parts[3]}"
    return "/".join(["pam"] + parts)


_UNIT_CONVS = {"0": "conv_in", "2": "conv_mid", "4": "conv_out"}


def stack_flax_path(specs, key: str) -> str:
    """A key of a stack's state_dict (``<i>.<module>…<leaf>``, the stack built
    from ``specs``) → its JAX leaf path inside the ``_Stack`` params."""
    idx, *mods, leaf = key.split(".")
    kind = specs[int(idx)][0]
    if kind in ("conv3", "conv7"):
        inner = []
    elif kind == "subpel":  # Sequential(conv, PixelShuffle): "0.weight"
        inner = ["conv"]
    elif kind in ("rb", "rbs"):
        inner = mods
    elif kind == "rbu":
        inner = [mods[0], "conv"] if mods[0] in ("subpel_conv", "upsample") else mods
    elif mods == ["conv_b", "3"]:  # att / att7: the gate
        inner = ["b_conv"]
    else:  # conv_a.<u>.conv.<j> / conv_b.<u>.conv.<j>
        inner = [f"{mods[0][-1]}_ru{mods[1]}", _UNIT_CONVS[mods[3]]]
    return "/".join([f"l{idx}_{kind}"] + inner + [leaf])


def _dsc_flax_path(key: str, cfg: DSCConfig) -> str:
    """A port DSC state_dict key → its JAX leaf path (in ``params``, or in
    ``batch_stats`` for a running statistic)."""
    top, rest = key.split(".", 1)
    if top in ("fif", "bot_mhsa", "pam"):
        return _fusion_flax_path(top, rest)
    flax_top, specs = _dsc_stacks(cfg)[top]
    return f"{flax_top}/{stack_flax_path(specs, rest)}"


def dsc_params_from_jax(tree: Dict[str, Any], cfg: DSCConfig) -> Dict[str, torch.Tensor]:
    """JAX ``DSCStereoModel`` params of ``cfg`` (nested dicts of arrays, bare
    or under "params") → the port's ``DSCStereoModel`` state_dict. Every leaf
    is checked: shape, float32, none missing, none extra."""
    return model_params_from_jax(_meta(DSCStereoModel, cfg), tree)


def _linear_perms(path: str, perms) -> tuple:
    """(in, out) flatten permutations of the dense layer owning ``path``."""
    return (perms or {}).get(path.rsplit("/", 1)[0], (None, None))


def _leaf_to_jax(v: np.ndarray, path: str, is_deconv=None, perms=None) -> np.ndarray:
    """One port leaf in the JAX layout at ``path``: 4-D weights to HWIO (or,
    where ``is_deconv(path)``, the JAX pre-flipped deconv layout); a dense
    weight (out, in) to flax's kernel (in, out), its rows and columns taken
    through the layer's flatten permutations (``perms``: layer path → (in,
    out), ``import_fc``'s ``_import_linear``) and its bias through the out
    one."""
    if v.ndim == 4 and is_deconv is not None and is_deconv(path):
        return np.flip(v, axis=(2, 3)).transpose(2, 3, 0, 1)  # deconv_hwio_to_torch⁻¹
    if v.ndim == 4:
        return oihw_to_hwio(v)
    in_p, out_p = _linear_perms(path, perms)
    if path.endswith("/kernel"):
        v = v if out_p is None else v[out_p]
        return (v if in_p is None else v[:, in_p]).T
    if path.endswith("/bias") and out_p is not None:
        return v[out_p]
    return v


def _leaf_from_jax(v: np.ndarray, path: str, is_deconv=None, perms=None) -> np.ndarray:
    """``_leaf_to_jax``'s inverse."""
    if v.ndim == 4:
        return deconv_hwio_to_torch(v) if is_deconv is not None and is_deconv(path) \
            else hwio_to_oihw(v)
    in_p, out_p = _linear_perms(path, perms)
    if path.endswith("/kernel"):
        v = v.T
        v = v if in_p is None else v[:, np.argsort(in_p)]
        return v if out_p is None else v[np.argsort(out_p)]
    if path.endswith("/bias") and out_p is not None:
        return v[np.argsort(out_p)]
    return v


def _tree_from(state_dict: Dict[str, torch.Tensor], path_of, is_deconv=None,
               perms=None) -> Dict[str, Any]:
    """A port state_dict → a JAX params tree: ``path_of(key)`` names each
    leaf, ``_leaf_to_jax`` lays it out."""
    tree: Dict[str, Any] = {}
    for key, t in state_dict.items():
        path = path_of(key)
        v = _leaf_to_jax(t.detach().to("cpu", torch.float32).numpy(), path, is_deconv, perms)
        *parents, leaf = path.split("/")
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = np.array(v, order="C")  # ascontiguousarray would make a scalar 1-D
    return tree


def _state_from(tree: Dict[str, Any], template: Dict[str, torch.Tensor], path_of, what: str,
                is_deconv=None, perms=None) -> Dict[str, torch.Tensor]:
    """A JAX params tree (bare or under "params") → a port state_dict of
    ``template``'s keys and shapes: ``_tree_from``'s inverse. Every leaf is
    checked: shape, float32, none missing, none extra."""
    if set(tree) == {"params"}:
        tree = tree["params"]
    flat = _flatten(tree)
    paths = {key: path_of(key) for key in template}
    missing = sorted(set(paths.values()) - set(flat))
    extra = sorted(set(flat) - set(paths.values()))
    if missing or extra:
        raise KeyError(f"{what} params: missing {missing}, unexpected {extra}")
    sd = {}
    for key, path in paths.items():
        v = np.asarray(flat[path])
        if v.dtype != np.float32:
            raise TypeError(f"{path}: dtype {v.dtype}, expected float32")
        if v.ndim != template[key].dim():
            raise ValueError(f"{path}: shape {v.shape}, expected {tuple(template[key].shape)}")
        v = _leaf_from_jax(v, path, is_deconv, perms)
        if v.shape != tuple(template[key].shape):
            raise ValueError(f"{path}: shape {v.shape}, expected {tuple(template[key].shape)}")
        sd[key] = torch.from_numpy(np.array(v, order="C"))
    return sd


def dsc_params_to_jax(state_dict: Dict[str, torch.Tensor], cfg: DSCConfig) -> Dict[str, Any]:
    """A port ``DSCStereoModel`` state_dict → the JAX params tree (nested
    dicts of float32 numpy arrays, HWIO conv weights), the inverse of
    ``dsc_params_from_jax``; running statistics are left out."""
    return _tree_from({k: v for k, v in state_dict.items() if not _is_stat(k)},
                      lambda key: _dsc_flax_path(key, cfg))


def dsc_batch_stats_from_jax(tree: Dict[str, Any], cfg: DSCConfig) -> Dict[str, torch.Tensor]:
    """A JAX ``batch_stats`` tree of ``cfg`` (bare or under "batch_stats")
    → the port's running-statistics buffers, every leaf checked (FIF's, for
    ``fif_0031bpp``; empty for a preset without BatchNorm)."""
    if set(tree) == {"batch_stats"}:
        tree = tree["batch_stats"]
    return _state_from(tree, _template(_meta(DSCStereoModel, cfg), stats=True),
                       lambda key: _dsc_flax_path(key, cfg), f"DSC {cfg.name} batch_stats")


def dsc_batch_stats_to_jax(state_dict: Dict[str, torch.Tensor], cfg: DSCConfig
                           ) -> Dict[str, Any]:
    """The running statistics of a port DSC state_dict → the JAX
    ``batch_stats`` tree, the inverse of ``dsc_batch_stats_from_jax``."""
    return _tree_from({k: v for k, v in state_dict.items() if _is_stat(k)},
                      lambda key: _dsc_flax_path(key, cfg))


_HYPER_TOPS = {"Encoder": "g_a", "Decoder": "g_s", "priorEncoder": "h_a", "priorDecoder": "h_s"}


def _bit_estimator_path(flax_top: str, rest: str) -> str:
    f, leaf = rest.split(".")
    return f"{flax_top}/{f}_{leaf}"


def _hyperprior_flax_path(key: str) -> str:
    """A port ``ScaleHyperprior`` state_dict key → its JAX leaf path."""
    top, rest = key.split(".", 1)
    if top == "bitEstimator_z":
        return _bit_estimator_path("bit_estimator_z", rest)
    return f"{_HYPER_TOPS[top]}/" + rest.replace(".", "/")


def _is_deconv(path: str) -> bool:
    return path.split("/")[-2].startswith("deconv")


def hyperprior_params_from_jax(tree: Dict[str, Any], n: int, m: int) -> Dict[str, torch.Tensor]:
    """JAX ``ScaleHyperprior`` params of widths (n, m) → the port's
    ``ScaleHyperprior`` state_dict (either quantizer: they share weights)."""
    return model_params_from_jax(_meta(ScaleHyperprior, n, m), tree)


def hyperprior_params_to_jax(state_dict: Dict[str, torch.Tensor], n: int, m: int
                             ) -> Dict[str, Any]:
    """A port ``ScaleHyperprior`` state_dict → the JAX params tree, the
    inverse of ``hyperprior_params_from_jax``."""
    return model_params_to_jax(_meta(ScaleHyperprior, n, m), state_dict)


# The flax name of each indexed block of the joint-AR stacks (the
# CompressAI index → ``models/cheng2020.py``'s submodule name).
_JOINT_NAMES = {
    "g_a": ("rbs0", "rb1", "rbs2", "rb3", "rbs4", "rb5", "conv6"),
    "h_a": {0: "conv0", 2: "conv1", 4: "conv2", 6: "conv3", 8: "conv4"},
    "h_s": {0: "conv0", 2: "subpel1", 4: "conv2", 6: "subpel3", 8: "conv4"},
    "g_s": ("rb0", "rbu1", "rb2", "rbu3", "rb4", "rbu5", "rb6", "subpel7"),
    "entropy_parameters": {0: "conv0", 2: "conv1", 4: "conv2"},
}


def _joint_flax_path(key: str) -> str:
    """A port ``JointAutoregressive`` state_dict key → its JAX leaf path."""
    top, rest = key.split(".", 1)
    if top == "bitEstimator_z":
        return _bit_estimator_path("bit_estimator_z", rest)
    if top == "context_prediction":
        return f"context_prediction/{rest}"
    idx, *mods, leaf = rest.split(".")
    name = _JOINT_NAMES[top][int(idx)]
    if name.startswith("subpel"):  # Sequential(conv, PixelShuffle): "0.weight"
        inner = ["conv"]
    elif name.startswith("rbu") and mods[0] in ("subpel_conv", "upsample"):
        inner = [mods[0], "conv"]
    else:
        inner = mods
    return "/".join([top, name] + inner + [leaf])


def joint_params_from_jax(tree: Dict[str, Any], n: int) -> Dict[str, torch.Tensor]:
    """JAX ``JointAutoregressive`` params of width n → the port's
    ``JointAutoregressive`` state_dict."""
    return model_params_from_jax(_meta(JointAutoregressive, n), tree)


def joint_params_to_jax(state_dict: Dict[str, torch.Tensor], n: int) -> Dict[str, Any]:
    """A port ``JointAutoregressive`` state_dict → the JAX params tree, the
    inverse of ``joint_params_from_jax``."""
    return model_params_to_jax(_meta(JointAutoregressive, n), state_dict)


def _fc_perm(h: int, w: int, c: int) -> np.ndarray:
    """Position j of the NHWC-flat (h, w, c) latent holds element perm[j] of
    the NCHW-flat one (``torch_import._fc_perm``)."""
    return np.arange(c * h * w).reshape(c, h, w).transpose(1, 2, 0).ravel()


def _dense_path(key: str) -> str:
    """``fc1.0.weight`` / ``fc2.weight`` (a linear layer, bare or first in a
    Sequential) → ``fc1/kernel`` / ``fc2/kernel``; other leaves as named."""
    parts = key.split(".")
    leaf = "kernel" if parts[-1] == "weight" else parts[-1]
    return f"{parts[0]}/{leaf}"


def _small_flax_path(key: str) -> str:
    """AnalysisSmall / SynthesisSmall: ``conv1.weight`` → ``conv1/weight``,
    ``igdn2.gamma`` → ``igdn2/gamma``, ``fc1.0.weight`` → ``fc1/kernel``."""
    name, leaf = key.split(".")[0], key.rsplit(".", 1)[1]
    return _dense_path(key) if name.startswith("fc") else f"{name}/{leaf}"


_LC_NAMES = {"conv_down_zx": {"0": "down1", "2": "down2", "4": "down3", "6": "down4"},
             "fc_combine_zx_zy": {str(i): f"comb{i + 1}" for i in range(5)}}


def _latent_compressor_flax_path(key: str) -> str:
    top, idx, leaf = key.split(".")
    return f"{_LC_NAMES[top][idx]}/{leaf}"


def _resb_conv(sub: str) -> str:
    """A ResB's ``body.{0,2}`` → ``conv{1,2}``."""
    return f"conv{1 + int(sub.split('.')[1]) // 2}"


_PASSR_FEATURES = {"2": "resb1", "3": "aspp1", "4": "resb2", "5": "aspp2", "6": "resb3"}
_PASSR_UP = {"4": "up_conv1", "6": "up_conv2", "7": "up_conv3"}


def _passr_flax_path(key: str) -> str:
    """A ``PASSRnet`` key → its JAX leaf path (``import_passr``'s map)."""
    top, rest = key.split(".", 1)
    if top == "pam":
        return _fusion_flax_path("pam", rest)
    idx, _, sub = rest.partition(".")
    leaf = key.rsplit(".", 1)[1]
    if top == "upscale":
        name = _PASSR_UP.get(idx)
        return f"{name}/{leaf}" if name else f"up_resb{idx}/{_resb_conv(sub)}/{leaf}"
    if idx == "0":
        return f"{top}_conv0/{leaf}"
    name = _PASSR_FEATURES[idx]
    inner = _resb_conv(sub) if name.startswith("resb") else sub.split(".")[0]
    return f"{top}_{name}/{inner}/{leaf}"


def _fif_enhance_flax_path(key: str) -> str:
    if key.startswith("out_conv."):
        return key.replace(".", "/")
    block, tail = key.split(".convblk.")
    return f"{_FIF_BLOCKS[block]}/{_FIF_LEAVES[tail]}"


_FINAL_BLOCKS = {"0": "final_rb0", "1": "final_rb1", "2": "final_att", "3": "final_rb2",
                 "4": "final_rb3"}


def _attention_block_path(rest: str) -> str:
    """Inside an AttentionBlock: ``conv_a.<u>.conv.<j>.<leaf>`` →
    ``a_ru<u>/conv_{in,mid,out}/<leaf>``, ``conv_b.3.<leaf>`` →
    ``b_conv/<leaf>``."""
    parts = rest.split(".")
    if parts[:2] == ["conv_b", "3"]:
        return f"b_conv/{parts[2]}"
    return f"{parts[0][-1]}_ru{parts[1]}/{_UNIT_CONVS[parts[3]]}/{parts[4]}"


def _final_enhance_flax_path(key: str) -> str:
    """A ``FinalEnhanceNet`` key → its JAX leaf path (``import_final_enhance``'s
    map)."""
    top, idx, rest = key.split(".", 2)
    if top == "conv_b" and idx == "3":
        return f"conv_b_conv/{rest}"
    if top in ("conv_a", "conv_b"):
        return f"{top}_rb{idx}/{rest.replace('.', '/')}"
    name = _FINAL_BLOCKS[idx]
    if name == "final_att":
        return f"final_att/{_attention_block_path(rest)}"
    return f"{name}/{rest.replace('.', '/')}"


def _patch_attention_flax_path(key: str) -> str:
    """``q_patches.0.weight`` → ``q_patches/weight``; ``scale_att`` as is."""
    parts = key.split(".")
    return "/".join([parts[0], parts[2]] if len(parts) == 3 else parts)


class Layout(NamedTuple):
    """How a port model's state_dict maps onto its JAX params tree."""

    path_of: Callable[[str], str]
    is_deconv: Optional[Callable[[str], bool]] = None
    perms: Optional[Dict[str, tuple]] = None


def layout_of(model: torch.nn.Module) -> Layout:
    """The JAX layout of a port model of any kind."""
    if isinstance(model, DSCStereoModel):
        return Layout(lambda key: _dsc_flax_path(key, model.config))
    if isinstance(model, ScaleHyperprior):
        return Layout(_hyperprior_flax_path, _is_deconv)
    if isinstance(model, JointAutoregressive):
        return Layout(_joint_flax_path)
    if isinstance(model, Balle17Compressor):
        return Layout(_jax_path, lambda path: "/conv" not in path)
    if isinstance(model, (Analysis17, Synthesis17)):  # a transform alone: conv1/weight, …
        return Layout(lambda key: key.replace(".", "/"), _is_deconv)
    if isinstance(model, ImageCompressorFC):
        h, w, c = model.latent_hw + (model.out_channel_n,)
        perm = _fc_perm(h, w, c)
        return Layout(lambda key: _dense_path(key) if key.startswith("fc.") else _jax_path(key),
                      lambda path: path.startswith("decoder/"), {"fc": (perm, perm)})
    if isinstance(model, LatentCompressor):
        return Layout(_latent_compressor_flax_path)
    if isinstance(model, AnalysisSmall):
        m, g = model.conv4.out_channels, model.grid
        return Layout(_small_flax_path, perms={"fc1": (_fc_perm(g, g, m), None)})
    if isinstance(model, SynthesisSmall):
        return Layout(_small_flax_path, _is_deconv, {"fc2": (None, _fc_perm(16, 16, 16))})
    if isinstance(model, PASSRnet):
        return Layout(_passr_flax_path)
    if isinstance(model, FIFEnhance):
        return Layout(_fif_enhance_flax_path)
    if isinstance(model, FinalEnhanceNet):
        return Layout(_final_enhance_flax_path)
    if isinstance(model, PatchMatchAttention):
        return Layout(_patch_attention_flax_path)
    if isinstance(model, NLBlock):
        return Layout(lambda key: key.replace(".", "/"))
    raise TypeError(f"no JAX layout for {type(model).__name__}")


def _params_only(state_dict: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: v for k, v in state_dict.items() if not _is_stat(k)}


def _template(model: torch.nn.Module, stats: bool = False) -> Dict[str, torch.Tensor]:
    return {k: v for k, v in model.state_dict().items() if _is_stat(k) == stats}


def model_params_to_jax(model: torch.nn.Module,
                        state_dict: Optional[Dict[str, torch.Tensor]] = None) -> Dict[str, Any]:
    """``state_dict`` (default the model's own; every parameter of the
    model's kind and widths, checked) as the JAX params tree of ``model``'s
    kind; running statistics are left out."""
    sd = _params_only(model.state_dict() if state_dict is None else state_dict)
    template = _template(model)
    if set(sd) != set(template) or any(sd[k].shape != template[k].shape for k in sd):
        raise KeyError(f"not a {type(model).__name__} state_dict of these widths")
    return _tree_from(sd, *layout_of(model))


def model_params_from_jax(model: torch.nn.Module, tree: Dict[str, Any]
                          ) -> Dict[str, torch.Tensor]:
    """The JAX params tree of ``model``'s kind (bare, or under "params" of a
    variables dict or TrainState) as its state_dict's parameters, every leaf
    checked."""
    if isinstance(tree.get("params"), dict):
        tree = tree["params"]
    lay = layout_of(model)
    return _state_from(tree, _template(model), lay.path_of, type(model).__name__,
                       lay.is_deconv, lay.perms)


def _meta(cls, *args, **kw) -> torch.nn.Module:
    """A model on the meta device: a template of keys and shapes."""
    with torch.device("meta"):
        return cls(*args, **kw)


def _params_tree(path: str, top: str) -> Dict[str, Any]:
    """The params subtree of a JAX params file, variables dict or TrainState
    checkpoint: the first level that holds ``top``."""
    tree = read_checkpoint(path)
    while top not in tree and isinstance(tree.get("params"), dict):
        tree = tree["params"]
    if top not in tree:
        raise KeyError(f"{path}: no {top!r} in the checkpoint's params")
    return tree


def _load_strict(model: torch.nn.Module, sd: Dict[str, torch.Tensor]) -> None:
    own = model.state_dict()
    model.load_state_dict({k: v.to(own[k].device) if k in own else v for k, v in sd.items()},
                          strict=True)


def load_hyperprior(path: str, quant: str = "round", device: Optional[str] = None
                    ) -> ScaleHyperprior:
    """A ``ScaleHyperprior`` with quantizer ``quant`` in eval mode on
    ``device`` (default ``cuda``), with the weights of a JAX checkpoint or
    params file, of the port's train-state file or of a reference ``.pth``;
    N and M come from its shapes."""
    dev = resolve_device(device)
    read = read_weights(path)
    if read[1] is None:
        g_a = _params_tree(path, "g_a")["g_a"]
        n, m = (int(np.shape(g_a[c]["weight"])[-1]) for c in ("conv1", "conv4"))
    else:
        n, m = (int(read[1][f"Encoder.{c}.weight"].shape[0]) for c in ("conv1", "conv4"))
    return load_weights(ScaleHyperprior(n, m, quant=quant), path, read).to(dev).eval()


def load_joint(path: str, device: Optional[str] = None) -> JointAutoregressive:
    """A ``JointAutoregressive`` in eval mode on ``device`` (default
    ``cuda``), with the weights of a JAX checkpoint or params file, of the
    port's train-state file or of a reference ``.pth``; N comes from its
    shapes."""
    dev = resolve_device(device)
    read = read_weights(path)
    if read[1] is None:
        n = int(np.shape(_params_tree(path, "g_a")["g_a"]["rbs0"]["conv1"]["weight"])[-1])
    else:
        n = int(read[1]["g_a.0.conv1.weight"].shape[0])
    return load_weights(JointAutoregressive(n), path, read).to(dev).eval()


TORCH_SUFFIXES = (".pth", ".pth.tar", ".pt")


def _read_pth(path: str) -> Dict[str, torch.Tensor]:
    """The state_dict of a reference ``.pth``, on the CPU: the file's dict,
    or its ``model_state_dict`` (the reference's rich checkpoint,
    train_2StepsNet.py:204-220)."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd, Mapping) and "model_state_dict" in sd:
        sd = sd["model_state_dict"]
    return dict(sd)


def read_weights(path: str) -> Tuple[str, Optional[Dict[str, torch.Tensor]]]:
    """(kind, state_dict on the CPU) of a weights file, the one place its
    format is decided: ``"pth"`` for a reference PyTorch checkpoint, by its
    suffix as the JAX codec CLI's ``_is_torch_ckpt`` decides; ``"port"`` for
    the port's own train-state file (a ``torch.save`` zip too), its
    ``model``; ``"jax"`` and None for a flax msgpack, whose state_dict
    depends on the model it is read for."""
    if str(path).endswith(TORCH_SUFFIXES):
        return "pth", _read_pth(path)
    if zipfile.is_zipfile(path):
        return "port", torch.load(path, map_location="cpu", weights_only=True)["model"]
    return "jax", None


def load_torch_state_dict(model: torch.nn.Module, path_or_sd) -> torch.nn.Module:
    """Load a reference state_dict (a ``.pth`` path or the dict) into
    ``model`` under the reference's partial load: every key the two share
    is loaded, a shape that differs raises ``ValueError``, a key the file
    lacks keeps the model's value, a key the model lacks is left out."""
    sd = path_or_sd if isinstance(path_or_sd, Mapping) else _read_pth(path_or_sd)
    own = model.state_dict()
    shared = {}
    for k, v in sd.items():
        if k not in own:
            continue
        if tuple(v.shape) != tuple(own[k].shape):
            raise ValueError(f"shape mismatch at {k}: {tuple(own[k].shape)} vs {tuple(v.shape)}")
        shared[k] = v.to(own[k].device, own[k].dtype)
    model.load_state_dict(shared, strict=False)
    return model


def _dsc_state_from_jax(model: DSCStereoModel, path: str) -> Dict[str, torch.Tensor]:
    """The state_dict of ``model`` from a JAX params file, variables dict or
    TrainState checkpoint. A FIF preset needs the file's ``batch_stats`` too:
    a file without them raises, as the JAX model does on it."""
    tree = read_checkpoint(path)
    stats = tree.get("batch_stats")
    if model.config.fusion_pre == "fif" and not isinstance(stats, dict):
        raise ValueError(
            f"{path}: a {model.config.fusion_pre!r} preset needs the file's batch_stats "
            "(FIF's running statistics); this file holds only params, as the JAX "
            "trainer writes them, and the JAX model cannot run on it (ROADMAP Queue 3)")
    if "params" in tree and "g_a" not in tree:
        tree = tree["params"]
    sd = dsc_params_from_jax(tree, model.config)
    if isinstance(stats, dict):
        sd.update(dsc_batch_stats_from_jax(stats, model.config))
    return sd


def load_weights(model: torch.nn.Module, path: str, read=None) -> torch.nn.Module:
    """Load every weight of a port model of any kind (``layout_of``) from a
    JAX params file, variables dict or TrainState checkpoint of its kind, or
    from the port's train-state file (strict: no key missing or extra), or
    from a reference ``.pth`` (``load_torch_state_dict``). ``read``: what
    ``read_weights`` gave for ``path``, where the caller has read it."""
    kind, sd = read or read_weights(path)
    if kind == "pth":
        return load_torch_state_dict(model, sd)
    if kind == "jax":
        sd = (_dsc_state_from_jax(model, path) if isinstance(model, DSCStereoModel)
              else model_params_from_jax(model, read_checkpoint(path)))
    _load_strict(model, sd)
    return model


def load_dsc(path: str, preset: str, device: Optional[str] = None) -> DSCStereoModel:
    """A ``DSCStereoModel`` of the ``DSC_PRESETS`` entry ``preset`` in eval
    mode on ``device`` (default ``cuda``), with the weights of a JAX params
    file or TrainState checkpoint, of the port's train-state file, or of a
    reference ``.pth``."""
    dev = resolve_device(device)
    return load_weights(DSCStereoModel(DSC_PRESETS[preset]), path).to(dev).eval()
