"""The port's weight bridge and import hygiene.

- The port's own flax-msgpack reader equals ``flax.serialization`` leaf by
  leaf, exactly, on the archived lam2048 checkpoint and on every msgpack type
  flax writes.
- JAX params → port state_dict → back through the JAX package's own
  ``import_balle17`` gives every leaf exactly; bad trees raise.
- The port imports nothing of JAX, flax, msgpack, PIL (outside the codec
  CLI's ``main``, the dataset reader's ``_load`` for files that are not PPM
  or 8-bit PNG, and the eval tools' ``jpeg_anchor_point`` and
  ``_image_size``, for the JPEG anchor and non-PNG sizes) or the JAX
  package, and its entry points raise on a machine without CUDA unless
  asked for the CPU.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
from flax import serialization

from iclr_17_compression_tpu.train.torch_import import import_balle17
from iclr_17_compression_tpu_torch.models.balle17 import Balle17Compressor
from iclr_17_compression_tpu_torch.train.weights import (
    msgpack_restore,
    params_from_jax,
    read_checkpoint,
)

ROOT = Path(__file__).resolve().parents[1]
CKPT = ROOT / "results" / "ckpts" / "lam2048_iter_19000.ckpt"
PORT = ROOT / "iclr_17_compression_tpu_torch"
BLOCKED = ("jax", "jaxlib", "flax", "msgpack", "PIL", "iclr_17_compression_tpu")
# the functions that may import PIL, inside themselves
PIL_USERS = ("main", "_load", "jpeg_anchor_point", "_image_size")


def _flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _assert_trees_equal(a, b):
    fa, fb = _flatten(a), _flatten(b)
    assert fa.keys() == fb.keys()
    for k in fa:
        va, vb = np.asarray(fa[k]), np.asarray(fb[k])
        assert va.dtype == vb.dtype and va.shape == vb.shape, k
        np.testing.assert_array_equal(va, vb, err_msg=k)


def test_msgpack_reader_matches_flax_on_checkpoint():
    data = CKPT.read_bytes()
    ours = msgpack_restore(data)
    _assert_trees_equal(ours, serialization.msgpack_restore(data))
    assert len(_flatten(ours)) == 30


def test_msgpack_reader_covers_flax_types():
    tree = {
        "arr": {"f32": np.arange(6, dtype=np.float32).reshape(2, 3),
                "i64": np.array([-(2 ** 40), 3], np.int64),
                "u8": np.arange(300, dtype=np.uint8)[:255],
                "big": np.ones((70_000,), np.float32),
                "empty": np.zeros((0, 4), np.float32)},
        "scalar": np.float32(1.5), "i": 7, "neg": -100_000, "u": 2 ** 40, "f": 2.5,
        "s": "x" * 40, "b": True, "none": None, "lst": [1, -2, 300],
        "bytes": b"\x00\x01" * 200, "many": {f"k{i}": i for i in range(20)},
    }
    data = serialization.msgpack_serialize(tree)
    ours = msgpack_restore(data)
    ref = serialization.msgpack_restore(data)
    _assert_trees_equal(ours["arr"], ref["arr"])
    for k in tree:
        if k != "arr":
            assert ours[k] == ref[k] and type(ours[k]) is type(ref[k]), k
    with pytest.raises(ValueError):
        msgpack_restore(data + b"\x00")


def test_jax_params_to_port_and_back_exact():
    tree = read_checkpoint(str(CKPT))
    sd = params_from_jax({"params": tree})
    model = Balle17Compressor(128)
    model.load_state_dict(sd, strict=True)
    assert set(model.state_dict()) == set(sd)
    back = import_balle17({k: v.numpy() for k, v in model.state_dict().items()})
    _assert_trees_equal(back, tree)


def test_params_from_jax_rejects_bad_trees():
    tree = read_checkpoint(str(CKPT))
    missing = {**tree, "encoder": {k: v for k, v in tree["encoder"].items() if k != "gdn2"}}
    with pytest.raises(KeyError, match="gdn2"):
        params_from_jax(missing)
    with pytest.raises(KeyError, match="unexpected"):
        params_from_jax({**tree, "extra": {"w": np.zeros(3, np.float32)}})
    bad_dtype = {**tree, "decoder": {**tree["decoder"], "deconv3": {
        "weight": tree["decoder"]["deconv3"]["weight"].astype(np.float64),
        "bias": tree["decoder"]["deconv3"]["bias"]}}}
    with pytest.raises(TypeError):
        params_from_jax(bad_dtype)
    bad_shape = {**tree, "bit_estimator": {**tree["bit_estimator"],
                                           "f2_a": np.zeros(64, np.float32)}}
    with pytest.raises(ValueError):
        params_from_jax(bad_shape)


def _imports(path: Path):
    """(top-level package, enclosing function name or None) per import."""
    found = []

    class V(ast.NodeVisitor):
        def __init__(self):
            self.fn = []

        def visit_FunctionDef(self, node):
            self.fn.append(node.name)
            self.generic_visit(node)
            self.fn.pop()

        def visit_Import(self, node):
            for a in node.names:
                found.append((a.name.split(".")[0], self.fn[-1] if self.fn else None))

        def visit_ImportFrom(self, node):
            if node.level == 0:
                found.append((node.module.split(".")[0], self.fn[-1] if self.fn else None))

    V().visit(ast.parse(path.read_text()))
    return found


def test_port_sources_import_no_jax():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 15
    for f in files:
        for top, fn in _imports(f):
            if top == "PIL":
                assert fn in PIL_USERS, \
                    f"{f}: PIL imported outside the functions that need it ({fn})"
            else:
                assert top not in BLOCKED, f"{f} imports {top}"


def test_import_hygiene_and_cpu_entry_points_in_subprocess():
    code = f"""
import sys
for name in {BLOCKED!r}:
    sys.modules[name] = None
import numpy as np, torch
import iclr_17_compression_tpu_torch
from iclr_17_compression_tpu_torch.coding import api, codec_cli
from iclr_17_compression_tpu_torch.models import Balle17Compressor
from iclr_17_compression_tpu_torch.nn import layers
from iclr_17_compression_tpu_torch.ops import conv, entropy, gdn, math, metrics, quant
from iclr_17_compression_tpu_torch.ops.kernels import (
    _build, conv_gdn_kernel, gdn_kernel, quant_pack_kernel)
from iclr_17_compression_tpu_torch.train import weights
from iclr_17_compression_tpu_torch.train import checkpoint, cli, config, observability, state
from iclr_17_compression_tpu_torch.data import datasets
from iclr_17_compression_tpu_torch.eval import enhance, kodak, passr, reg_stage, stereo
from iclr_17_compression_tpu_torch.eval import ablation, metric_cli, mix, rd_plot, similarity
from iclr_17_compression_tpu_torch.utils import analysis, dataset_tools, svd
from iclr_17_compression_tpu_torch.models import NLBlock
from iclr_17_compression_tpu_torch.models import dsc, extra
from iclr_17_compression_tpu_torch.models import passr as passr_model
from iclr_17_compression_tpu_torch.nn import blocks
from iclr_17_compression_tpu_torch.train import losses, trainers
from iclr_17_compression_tpu_torch.utils import resolve_device
import chip_smoke
if torch.cuda.is_available():
    print("HAS_CUDA")
    raise SystemExit(0)
model = weights.load_balle17({str(CKPT)!r}, device="cpu")
img = np.full((16, 16, 3), 0.5, np.float32)
for call in (lambda: resolve_device(), lambda: weights.load_balle17({str(CKPT)!r}),
             lambda: codec_cli.encode_image(img, model),
             lambda: trainers.train_decoder_only(config.TrainConfig(), "x"),
             lambda: rd_plot.jpeg_anchor_curve([img]),
             lambda: metric_cli.main(["-o", "a.png", "-c", "b.png"])):
    try:
        call()
    except RuntimeError as e:
        assert "CUDA" in str(e)
    else:
        raise AssertionError("an entry point ran without CUDA and without device='cpu'")
data = codec_cli.encode_image(img, model, device="cpu")
assert codec_cli.decode_image(data, model, device="cpu").shape == img.shape
print("OK")
"""
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=300,
                          env={**os.environ, "PYTHONPATH": str(ROOT)})
    assert proc.returncode == 0, proc.stderr
    if "HAS_CUDA" in proc.stdout:
        pytest.skip("a CUDA device is present: the no-CUDA entry-point check does not apply")
    assert proc.stdout.strip().endswith("OK")
