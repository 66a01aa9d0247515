"""Checkpoint save/restore.

Counterpart of ``iclr_17_compression_tpu/train/checkpoint.py``:

- ``save_params`` / ``load_params``: bare parameter snapshots
  ``iter_<step>.ckpt`` in the JAX package's layout, a flax msgpack of the
  JAX param tree of a port model of any kind: Ballé-17, hyperprior,
  joint-AR, DSC or an auxiliary model (``train/weights.py``'s
  ``layout_of``). A model trained by the port loads in the JAX
  package and through the port's ``load_balle17`` / ``load_hyperprior`` /
  ``load_joint`` (and so the codec CLI); a JAX Ballé-17 checkpoint loads in
  the port.
- ``load_params_partial``: the leaves of a JAX-layout file (the tree of
  the model's kind, bare or a TrainState's ``params``) or of the port's
  train-state file whose key and shape match the model's.
- ``save_train_state`` / ``load_train_state``: the port's own full state, a
  ``torch.save`` of the model's and the optimizer's state dicts and the
  step, with the JAX package's JSON sidecar (epoch, loss, step and extras
  such as ``batch_in_epoch``). Read back with ``weights_only=True``.
  ``snapshot_train_state`` copies a state to be saved later (JAX keeps a
  reference to its immutable arrays; a torch model trains on in place).
- ``step_from_filename``, ``latest_checkpoint``, ``resolve_resume``.

Files are written to a temporary name and renamed, so a reader never sees
a truncated file.
"""

import copy
import json
import os
import re
from typing import Any, Dict, Optional, Tuple, Union

import numpy as np
import torch

from ..models.balle17 import Balle17Compressor
from .state import TrainState
from .weights import (
    _flatten,
    _leaf_from_jax,
    layout_of,
    model_params_to_jax,
    msgpack_dumps,
    params_from_jax,
    params_to_jax,
    read_checkpoint,
    read_weights,
)


def _atomic_write(path: str, data: bytes) -> None:
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(data)
    os.replace(tmp, path)


def _params_to_jax(model: torch.nn.Module) -> Dict[str, Any]:
    """A port model's parameters as its JAX param tree (a Ballé-17's in the
    JAX model's key order)."""
    if isinstance(model, Balle17Compressor):
        return params_to_jax(model.state_dict())
    return model_params_to_jax(model)


def save_params(model: torch.nn.Module, directory: str, step: int, prefix: str = "iter") -> str:
    """Write ``<directory>/<prefix>_<step>.ckpt``: the model's parameters as
    the JAX package's flax msgpack param tree."""
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"{prefix}_{step}.ckpt")
    _atomic_write(path, msgpack_dumps(_params_to_jax(model)))
    return path


def load_params(model: torch.nn.Module, path: str) -> torch.nn.Module:
    """Load a whole JAX-layout param file (bare tree or under "params")."""
    sd = params_from_jax(read_checkpoint(path))
    model.load_state_dict({k: v.to(model.state_dict()[k].device) for k, v in sd.items()})
    return model


def _jax_leaves(model: torch.nn.Module, tree: Dict[str, Any]):
    """(port key, tensor in the port's layout) for each parameter of
    ``model`` that a leaf of a JAX param tree of the same size names."""
    flat = _flatten(tree)
    lay = layout_of(model)
    for key, p in model.named_parameters():
        path = lay.path_of(key)
        v = flat.get(path)
        if v is not None and np.size(v) == p.numel():
            v = _leaf_from_jax(np.asarray(v), path, lay.is_deconv, lay.perms)
            yield key, torch.from_numpy(np.array(v, order="C"))


def load_params_partial(model: torch.nn.Module, path: str) -> torch.nn.Module:
    """Load only the leaves of a JAX-layout param file (the tree of the
    model's kind, bare or under ``params``), or of the
    port's train-state file, whose key and shape match the model's (the
    reference's partial state_dict load, model.py:26-27); every other
    parameter keeps its value."""
    _, sd = read_weights(path)
    if sd is not None:
        leaves = sd.items()
    else:
        tree = read_checkpoint(path)
        if isinstance(tree.get("params"), dict):
            tree = tree["params"]
        leaves = _jax_leaves(model, tree)
    own = model.state_dict()
    with torch.no_grad():
        for key, v in leaves:
            if key in own and own[key].shape == v.shape:
                own[key].copy_(v)
    return model


def snapshot_train_state(state: TrainState) -> Dict[str, Any]:
    """A copy of what ``save_train_state`` writes (model, optimizer, step),
    which later updates of ``state`` leave as it is."""
    return copy.deepcopy(_train_state_dict(state))


def _train_state_dict(state: TrainState) -> Dict[str, Any]:
    return {"model": state.model.state_dict(), "optimizer": state.optimizer.state_dict(),
            "step": state.step}


def save_train_state(state: Union[TrainState, Dict[str, Any]], directory: str, name: str,
                     epoch: int = 0, loss: float = 0.0,
                     extra: Optional[Dict[str, Any]] = None) -> str:
    """Write ``<directory>/<name>.ckpt`` (model, optimizer, step) of a train
    state or of its ``snapshot_train_state``, and its JSON sidecar
    ``<name>.ckpt.json``."""
    blob = state if isinstance(state, dict) else _train_state_dict(state)
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"{name}.ckpt")
    tmp = path + ".tmp"
    torch.save(blob, tmp)
    os.replace(tmp, path)
    meta = {"epoch": epoch, "loss": loss, "step": blob["step"]}
    if extra:
        meta.update(extra)
    _atomic_write(path + ".json", json.dumps(meta).encode())
    return path


def load_train_state(state: TrainState, path: str) -> Tuple[TrainState, Dict[str, Any]]:
    """Restore ``state`` in place from ``save_train_state``'s file; returns
    (state, sidecar metadata)."""
    # loaded on the CPU: load_state_dict moves each tensor where the live
    # state keeps it (Adam's step counters stay on the CPU, as in a run that
    # never stopped)
    blob = torch.load(path, map_location="cpu", weights_only=True)
    state.model.load_state_dict(blob["model"])
    state.optimizer.load_state_dict(blob["optimizer"])
    state.step = int(blob["step"])
    meta = {}
    if os.path.exists(path + ".json"):
        with open(path + ".json") as f:
            meta = json.load(f)
    return state, meta


def step_from_filename(path: str) -> int:
    """The global step of 'iter_<N>.ckpt' (0 for another name)."""
    m = re.search(r"iter_(\d+)\.ckpt$", path)
    return int(m.group(1)) if m else 0


def latest_checkpoint(directory: str, prefix: str = "iter") -> Optional[str]:
    if not os.path.isdir(directory):
        return None
    best, best_step = None, -1
    for f in os.listdir(directory):
        m = re.match(rf"{prefix}_(\d+)\.ckpt$", f)
        if m and int(m.group(1)) > best_step:
            best, best_step = os.path.join(directory, f), int(m.group(1))
    return best


def resolve_resume(path: str) -> Optional[str]:
    """Resolve a ``--resume`` argument: an explicit .ckpt file, or a run
    directory — in which case prefer ``latest.ckpt``, then the highest
    ``epoch_N.ckpt``, then ``best_train.ckpt``."""
    if os.path.isfile(path):
        return path
    if not os.path.isdir(path):
        return None
    latest = os.path.join(path, "latest.ckpt")
    if os.path.exists(latest):
        return latest
    best, best_epoch = None, -1
    for f in os.listdir(path):
        m = re.match(r"epoch_(\d+)\.ckpt$", f)
        if m and int(m.group(1)) > best_epoch:
            best, best_epoch = os.path.join(path, f), int(m.group(1))
    if best:
        return best
    bt = os.path.join(path, "best_train.ckpt")
    return bt if os.path.exists(bt) else None
