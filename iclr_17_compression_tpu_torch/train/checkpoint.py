"""Checkpoint save/restore.

Counterpart of ``iclr_17_compression_tpu/train/checkpoint.py``:

- ``save_params`` / ``load_params`` / ``load_params_partial``: bare
  parameter snapshots ``iter_<step>.ckpt`` in the JAX package's layout, a
  flax msgpack of the JAX Ballé-17 param tree (``train/weights.py``). A
  model trained by the port loads in the JAX package and through the port's
  ``load_balle17``; a JAX checkpoint loads in the port.
- ``save_train_state`` / ``load_train_state``: the port's own full state, a
  ``torch.save`` of the model's and the optimizer's state dicts and the
  step, with the JAX package's JSON sidecar (epoch, loss, step and extras
  such as ``batch_in_epoch``). Read back with ``weights_only=True``.
- ``step_from_filename``, ``latest_checkpoint``, ``resolve_resume``.

Files are written to a temporary name and renamed, so a reader never sees
a truncated file.
"""

import json
import os
import re
from typing import Any, Dict, Optional, Tuple

import torch

from .state import TrainState
from .weights import (
    _flatten,
    _leaf_to_port,
    msgpack_dumps,
    params_from_jax,
    params_to_jax,
    read_checkpoint,
)


def _atomic_write(path: str, data: bytes) -> None:
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(data)
    os.replace(tmp, path)


def save_params(model: torch.nn.Module, directory: str, step: int, prefix: str = "iter") -> str:
    """Write ``<directory>/<prefix>_<step>.ckpt``: the model's parameters as
    the JAX package's flax msgpack param tree."""
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"{prefix}_{step}.ckpt")
    _atomic_write(path, msgpack_dumps(params_to_jax(model.state_dict())))
    return path


def load_params(model: torch.nn.Module, path: str) -> torch.nn.Module:
    """Load a whole JAX-layout param file (bare tree or under "params")."""
    sd = params_from_jax(read_checkpoint(path))
    model.load_state_dict({k: v.to(model.state_dict()[k].device) for k, v in sd.items()})
    return model


def load_params_partial(model: torch.nn.Module, path: str) -> torch.nn.Module:
    """Load only the leaves of a JAX-layout param file whose key and shape
    match the model's (the reference's partial state_dict load, model.py:26-27);
    every other parameter keeps its value."""
    tree = read_checkpoint(path)
    if set(tree) == {"params"}:
        tree = tree["params"]
    own = model.state_dict()
    with torch.no_grad():
        for jpath, v in _flatten(tree).items():
            leaf = _leaf_to_port(jpath, v)
            if leaf is not None and leaf[0] in own and own[leaf[0]].shape == leaf[1].shape:
                own[leaf[0]].copy_(leaf[1])
    return model


def save_train_state(state: TrainState, directory: str, name: str, epoch: int = 0,
                     loss: float = 0.0, extra: Optional[Dict[str, Any]] = None) -> str:
    """Write ``<directory>/<name>.ckpt`` (model, optimizer, step) and its
    JSON sidecar ``<name>.ckpt.json``."""
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"{name}.ckpt")
    tmp = path + ".tmp"
    torch.save({"model": state.model.state_dict(), "optimizer": state.optimizer.state_dict(),
                "step": state.step}, tmp)
    os.replace(tmp, path)
    meta = {"epoch": epoch, "loss": loss, "step": state.step}
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
