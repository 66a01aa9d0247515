"""A train step split over a device mesh.

Counterpart of ``shard_train_step`` in
``iclr_17_compression_tpu/parallel/mesh.py``: JAX jits one step with state
and rng replicated and every batch argument sharded
``P("data", None, "tile", None)``, and GSPMD all-reduces the gradients.
Here one process drives the mesh (``parallel.mesh.Mesh``, a grid of
``torch.device``s that may repeat), with no ``torch.distributed``: every
slot holds a replica of the model (``put_replicated``), takes its part of
the batch (``put_batch``) and its view of the whole batch's noise
(``ops.quant.MeshNoise``), and the gradients are copied to slot (0, 0) and
summed there, a plain copy on one card and a peer copy across cards.
"""

from dataclasses import dataclass
from typing import Callable, List

import torch

from ..ops.quant import MeshNoise
from ..parallel.mesh import Mesh, put_batch, put_replicated
from .state import TrainStep, apply_gradients


@dataclass
class Split:
    """The slots of one split train step: ``models[r][t]`` slot (r, t)'s
    replica, ``batches[i][r][t]`` its part of batch argument i and
    ``noise[r][t]`` its view of the step's noise (``ops.quant.SlotNoise``);
    ``device`` is slot (0, 0)'s, where the loss is formed."""

    mesh: Mesh
    models: List[List[torch.nn.Module]]
    batches: List[List[List[torch.Tensor]]]
    noise: List[list]

    @property
    def device(self) -> torch.device:
        return self.mesh.devices[0, 0]


def sum_gradients(models: List[List[torch.nn.Module]]) -> None:
    """Every slot's gradients summed onto slot (0, 0)'s parameters, in one
    fixed order (row by row)."""
    head, *others = [m for row in models for m in row]
    for p, *qs in zip(head.parameters(), *(m.parameters() for m in others)):
        for q in qs:
            if q.grad is None:
                continue
            g = q.grad.to(p.device)
            p.grad = g.clone() if p.grad is None else p.grad.add_(g)


def broadcast_parameters(models: List[List[torch.nn.Module]]) -> None:
    """Slot (0, 0)'s parameters and buffers copied into every other slot."""
    head, *others = [m for row in models for m in row]
    with torch.no_grad():
        for m in others:
            for dst, src in zip(m.parameters(), head.parameters()):
                dst.copy_(src)
            for dst, src in zip(m.buffers(), head.buffers()):
                dst.copy_(src)


def _noise_views(whole: MeshNoise, parts, n_data: int, rows: int) -> List[list]:
    """Each slot's view of ``whole``: its data row's batch rows and its
    tile's image columns."""
    noise = []
    for r in range(n_data):
        c0, views = 0, []
        for tile in parts[r]:
            views.append(whole.slot(slice(r * rows, (r + 1) * rows),
                                    slice(c0, c0 + tile.shape[2])))
            c0 += tile.shape[2]
        noise.append(views)
    return noise


def shard_train_step(step: TrainStep, mesh: Mesh, n_batch_args: int = 1) -> Callable:
    """``step`` (``train.state``'s ``(state, *batches, generator) ->
    metrics``) run over ``mesh``: the batch split along N over ``data`` and
    along W over ``tile``.

    On a 1×1 mesh it is ``step`` itself on the mesh's device. Else each
    call: every slot takes slot (0, 0)'s parameters (so an update, a
    restore or a pretrain load reaches all); each batch is cut with
    ``put_batch`` (W in the step's ``tile_unit``s, its model's
    downsampling); the step's ``mesh_loss`` runs every slot's forward on
    its part and its view of the whole batch's noise, and forms the loss
    and the whole batch's metrics at slot (0, 0) from the slots' sums
    (autograd-carrying copies); one backward; every slot's gradients summed
    onto slot (0, 0) (``sum_gradients``); the clamp and the Adam update
    there once (``apply_gradients``: the clamp is on the summed gradient,
    as ``optax.clip`` on the all-reduced one). One optimizer, at slot
    (0, 0); the replicas are made once, for the state's model."""
    n_data, n_tile = mesh.devices.shape
    if n_data * n_tile == 1:
        dev = mesh.devices[0, 0]

        def one_device(state, *args):
            *batches, generator = args
            return step(state, *(torch.as_tensor(b).to(dev, non_blocking=True)
                                 for b in batches), generator)

        return one_device
    cache = {}

    def split_step(state, *args):
        *batches, generator = args
        if len(batches) != n_batch_args:
            raise TypeError(f"expected {n_batch_args} batch arguments, got {len(batches)}")
        if cache.get("model") is not state.model:
            cache.update(model=state.model, models=put_replicated(state.model, mesh))
        models = cache["models"]
        broadcast_parameters(models)
        batches = [torch.as_tensor(b) for b in batches]
        parts = [put_batch(mesh, b, unit=step.tile_unit) for b in batches]
        n, h, w = batches[0].shape[:3]
        noise = _noise_views(MeshNoise(generator, (n, h, w)), parts[0], n_data, n // n_data)
        with torch.profiler.record_function("train_step/forward"):
            loss, metrics = step.mesh_loss(Split(mesh, models, parts, noise))
        with torch.profiler.record_function("train_step/backward"):
            for row in models:
                for m in row:
                    m.zero_grad(set_to_none=True)
            loss.backward()
        with torch.profiler.record_function("train_step/gradient_sum"):
            sum_gradients(models)
        with torch.profiler.record_function("train_step/optimizer"):
            apply_gradients(state)
        return metrics

    return split_step
