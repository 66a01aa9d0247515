"""The device mesh: a grid of devices that a batch's parts and an image's
tiles live on, one process driving them all.

Counterpart of ``iclr_17_compression_tpu/parallel/mesh.py``. JAX runs one
controller over a ``Mesh(('data', 'tile'))`` and lets GSPMD place each
shard; here ``Mesh`` is the same ``(n_data, n_tile)`` grid of
``torch.device``s, and a tensor split over it is Python lists of tensors,
part (r, t) on ``mesh.devices[r, t]``. There is no ``torch.distributed``: a
halo exchange (``halo.py``) copies a neighbour's edge to the tile's device,
and a split train step's gradients are copied to one slot and summed, a
plain copy on one card and a peer copy across cards. So N slots run on one
H100 (``["cuda:0"] * n``) or on N, with the same code, and the tests run
them on ``["cpu"] * n``.

The tile axis (serving): ``split_tiles`` / ``gather_tiles`` take the place
of ``tile_sharding``: the split is ``np.array_split``'s, ragged where the
extent does not divide. ``replicated`` takes the place of ``replicated``:
each distinct tile device gets the module (the module itself on its own
device, no copy). ``validate_tile_extent`` is a copy of the JAX check.

The data axis (training): ``batch_split`` / ``batch_and_tile_split`` take
the place of ``batch_sharding`` / ``batch_and_tile_sharding`` (a batch
splits along N into ``n_data`` equal parts, as JAX requires a divisible
batch; each part along W over the tile axis), ``put_batch`` places a batch
so, ``put_replicated`` gives every slot a replica of the model (a copy
for each slot but (0, 0), even where a device repeats), and
``training_mesh`` has JAX's semantics. The split train step built on them
is ``train.mesh_step.shard_train_step``.
"""

import copy
from typing import List, Optional, Sequence, Union

import numpy as np
import torch

Device = Union[str, torch.device]

# NHWC axis of each tiled image axis
TILE_AXES = {"width": 2, "height": 1}


def tile_dim(axis: Union[str, int]) -> int:
    """The NHWC dimension of ``axis`` ("width", "height", or 2 / 1)."""
    if axis in TILE_AXES:
        return TILE_AXES[axis]
    if axis in (1, 2):
        return int(axis)
    raise ValueError(f"tile axis must be 'width' or 'height', got {axis!r}")


class Mesh:
    """An ``(n_data, n_tile)`` grid of devices with axes ("data", "tile"),
    as the JAX ``Mesh`` it stands for; ``shape`` maps each axis name to its
    size."""

    axis_names = ("data", "tile")

    def __init__(self, devices: np.ndarray):
        if devices.ndim != 2:
            raise ValueError(f"a mesh is a 2-D grid of devices, got shape {devices.shape}")
        self.devices = devices

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    def tile_devices(self, row: int = 0) -> List[torch.device]:
        """The devices of the tile axis at data index ``row``."""
        return list(self.devices[row])

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {[str(d) for d in self.devices.ravel()]})"


def _devices(mesh_or_devices) -> List[torch.device]:
    if isinstance(mesh_or_devices, Mesh):
        return mesh_or_devices.tile_devices()
    return [torch.device(d) for d in mesh_or_devices]


def make_mesh(n_data: Optional[int] = None, n_tile: int = 1,
              devices: Optional[Sequence[Device]] = None) -> Mesh:
    """A ("data", "tile") mesh over ``devices`` (every CUDA device by
    default; raises without one). A device may repeat: ``["cuda:0"] * 4``
    is four tiles on one card."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass devices=['cpu'] * n to tile on the CPU")
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    if n_data is None:
        n_data = len(devices) // n_tile
    if n_data * n_tile != len(devices):
        raise ValueError(f"mesh {n_data}x{n_tile} != {len(devices)} devices")
    grid = np.empty(len(devices), dtype=object)
    grid[:] = devices
    return Mesh(grid.reshape(n_data, n_tile))


def split_tiles(x: torch.Tensor, mesh_or_devices, axis: Union[str, int] = "width",
                unit: int = 1) -> List[torch.Tensor]:
    """An NHWC tensor cut into one tile per tile device along ``axis``
    (``np.array_split``'s ragged split, in whole ``unit``s of columns: a
    training tile starts where the model's downsampled grids do), each
    tile contiguous on its device; raises where a tile would get no
    unit."""
    devices = _devices(mesh_or_devices)
    dim = tile_dim(axis)
    if x.shape[dim] % unit:
        raise ValueError(f"extent {x.shape[dim]} is not a multiple of the tile unit {unit}")
    sizes = [len(a) * unit for a in np.array_split(np.arange(x.shape[dim] // unit),
                                                   len(devices))]
    if 0 in sizes:
        # JAX's GSPMD pads such a shard; a tile here is at least one unit
        raise ValueError(f"extent {x.shape[dim]} gives {len(devices)} tiles fewer than one "
                         f"tile unit of {unit} columns each")
    parts = torch.split(x, sizes, dim=dim)
    return [p.to(d).contiguous() for p, d in zip(parts, devices)]


def gather_tiles(tiles: Sequence[torch.Tensor], axis: Union[str, int] = "width",
                 device: Optional[Device] = None) -> torch.Tensor:
    """The tiles joined along ``axis`` on ``device`` (the first tile's by
    default)."""
    dev = tiles[0].device if device is None else torch.device(device)
    return torch.cat([t.to(dev) for t in tiles], dim=tile_dim(axis))


def same_device(a: torch.device, b: torch.device) -> bool:
    """Whether two devices are one ("cuda" is "cuda:0")."""
    return a.type == b.type and (a.type != "cuda" or (a.index or 0) == (b.index or 0))


def replicated(module: torch.nn.Module, mesh_or_devices) -> List[torch.nn.Module]:
    """The module on each tile device: ``module`` itself where it already
    lies there, else one copy a distinct device."""
    own = next(module.parameters()).device
    copies = {}
    out = []
    for d in _devices(mesh_or_devices):
        if same_device(d, own):
            out.append(module)
            continue
        key = (d.type, d.index or 0)
        if key not in copies:
            copies[key] = copy.deepcopy(module).to(d)
        out.append(copies[key])
    return out


def validate_tile_extent(width: int, n_tile: int, total_div: int, min_shard: int = 2):
    """Refuse spatial tilings in GSPMD's silent-wrong-answer regime (the JAX
    check, copied with its semantics).

    When a W-shard of the deepest latent is narrower than a conv kernel's
    halo, XLA's partitioner produces numerically wrong results without any
    error. The port's exchanges read past a narrow neighbour (``halo.py``)
    and do not have that failure, but a shard of under ``min_shard`` latent
    columns is refused all the same, as in JAX.

    ``total_div``: the codec's total spatial downsampling (16 for the
    Ballé/Cheng latent, 32 for the DSC code tensor).
    """
    if n_tile <= 1:
        return
    shard = (width // total_div) // n_tile
    if shard < min_shard:
        raise ValueError(
            f"mesh_tile={n_tile} gives deepest-latent W shards of {shard} px "
            f"(width {width}, ÷{total_div}); shards narrower than {min_shard} px "
            "fall into GSPMD's halo>shard regime which silently mis-computes. "
            "Use fewer tiles or wider images."
        )


# ---------------------------------------------------------------------------
# The data axis: the training mesh.
# ---------------------------------------------------------------------------

def training_mesh(batch_size: int, n_data: Optional[int] = None, n_tile: int = 1,
                  devices: Optional[Sequence[Device]] = None) -> Mesh:
    """The mesh of a training run (JAX's semantics). ``devices``: every CUDA
    device by default (``make_mesh``'s). ``n_data=None`` takes as many of
    them as the batch divides evenly into (so a default config trains on 1
    card, an 8-device test mesh or more cards unchanged); an explicit
    ``n_data`` that does not divide the batch raises."""
    devices = list(make_mesh(devices=devices).devices.ravel())
    avail = len(devices) // n_tile
    if avail < 1:
        raise ValueError(f"n_tile={n_tile} exceeds {len(devices)} devices")
    if n_data is None:
        n_data = avail
        while n_data > 1 and batch_size % n_data != 0:
            n_data -= 1
    elif batch_size % n_data != 0:
        raise ValueError(f"batch_size={batch_size} not divisible by mesh data={n_data}")
    return make_mesh(n_data, n_tile, devices[: n_data * n_tile])


def _data_parts(x: torch.Tensor, mesh: Mesh):
    """``x`` cut along N into the mesh's ``n_data`` equal parts."""
    n_data = mesh.shape["data"]
    if x.shape[0] % n_data:
        raise ValueError(f"batch of {x.shape[0]} not divisible by mesh data={n_data}")
    return torch.chunk(x, n_data, dim=0)


def batch_split(x: torch.Tensor, mesh: Mesh) -> List[torch.Tensor]:
    """An NHWC batch cut along N into ``n_data`` equal parts, part r on
    slot (r, 0)'s device (JAX's ``batch_sharding``)."""
    return [p.to(mesh.devices[r, 0]).contiguous() for r, p in enumerate(_data_parts(x, mesh))]


def batch_and_tile_split(x: torch.Tensor, mesh: Mesh, unit: int = 1
                         ) -> List[List[torch.Tensor]]:
    """``batch_split``'s parts, each cut along W over its data row's tile
    devices (``split_tiles`` in ``unit``s of columns): part (r, t) on slot
    (r, t)'s device (JAX's ``batch_and_tile_sharding``)."""
    return [split_tiles(p, mesh.tile_devices(r), unit=unit)
            for r, p in enumerate(_data_parts(x, mesh))]


def put_batch(mesh: Mesh, *arrays, unit: int = 1):
    """Each batch (NHWC array or tensor) as ``batch_and_tile_split``'s grid
    of parts; one batch in, one grid out."""
    out = tuple(batch_and_tile_split(torch.as_tensor(a), mesh, unit) for a in arrays)
    return out[0] if len(out) == 1 else out


def put_replicated(module: torch.nn.Module, mesh: Mesh) -> List[List[torch.nn.Module]]:
    """A replica of ``module`` for every slot, as a grid: ``module`` itself
    at slot (0, 0), a copy on its device at every other slot, even where
    the device repeats (each slot's gradients are then its own, and the
    split step sums them by the same path on one card as across cards)."""
    own = next(module.parameters()).device
    if not same_device(own, mesh.devices[0, 0]):
        raise ValueError(f"the model lies on {own}, slot (0, 0) on {mesh.devices[0, 0]}")
    return [[module if (r, t) == (0, 0) else copy.deepcopy(module).to(d)
             for t, d in enumerate(row)] for r, row in enumerate(mesh.devices)]
