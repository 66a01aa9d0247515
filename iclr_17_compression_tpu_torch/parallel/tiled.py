"""Spatially tiled encode/decode for large images, with per-tile bitstreams.

Counterpart of ``iclr_17_compression_tpu/parallel/tiled.py``. JAX shards
the image W axis over the mesh's 'tile' axis and lets GSPMD insert every
halo; here the image is a list of tiles on the mesh's tile devices
(``mesh.py``) and the port supplies the halos itself:

- the Ballé-17 codec (``make_tiled_codec``) exchanges one halo a conv
  (``halo.py``: K2 per tile for each conv + GDN, K3 for the rounding, K1
  for each IGDN, cuDNN's transposed convs with halos): its three stages
  have radii of a few columns, so per-op halos move the least data;
- the DSC codec (``make_tiled_dsc``) runs each transform stack (``g_a``,
  ``g_a22``, ``g_s22``, the fusion net, ``g_s``) on tiles extended by one
  overlap of at least the stack's receptive radius, then crops
  (``halo.stack_tiles``): its stacks nest residual and attention blocks of
  up to twenty convs each, so one overlap a stack replaces a hundred
  exchanges. Why it is exact: ``halo.py``'s docstring. The fusion
  presets' modules that see the whole latent run whole instead
  (``TileRun.whole``: the tiles gathered onto the first tile's device, the
  module run once, its output split back), as GSPMD gathers them in JAX:
  ``fif`` (its dilated convs pad circularly, wrapping the latent's far
  edge in), the bottleneck attention of ``bot_att`` (attention over the
  whole latent) and the ``patch_att`` module (a patch grid over the whole
  latent). ``pam`` attends along whole rows: it tiles along H (its convs
  and the mask's morphology take an overlap of 14 rows); in serving, W-tiles
  are refused as JAX refuses them and go through ``ring_pam.py``, and the
  W-tiled train forward runs it whole. The tiled receiver is the model's
  own (``models.dsc.receive``) under a ``TileRun``, which runs each stack
  tile by tile; the training mesh's W-tiles run the model's train forward
  so (``tiled_dsc_train``).

Bitstreams are per tile: the quantized code is split along W (or H) and
each tile rANS-encoded on its own (a thread pool; the C++ coder releases
the GIL in its ctypes calls) against one codec for every tile, so N tiles
give N streams that decode independently; ``TiledStreams`` carries each
tile's shape, so ragged tiles round-trip. ``serialize`` gives the JAX
package's bytes.
"""

import concurrent.futures as _futures
import functools
from dataclasses import dataclass
from fractions import Fraction
from typing import Callable, List, Tuple

import numpy as np
import torch

from ..utils.device import precision_on_cuda
from .halo import (local_tiles, module_extent, refuse_binarize, round_tiles, stack_tiles,
                   tiled_analysis17, tiled_synthesis17)
from .mesh import gather_tiles, replicated, split_tiles, tile_dim

# the receptive radius of the PAM mask's morphology (closing then opening,
# each two passes with a disk of radius 3: models/passr.py clean_mask)
PAM_MASK_RADIUS = 4 * 3


@dataclass
class TiledStreams:
    """Container for per-tile bitstreams — the ragged all-gather.

    ``tile_shapes`` carries every tile's code shape explicitly: W-splitting
    an image whose code width is not divisible by n_tiles produces ragged
    tiles (np.array_split semantics), and decode must reshape each stream by
    its own width.
    """

    streams: List[bytes]
    tile_shapes: List[Tuple[int, ...]]

    @property
    def n_tiles(self) -> int:
        return len(self.streams)

    @property
    def total_bytes(self) -> int:
        return sum(len(s) for s in self.streams)

    def serialize(self) -> bytes:
        n = len(self.streams)
        ndim = len(self.tile_shapes[0])
        head = [n, ndim]
        for shp in self.tile_shapes:
            head.extend(shp)
        head.extend(len(s) for s in self.streams)
        return np.array(head, np.uint32).tobytes() + b"".join(self.streams)

    @classmethod
    def deserialize(cls, data: bytes) -> "TiledStreams":
        n, ndim = (int(v) for v in np.frombuffer(data[:8], np.uint32))
        off = 8
        shapes = []
        for _ in range(n):
            shapes.append(tuple(int(v) for v in np.frombuffer(data[off: off + 4 * ndim],
                                                              np.uint32)))
            off += 4 * ndim
        lens = np.frombuffer(data[off: off + 4 * n], np.uint32)
        off += 4 * n
        streams = []
        for ln in lens:
            streams.append(data[off: off + int(ln)])
            off += int(ln)
        return cls(streams=streams, tile_shapes=shapes)


def _tiles(x, mesh, axis) -> List[torch.Tensor]:
    """A list of tiles as given, or an NHWC array or tensor split over the
    mesh's tile devices."""
    if isinstance(x, (list, tuple)):
        return list(x)
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(np.ascontiguousarray(x, np.float32))
    return split_tiles(x, mesh, axis)


def make_tiled_codec(model, mesh, axis: str = "width") -> Tuple[Callable, Callable]:
    """Tiled (encode_fn, decode_fn) for the Ballé-17 codec ``model``:

      encode_fn(image)  -> integer latent tiles (K3's rounding), one a tile device
      decode_fn(latent) -> reconstruction tiles in [0, 1]

    ``image`` and ``latent`` are NHWC (array or tensor, split over the mesh
    along ``axis``) or lists of tiles. Encode is exactly the transmitter
    (analysis + round), decode exactly the receiver (synthesis + clip): the
    latent in between is what goes through the per-tile entropy coder. Each
    image tile's extent must be a multiple of 16. The model is replicated
    onto the tile devices once, here."""
    refuse_binarize(model)
    models = replicated(model, mesh)

    def encode_fn(image) -> List[torch.Tensor]:
        tiles = _tiles(image, mesh, axis)
        precision_on_cuda(tiles[0])
        with torch.no_grad():
            return round_tiles(tiled_analysis17([m.Encoder for m in models], tiles, axis))

    def decode_fn(latent) -> List[torch.Tensor]:
        tiles = _tiles(latent, mesh, axis)
        precision_on_cuda(tiles[0])
        with torch.no_grad():
            return [torch.clamp(r, 0.0, 1.0)
                    for r in tiled_synthesis17([m.Decoder for m in models], tiles, axis)]

    return encode_fn, decode_fn


def pam_extent(pam, dim: int = 1) -> Tuple[Fraction, Fraction]:
    """(radius, scale) of ``models.passr.PAM`` along H: its residual block's
    convs and the validity mask's morphology (its attention runs along W)."""
    if dim != 1:
        raise ValueError("PAM attends along whole rows: it is local along H only")
    return module_extent(pam.rb, dim)[0] + PAM_MASK_RADIUS, Fraction(1)


class TileRun:
    """How the DSC forward (``models.dsc.dsc_outputs``, ``receive``) runs
    over one image's tiles along ``axis``, tile i on replica ``models[i]``:
    ``stack(name, x)`` runs each replica's stack ``name`` on its tile
    extended by one overlap (``halo.stack_tiles``; PAM through
    ``local_tiles`` with its two inputs along H, and whole along W, where
    it attends across the tiles), ``whole(fn, *xs)`` runs ``fn`` once on
    the gathered tiles (a fusion module that sees the whole latent, taken
    from ``module``: tile 0's replica), ``each(fn, *xs)`` maps ``fn`` over
    the tiles; in ``whole`` and ``each`` a value that is not a list (a
    mask, None) is passed as it is."""

    def __init__(self, models, axis: str = "width"):
        self.models, self.axis = list(models), axis

    def module(self, name: str):
        return getattr(self.models[0], name)

    def stack(self, name: str, *xs, **kw) -> List[torch.Tensor]:
        if name == "pam":
            if self.axis == "width":
                return self.whole(functools.partial(self.module("pam"), **kw), *xs)
            pams = [functools.partial(m.pam, **kw) for m in self.models]
            return local_tiles(pams, list(xs), pam_extent(self.models[0].pam,
                                                          tile_dim(self.axis)), self.axis)
        if len(xs) != 1 or kw:
            raise ValueError(f"{name}: a tiled stack takes one input")
        return stack_tiles([getattr(m, name) for m in self.models], xs[0], self.axis)

    def whole(self, fn, *xs) -> List[torch.Tensor]:
        """``fn`` on the whole image: each list of tiles gathered along the
        axis onto the first tile's device (``mesh.gather_tiles``, copies
        that carry the gradient back to every tile), ``fn`` run once there,
        its output split back into each tile's own extent at the output's
        scale, each part on its tile's device."""
        dim = tile_dim(self.axis)
        first = next(x for x in xs if isinstance(x, list))
        y = fn(*(gather_tiles(x, self.axis) if isinstance(x, list) else x for x in xs))
        scale = Fraction(y.shape[dim], sum(t.shape[dim] for t in first))
        parts = torch.split(y, [int(t.shape[dim] * scale) for t in first], dim=dim)
        return [p.to(t.device).contiguous() for p, t in zip(parts, first)]

    def each(self, fn, *xs) -> list:
        return [fn(*(x[i] if isinstance(x, list) else x for x in xs))
                for i in range(len(self.models))]


def make_tiled_dsc(model, mesh, axis: str = "width") -> Tuple[Callable, Callable]:
    """Tiled (encode_fn, decode_fn) for a DSC stereo codec ``model``:

      encode_fn(image)    -> quantized and clamped coarse code tiles (K3)
      decode_fn(code, si) -> SI-assisted reconstruction tiles

    The encoder runs what the transmitter runs (g_a → g_a22 → quantize,
    reference models/temp.py:232-260, never sees the SI image); the decoder
    is the ``DSCDecoder`` receiver (``models.dsc.receive``) under a
    ``TileRun``. Each image tile's extent must be a multiple of the code's
    downsampling (32).

    ``axis``: which image axis the tiles split. PAM-fusion presets REQUIRE
    ``axis='height'``, as in JAX: parallax attention computes a full W×W
    attention per latent row (reference models/PASSRnet.py:124-136), so
    W-tiling would split its K/V (``ring_pam.pam_eval_ring`` is the W-tiled
    PAM). The fusion modules that see the whole latent run on the gathered
    tiles (``TileRun.whole``), on either axis. The model is replicated
    onto the tile devices once, here.
    """
    from ..models.dsc import quantize_code, receive

    cfg = model.config
    if cfg.fusion_post == "pam" and axis != "height":
        raise ValueError(
            "fusion_post='pam' attends across the full latent width per row; "
            "W-sharding would split its K/V. Use make_tiled_dsc(..., "
            "axis='height') (PAM is row-independent) or run replicated."
        )
    run = TileRun(replicated(model, mesh), axis)

    def encode_fn(image) -> List[torch.Tensor]:
        tiles = _tiles(image, mesh, axis)
        precision_on_cuda(tiles[0])
        with torch.no_grad():
            code_pre = run.stack("g_a22", run.stack("g_a", tiles))
            return [quantize_code(c, cfg)[1] for c in code_pre]

    def decode_fn(code, si_image) -> List[torch.Tensor]:
        code_t, si = _tiles(code, mesh, axis), _tiles(si_image, mesh, axis)
        precision_on_cuda(si[0])
        with torch.no_grad():
            return [torch.clamp(r, 0.0, 1.0) for r in receive(cfg, run, code_t, si)]

    return encode_fn, decode_fn


def tiled_dsc_train(models, im1: List[torch.Tensor], im2: List[torch.Tensor],
                    noises) -> List[dict]:
    """``DSCStereoModel``'s train forward but its loss
    (``models.dsc.dsc_outputs``) over one data row's W-tiles of im1 and
    im2, under a ``TileRun``: tile i on replica ``models[i]`` with noise
    view ``noises[i]`` (``ops.quant.SlotNoise``), each stack on tiles
    extended by one overlap (K2 for the blocks' conv + GDN), the fusion
    modules that see the whole latent (bottleneck and patch-match
    attention, PAM) on the gathered tiles at tile 0's replica.
    Differentiable throughout. Returns one dict a tile. Each tile's extent
    must be a multiple of the code's downsampling (32)."""
    from ..models.dsc import dsc_outputs

    precision_on_cuda(im1[0])
    out = dsc_outputs(models[0].config, TileRun(models), im1, im2, train=True,
                      generator=list(noises))
    return [dict(zip(out, tiles)) for tiles in zip(*out.values())]


def _host_tiles(code, n_tiles: int, axis: int) -> List[np.ndarray]:
    if isinstance(code, (list, tuple)):
        if len(code) != n_tiles:
            raise ValueError(f"{len(code)} tiles given for n_tiles={n_tiles}")
        return [t.detach().to("cpu", torch.float32).numpy() if isinstance(t, torch.Tensor)
                else np.asarray(t) for t in code]
    return np.array_split(np.asarray(code), n_tiles, axis=axis)


def encode_tiles_to_streams(code, codec, n_tiles: int, step: float = 1.0,
                            axis: int = 2) -> TiledStreams:
    """Split the code tensor into tiles along ``axis`` (2 = W, 1 = H for
    H-tiled PAM codecs; ragged-safe), or take the tiles a tiled encoder
    gave, and rANS-encode each independently with ``codec`` (thread pool)."""
    from ..coding.api import encode_latent

    sym_tiles = [np.round(t / step).astype(np.int64) for t in _host_tiles(code, n_tiles, axis)]
    with _futures.ThreadPoolExecutor(max_workers=min(n_tiles, 16)) as ex:
        streams = list(ex.map(lambda t: encode_latent(codec, t), sym_tiles))
    return TiledStreams(streams=streams, tile_shapes=[t.shape for t in sym_tiles])


def decode_streams_to_code(ts: TiledStreams, codec, step: float = 1.0,
                           axis: int = 2) -> np.ndarray:
    """The full code array of ``ts``'s streams, each tile decoded on its own
    (thread pool) and joined along ``axis``."""
    from ..coding.api import decode_latent

    with _futures.ThreadPoolExecutor(max_workers=min(ts.n_tiles, 16)) as ex:
        tiles = list(ex.map(lambda args: decode_latent(codec, args[0], args[1]),
                            zip(ts.streams, ts.tile_shapes)))
    return np.concatenate(tiles, axis=axis).astype(np.float32) * step
