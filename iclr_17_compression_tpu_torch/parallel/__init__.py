"""Tiled serving over a list of devices (ROADMAP item 20a): the tile axis of
``iclr_17_compression_tpu/parallel``. The data axis (the training mesh) is
item 20b."""

from .halo import (
    halo_exchange_w,
    make_tiled_balle17,
    tiled_conv2d,
    tiled_conv_transpose2d,
)
from .mesh import (
    Mesh,
    gather_tiles,
    make_mesh,
    replicated,
    split_tiles,
    validate_tile_extent,
)
from .ring_pam import pam_eval_ring
from .tiled import (
    TiledStreams,
    decode_streams_to_code,
    encode_tiles_to_streams,
    make_tiled_codec,
    make_tiled_dsc,
)

__all__ = [
    "Mesh",
    "make_mesh",
    "split_tiles",
    "gather_tiles",
    "replicated",
    "validate_tile_extent",
    "TiledStreams",
    "make_tiled_codec",
    "make_tiled_dsc",
    "encode_tiles_to_streams",
    "decode_streams_to_code",
    "halo_exchange_w",
    "make_tiled_balle17",
    "tiled_conv2d",
    "tiled_conv_transpose2d",
    "pam_eval_ring",
]
