"""The device mesh of ``iclr_17_compression_tpu/parallel``, one process over
a list of devices: tiled serving (ROADMAP item 20a), and the placement and
tiled forwards that the training mesh (item 20b,
``train.mesh_step.shard_train_step``) is built on."""

from .halo import (
    halo_exchange_w,
    make_tiled_balle17,
    tiled_conv2d,
    tiled_conv_transpose2d,
)
from .mesh import (
    Mesh,
    batch_and_tile_split,
    batch_split,
    gather_tiles,
    make_mesh,
    put_batch,
    put_replicated,
    replicated,
    split_tiles,
    training_mesh,
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
    "training_mesh",
    "batch_split",
    "batch_and_tile_split",
    "put_batch",
    "put_replicated",
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
