"""The batch split over devices, the tiling of large planes, and the
multi-process tiled tier.

Counterpart of ``rustyhgi_tpu/parallel``: :mod:`.mesh` and :mod:`.sharded`
split a batch over the devices of one process; :mod:`.multihost` splits a
tiled plane over the processes of a ``torch.distributed`` group.
"""

from .mesh import DATA_AXIS, TILE_AXIS, Mesh, make_mesh
from .sharded import (
    decode_batch_sharded,
    decode_subbands_batch_sharded,
    encode_batch_sharded,
    encode_subbands_batch_sharded,
    pad_batch,
    sharded_histogram,
    tile_plane,
    untile_plane,
)

from .multihost import (
    MultiHostConfig,
    TileCodingError,
    TiledEncodeResult,
    decode_tiled_multihost,
    encode_tiled_multihost,
    initialize,
    write_thgit_multihost,
)

__all__ = [
    "DATA_AXIS",
    "TILE_AXIS",
    "Mesh",
    "make_mesh",
    "encode_batch_sharded",
    "decode_batch_sharded",
    "encode_subbands_batch_sharded",
    "decode_subbands_batch_sharded",
    "sharded_histogram",
    "tile_plane",
    "untile_plane",
    "pad_batch",
    "MultiHostConfig",
    "TiledEncodeResult",
    "encode_tiled_multihost",
    "decode_tiled_multihost",
    "write_thgit_multihost",
    "TileCodingError",
    "initialize",
]
