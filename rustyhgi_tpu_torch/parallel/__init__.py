"""The batch split over devices and the tiling of large planes.

Counterpart of ``rustyhgi_tpu/parallel``, in one process.  Its
multi-process tier (``MultiHostConfig``, ``encode_tiled_multihost``,
...) is not ported yet: each of those names raises NotImplementedError
naming the ROADMAP item that ports it.
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


def _multihost(name: str):
    def refuse(*args, **kwargs):
        raise NotImplementedError(
            f"{name} is not ported yet (ROADMAP Queue 1 item 11b: parallel/multihost.py "
            "on torch.distributed)"
        )

    refuse.__name__ = refuse.__qualname__ = name
    return refuse


MultiHostConfig = _multihost("MultiHostConfig")
TiledEncodeResult = _multihost("TiledEncodeResult")
encode_tiled_multihost = _multihost("encode_tiled_multihost")
decode_tiled_multihost = _multihost("decode_tiled_multihost")
write_thgit_multihost = _multihost("write_thgit_multihost")

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
]
