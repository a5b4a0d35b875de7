"""The fast ``.thgi`` (codec 7) and the ``.thgit`` v2 tiled container,
written and read in plain Python and NumPy, with the reference's codec.

``.thgi``: u32 magic 0x7B61A555 | metadata (u32 quantization tag, u32
interpolation tag, u32 width, u32 height, u64 depth) | u8 layout (0: the
row-major grid) | u8 codec (7: lane-parallel rANS) | u64 payload size |
the rANS payload of the grid (:mod:`.rans`).

``.thgit`` v2: u32 magic 0x7161A556, tile, width, height, block count,
u8 flags (0: no shared table), then a frame a tile in row-major tile
order: u64 block length, u32 CRC-32 of the block, the block (a tile's
``.thgi``).  Tiles are the plane zero-padded to whole tiles.
"""

from __future__ import annotations

import struct
import zlib
from typing import List, Tuple

import numpy as np

from . import hgi, rans

__all__ = ["FAST_HEAD", "coded_words", "write_fast", "read_fast", "tile_plane", "thgit_bytes",
           "thgit_frame", "parse_thgit"]

THGI_MAGIC = 0x7B61_A555
THGIT2_MAGIC = 0x7161_A556
CODEC_RANS_TPU = 7
_META = struct.Struct("<IIIIQ")
_HEAD = struct.Struct("<BBQ")
_THGIT_HEAD = struct.Struct("<IIIIIB")
_FRAME = struct.Struct("<QI")
FAST_HEAD = 4 + _META.size + _HEAD.size  # magic, meta and head before the payload


def _frame(h: int, w: int, levels: int, preset: str, predictor: str, payload: bytes) -> bytes:
    meta = _META.pack(hgi.TAGS[preset], hgi.PREDICTOR_TAGS[predictor], w, h, levels)
    return b"".join((struct.pack("<I", THGI_MAGIC), meta, _HEAD.pack(0, CODEC_RANS_TPU, h * w),
                     payload))


def coded_words(blob_len: int, symbols: int) -> int:
    """The coded 16-bit words of a fast ``.thgi`` of ``symbols`` pixels that
    is ``blob_len`` bytes long: its length less the container's head and
    the payload's."""
    return (blob_len - FAST_HEAD - rans.head_bytes(symbols)) // 2


def write_fast(planes: np.ndarray, levels: int, preset: str, predictor: str = "crossed",
               error: int = None) -> List[bytes]:
    """The fast ``.thgi`` of each uint8 plane of ``[B, H, W]``.

    ``error`` quantizes with another preset's error than the one the
    header names: the benchmark's control, which breaks the stated bound.
    """
    b, h, w = planes.shape
    grid, _ = hgi.encode(planes, levels, hgi.ERRORS[preset] if error is None else error, predictor)
    payloads = rans.encode(grid.reshape(b, h * w))
    return [_frame(h, w, levels, preset, predictor, p) for p in payloads]


def read_fast(blobs: List[bytes], skip_finest: bool = False) -> np.ndarray:
    """Fast ``.thgi`` archives of one shape -> uint8 ``[B, H, W]`` planes.

    Raises ValueError on a wrong magic, layout, codec or size, or a
    malformed payload.
    """
    metas = []
    for blob in blobs:
        if len(blob) < FAST_HEAD or \
                struct.unpack_from("<I", blob)[0] != THGI_MAGIC:
            raise ValueError("not a .thgi")
        q, interp, w, h, levels = _META.unpack_from(blob, 4)
        layout, codec, raw = _HEAD.unpack_from(blob, 4 + _META.size)
        if (layout, codec, raw) != (0, CODEC_RANS_TPU, h * w):
            raise ValueError(f"not a fast row-major .thgi: {layout}, {codec}, {raw}")
        metas.append((interp, w, h, levels))
    if len(set(metas)) != 1:
        raise ValueError("archives differ in shape, depth or predictor")
    interp, w, h, levels = metas[0]
    grid = rans.decode([blob[FAST_HEAD:] for blob in blobs]).reshape(len(blobs), h, w)
    predictor = "left_top" if interp == hgi.PREDICTOR_TAGS["left_top"] else "crossed"
    return hgi.decode(grid, levels, predictor, skip_finest=skip_finest)


def tile_plane(plane: np.ndarray, tile: int) -> np.ndarray:
    """``[H, W]`` -> ``[n, tile, tile]`` zero-padded tiles, row-major."""
    h, w = plane.shape
    nh, nw = -(-h // tile), -(-w // tile)
    padded = np.zeros((nh * tile, nw * tile), np.uint8)
    padded[:h, :w] = plane
    return padded.reshape(nh, tile, nw, tile).transpose(0, 2, 1, 3).reshape(-1, tile, tile)


def thgit_bytes(plane: np.ndarray, tile: int, levels: int, preset: str, predictor: str = "crossed",
                error: int = None, chunk: int = 32) -> Tuple[bytes, List[int]]:
    """A plane's ``.thgit`` v2 of fast tiles, and the byte offset at which
    each block's frame ends."""
    tiles = tile_plane(plane, tile)
    blocks = [b for lo in range(0, tiles.shape[0], chunk)
              for b in write_fast(tiles[lo : lo + chunk], levels, preset, predictor, error)]
    return thgit_frame(plane.shape, tile, blocks)


def thgit_frame(shape: Tuple[int, int], tile: int, blocks: List[bytes]) -> Tuple[bytes, List[int]]:
    """The ``.thgit`` v2 of a plane's tile blocks, and each frame's end."""
    h, w = shape
    parts = [_THGIT_HEAD.pack(THGIT2_MAGIC, tile, w, h, len(blocks), 0)]
    ends, pos = [], len(parts[0])
    for block in blocks:
        parts.append(_FRAME.pack(len(block), zlib.crc32(block)) + block)
        pos += len(parts[-1])
        ends.append(pos)
    return b"".join(parts), ends


def parse_thgit(data: bytes):
    """A ``.thgit`` v2 without a shared table -> ``(tile, width, height,
    blocks)``; ValueError on a wrong header, a short frame or a bad CRC."""
    if len(data) < _THGIT_HEAD.size:
        raise ValueError("truncated .thgit")
    magic, tile, w, h, n, flags = _THGIT_HEAD.unpack_from(data)
    if magic != THGIT2_MAGIC or flags != 0 or n != -(-h // tile) * -(-w // tile):
        raise ValueError("not a .thgit v2 of fast tiles")
    off, blocks = _THGIT_HEAD.size, []
    for i in range(n):
        if off + _FRAME.size > len(data):
            raise ValueError(f"truncated at block {i}")
        length, crc = _FRAME.unpack_from(data, off)
        off += _FRAME.size
        block = data[off : off + length]
        if len(block) != length or zlib.crc32(block) != crc:
            raise ValueError(f"block {i}: short or CRC mismatch")
        blocks.append(block)
        off += length
    if off != len(data):
        raise ValueError("trailing bytes")
    return tile, w, h, blocks
