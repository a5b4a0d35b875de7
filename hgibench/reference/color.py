"""The ``.thgic`` color container in plain NumPy: what ``encode --color
--format thgi`` writes for an RGB image, and its reader.

The image's three channels are coded as three racing ``.thgi`` archives
(:mod:`.race`) of one depth, preset and predictor, in one of two
transforms:

* green-delta (1): ``G, (R - G) & 255, (B - G) & 255``;
* identity (0): ``R, G, B``.

A lossless preset codes both and keeps the smaller container,
green-delta on a tie; a lossy preset stores identity.  Both transforms
store the G plane alike, so this reference races five planes an image:
G, R - G, B - G, R and B.  The container: u32 magic 0x7C61A555 | u8 3 |
u8 transform | three times (u64 length | archive).
"""

from __future__ import annotations

import struct
from typing import List, Sequence, Tuple

import numpy as np

from . import hgi, race

__all__ = ["MAGIC", "IDENTITY", "GDELTA", "TRANSFORMS", "race_planes", "frame", "assemble",
           "encode", "split", "decode"]

MAGIC = 0x7C61_A555
IDENTITY, GDELTA = 0, 1
TRANSFORMS = {GDELTA: "gdelta", IDENTITY: "identity"}
_HEAD = struct.Struct("<IBB")
# The race's planes of an image that each transform stores, in order.
_STORED = {GDELTA: (0, 1, 2), IDENTITY: (3, 0, 4)}


def race_planes(rgb: np.ndarray) -> np.ndarray:
    """uint8 ``[H, W, 3]`` RGB -> ``[5, H, W]``: G, R - G, B - G, R, B."""
    r, g, b = (rgb[:, :, c].astype(np.int16) for c in range(3))
    return np.stack([g, (r - g) & 255, (b - g) & 255, r, b]).astype(np.uint8)


def frame(transform: int, blobs: Sequence[bytes]) -> bytes:
    parts = [_HEAD.pack(MAGIC, 3, transform)]
    for blob in blobs:
        parts += [struct.pack("<Q", len(blob)), blob]
    return b"".join(parts)


def assemble(blobs: Sequence[bytes], lossless: bool = True, keep: str = None) -> Tuple[bytes, int]:
    """An image's container from its five planes' archives (in
    :func:`race_planes`' order), and its transform: the smaller of the two,
    green-delta on a tie, where ``lossless``, else identity.  ``keep``
    (``"identity"``) keeps that transform whatever the sizes: the
    benchmark's control."""
    options = [t for t in (GDELTA, IDENTITY) if lossless or t == IDENTITY]
    if keep is not None:
        options = [t for t in options if TRANSFORMS[t] == keep]
    framed = [(frame(t, [blobs[i] for i in _STORED[t]]), t) for t in options]
    return min(framed, key=lambda f: len(f[0]))


def encode(images: Sequence[np.ndarray], levels: int, preset: str, predictor: str = "crossed",
           codecs: Sequence[str] = ("deflate", "rans", "ctx"), keep: str = None,
           ) -> List[Tuple[bytes, int]]:
    """uint8 ``[H, W, 3]`` images of one shape -> each one's ``.thgic`` and
    transform, the planes of all of them raced in one batch (``codecs`` and
    the lockstep as in :func:`.race.race`)."""
    planes = np.concatenate([race_planes(rgb) for rgb in images])
    grids, _ = hgi.encode(planes, levels, hgi.ERRORS[preset], predictor)
    blobs, _ = race.race(grids, levels, preset, predictor, codecs=codecs)
    return [assemble(blobs[5 * i : 5 * i + 5], preset == "lossless", keep)
            for i in range(len(images))]


def split(data: bytes) -> Tuple[int, List[bytes]]:
    """A ``.thgic`` -> its transform and its three archives; ValueError on
    a wrong magic, count, transform or length."""
    if len(data) < _HEAD.size:
        raise ValueError("not a .thgic")
    magic, n, transform = _HEAD.unpack_from(data)
    if magic != MAGIC or n != 3 or transform not in TRANSFORMS:
        raise ValueError(f"not a .thgic this reference reads: {magic:#x}, {n}, {transform}")
    blobs, off = [], _HEAD.size
    for _ in range(3):
        if off + 8 > len(data):
            raise ValueError("a truncated .thgic")
        (size,) = struct.unpack_from("<Q", data, off)
        off += 8
        if off + size > len(data):
            raise ValueError("a truncated .thgic")
        blobs.append(data[off : off + size])
        off += size
    if off != len(data):
        raise ValueError("bytes after the .thgic's third archive")
    return transform, blobs


def decode(data: bytes) -> np.ndarray:
    """A lossless ``.thgic`` of racing ``.thgi`` archives -> uint8
    ``[H, W, 3]`` RGB."""
    transform, blobs = split(data)
    planes = race.decode_tiles(blobs).astype(np.int16)
    if transform == GDELTA:
        g, dr, db = planes
        planes = np.stack([(dr + g) & 255, g, (db + g) & 255])
    return np.moveaxis(planes.astype(np.uint8), 0, 2)
