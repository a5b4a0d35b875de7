"""The ``.hgi`` container.

Counterpart of the ``.hgi`` part of ``rustyhgi_tpu/utils/container.py``: a
byte-exact reader and writer for the reference's archive layout
(reference: src/archive.rs:13-55, src/grid.rs:1-5).  The host side of the
codec is numpy and zlib; no tensor crosses this module.

Byte layout (bincode 1.0 defaults: fixed-width little-endian ints, u32
enum tags, u64 length prefixes):

```
offset 0:  u32 LE magic 0xBAAD_A555                      (archive.rs:13,32)
offset 4:  u32 LE quantization_level tag                 (quantizator.rs:3-8)
           u32 LE interpolation tag                      (interpolator.rs:5-9)
           u32 LE width, u32 LE height                   (archive.rs:19-20)
           u64 LE scale_level                            (archive.rs:21)
offset 28: raw DEFLATE (level 9, no zlib header) of      (archive.rs:36-38)
             u64 LE buffer length (= width*height)
             width*height residual bytes, row-major      (grid.rs:2-3)
             u64 LE width                                (grid.rs:4)
```

The other containers of the JAX package (``.thgi``, ``.thgic``,
``.thgit``) are not ported yet; ``write_archive``/``read_archive`` raise
``NotImplementedError`` for them, naming the ROADMAP item that ports them.
"""

from __future__ import annotations

import dataclasses
import struct
import zlib

import numpy as np

from ..ops.quantizers import QuantizationLevel

__all__ = [
    "HGI_MAGIC",
    "Interpolation",
    "Metadata",
    "Archive",
    "write_hgi",
    "read_hgi",
    "write_archive",
    "read_archive",
]

HGI_MAGIC = 0xBAAD_A555  # archive.rs:13
THGI_MAGIC = 0x7B61_A555  # native container of the JAX package
THGIC_MAGIC = 0x7C61_A555  # its color container
THGIT_MAGICS = (0x7161_A555, 0x7161_A556)  # its tiled containers

# ROADMAP Queue 1 items that port the containers this module refuses.
_NOT_PORTED = {
    "thgi": ".thgi is not ported yet (ROADMAP Queue 1 item 7)",
    "thgic": ".thgic is not ported yet (ROADMAP Queue 1 item 10)",
    "thgit": ".thgit is not ported yet (ROADMAP Queue 1 item 11)",
}

# Decompression-bomb guard: the largest single plane a hostile header may
# declare (1 GPix ~= 1 GB of pixels).
MAX_PLANE_PIXELS = 1 << 30

_METADATA = struct.Struct("<IIIIQ")  # qlevel, interp, width, height, scale


class Interpolation:
    """Interpolator tags, serde enum order (interpolator.rs:4-9)."""

    CROSSED = 0
    LINE = 1  # metadata-only in the reference (no implementation)
    PREVIOUS = 2


@dataclasses.dataclass(frozen=True)
class Metadata:
    """Archive metadata (archive.rs:16-22)."""

    quantization_level: QuantizationLevel
    interpolation: int
    width: int
    height: int
    scale_level: int

    def pack(self) -> bytes:
        return _METADATA.pack(
            int(self.quantization_level),
            int(self.interpolation),
            self.width,
            self.height,
            self.scale_level,
        )

    @classmethod
    def unpack(cls, raw: bytes) -> "Metadata":
        if len(raw) < _METADATA.size:
            raise ValueError("truncated metadata")
        q, interp, w, h, scale = _METADATA.unpack(raw)
        # Sanity bounds on untrusted input: a hostile 28-byte header must
        # not drive multi-GB allocations downstream.  0x0 stays legal (an
        # empty plane is representable); one-sided zero dims do not.
        if w * h > MAX_PLANE_PIXELS or scale > 32 or (w == 0) != (h == 0):
            raise ValueError(
                f"implausible archive dimensions {w}x{h} levels={scale}"
            )
        return cls(QuantizationLevel(q), interp, w, h, scale)


@dataclasses.dataclass
class Archive:
    """An encoded image: metadata + residual grid plane (archive.rs:24-28)."""

    metadata: Metadata
    grid: np.ndarray  # uint8 [height, width]

    def __post_init__(self) -> None:
        self.grid = np.ascontiguousarray(self.grid, dtype=np.uint8)
        if self.grid.shape != (self.metadata.height, self.metadata.width):
            raise ValueError(
                f"grid shape {self.grid.shape} does not match metadata "
                f"{(self.metadata.height, self.metadata.width)}"
            )


def _deflate_one(payload: bytes, strategy: int) -> bytes:
    co = zlib.compressobj(9, zlib.DEFLATED, -15, 9, strategy)
    return co.compress(payload) + co.flush()


def _deflate_best(payload: bytes) -> bytes:
    # Raw DEFLATE at level 9 with no zlib framing, stream-compatible with
    # the reference's flate2 DeflateEncoder (archive.rs:36-38).  Z_FILTERED
    # is 1-4.5% smaller on residual planes; keep the smaller of the two.
    # Ties go to Z_FILTERED, as in the JAX writer, so the bytes match it.
    return min(
        (
            _deflate_one(payload, zlib.Z_FILTERED),
            _deflate_one(payload, zlib.Z_DEFAULT_STRATEGY),
        ),
        key=len,
    )


def _inflate_raw(payload: bytes, max_size: int) -> bytes:
    """Raw-DEFLATE inflate, output capped at ``max_size`` bytes.

    The cap is the bomb guard: the reader derives the exact payload size
    from the bounds-checked header, and a stream that would produce more
    is rejected.
    """
    do = zlib.decompressobj(-15)
    out = do.decompress(payload, max_size)
    if do.unconsumed_tail and do.decompress(do.unconsumed_tail, 1):
        raise ValueError("payload larger than declared size")
    if do.flush(1):
        raise ValueError("payload larger than declared size")
    return out


def write_hgi(archive: Archive) -> bytes:
    """Serialize to the reference's byte-exact .hgi layout (archive.rs:31-41)."""
    grid = archive.grid
    # bincode(Grid): u64 len, bytes, u64 width (grid.rs:1-5 field order).
    payload = b"".join(
        (
            struct.pack("<Q", grid.size),
            grid.tobytes(),
            struct.pack("<Q", archive.metadata.width),
        )
    )
    return struct.pack("<I", HGI_MAGIC) + archive.metadata.pack() + _deflate_best(payload)


def _magic(data: bytes) -> int:
    """Leading u32 magic of an archive; ValueError when short."""
    if len(data) < 4:
        raise ValueError("truncated archive")
    return struct.unpack_from("<I", data, 0)[0]


def read_hgi(data: bytes) -> Archive:
    """Parse a .hgi archive (archive.rs:43-55)."""
    if _magic(data) != HGI_MAGIC:
        raise ValueError("incorrect magic number")  # archive.rs:48
    meta = Metadata.unpack(data[4 : 4 + _METADATA.size])
    n = meta.width * meta.height
    payload = _inflate_raw(data[4 + _METADATA.size :], max_size=8 + n + 8)
    if len(payload) < 8 + n + 8:
        raise ValueError("truncated grid payload")
    (length,) = struct.unpack_from("<Q", payload, 0)
    if length != n:
        raise ValueError(
            f"grid length {length} does not match {meta.width}x{meta.height}"
        )
    (width,) = struct.unpack_from("<Q", payload, 8 + n)
    if width != meta.width:
        raise ValueError("grid width does not match metadata width")
    buf = np.frombuffer(payload, dtype=np.uint8, count=n, offset=8)
    return Archive(meta, buf.reshape(meta.height, meta.width).copy())


def write_archive(archive: Archive, fmt: str = "hgi") -> bytes:
    if fmt == "hgi":
        return write_hgi(archive)
    if fmt in _NOT_PORTED:
        raise NotImplementedError(_NOT_PORTED[fmt])
    raise ValueError(f"unknown container format {fmt!r}")


def read_archive(data: bytes) -> Archive:
    """Auto-detect the container format from the magic."""
    magic = _magic(data)
    if magic == HGI_MAGIC:
        return read_hgi(data)
    if magic == THGI_MAGIC:
        raise NotImplementedError(_NOT_PORTED["thgi"])
    if magic == THGIC_MAGIC:
        raise NotImplementedError(_NOT_PORTED["thgic"])
    if magic in THGIT_MAGICS:
        raise NotImplementedError(_NOT_PORTED["thgit"])
    raise ValueError("incorrect magic number")
