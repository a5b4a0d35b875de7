"""The ``.hgi``, ``.thgi`` and ``.thgit`` containers.

Counterpart of ``rustyhgi_tpu/utils/container.py``, byte for byte:

* ``.hgi``: the reference's archive layout (reference:
  src/archive.rs:13-55, src/grid.rs:1-5), raw DEFLATE-9;
* ``.thgi``: the JAX package's native container.  The same metadata,
  then the residuals in one of two layouts (row-major grid, or the
  subband layout: anchors plus per-level quads) coded by whichever
  entropy coder comes out smallest: DEFLATE, rANS, two-chunk rANS, a
  shared-table rANS, or (subband layout only) the context-adaptive
  coder, single or chunked.  The fast mode (``write_thgi(fast=True)``)
  codes on the device instead: codec 7, the lane-parallel rANS of
  :mod:`..ops.tpurans` (the default), or codec 2, the bit-plane pack of
  :mod:`..ops.bitpack` (``codecs=["bitpack"]``).

The host side of the codec is numpy, zlib and the native coders
(:mod:`..ops.native`).  Tensors cross this module only in the fast
codecs, whose ``device`` argument (default ``cuda``) says where their
kernels run: X1 and K6 on write, K7 on read.

``.hgi`` byte layout (bincode 1.0 defaults: fixed-width little-endian
ints, u32 enum tags, u64 length prefixes):

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

``.thgi`` byte layout: u32 LE magic 0x7B61_A555, the 24 bytes of
metadata above, u8 layout tag, u8 codec tag, u64 LE raw payload size,
then the coded payload.

``.thgit`` holds a plane cut into tiles, each tile a standalone ``.hgi``
or ``.thgi`` block in row-major tile order (:func:`thgit2_header`,
:func:`thgit2_block_frame`, :func:`parse_thgit`, and
:func:`thgit2_resume_point` for a job that resumes one).  The color container
``.thgic`` is :mod:`.color`'s; :func:`read_archive` refuses it, and a
``.thgit``, by their magic, as the JAX reader does.
"""

from __future__ import annotations

import collections
import dataclasses
import struct
import threading
import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from ..dyadic import cdiv, effective_levels, subband_shapes
from ..ops import bitpack, ctxcoder, native, tpurans
from ..ops.entropy import rans_decode, rans_encode
from ..ops.predictors import Interpolation
from ..ops.quantizers import QuantizationLevel
from .profiling import carry, span

__all__ = [
    "HGI_MAGIC",
    "THGI_MAGIC",
    "Interpolation",
    "Metadata",
    "Archive",
    "write_hgi",
    "read_hgi",
    "write_thgi",
    "RACE_WINS",
    "read_thgi",
    "read_thgi_payload",
    "read_thgi_subbands",
    "read_thgi_preview",
    "read_preview",
    "frame_rans_tpu",
    "is_subband_thgi",
    "subband_shapes",
    "split_grid_np",
    "assemble_grid_np",
    "write_archive",
    "read_archive",
    "THGIT_MAGIC",
    "THGIT2_MAGIC",
    "thgit2_header",
    "thgit2_block_frame",
    "thgit2_resume_point",
    "parse_thgit",
]

HGI_MAGIC = 0xBAAD_A555  # archive.rs:13
THGI_MAGIC = 0x7B61_A555  # native container of the JAX package

# Decompression-bomb guard: the largest single plane a hostile header may
# declare (1 GPix ~= 1 GB of pixels).
MAX_PLANE_PIXELS = 1 << 30

_METADATA = struct.Struct("<IIIIQ")  # qlevel, interp, width, height, scale


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


# -- .thgi: layouts x entropy codecs, smallest wins ---------------------------

_CODEC_DEFLATE = 0
_CODEC_RANS = 1
_CODEC_BITPACK = 2  # device bit-plane pack (fast mode)
_CODEC_RANS_MT = 3  # two independent rANS chunks, coded in parallel
_CODEC_CTX = 4  # context-adaptive binary range coder (subband layout only)
_CODEC_RANS_SHARED = 5  # rANS against an external shared freq table
_CODEC_CTX_MT = 6  # chunk-parallel ctx coder (subband layout only)
_CODEC_RANS_TPU = 7  # device lane-parallel rANS (fast mode)
_FAST_CODECS = (_CODEC_BITPACK, _CODEC_RANS_TPU)

_RANS_TABLE_BYTES = 512  # u16 LE freq[256] prefix of every rANS stream

_LAYOUT_ROWMAJOR = 0
_LAYOUT_SUBBAND = 1


def _check_freqs(freqs) -> np.ndarray:
    """Validate and canonicalize a shared rANS table (u16[256], sum 2**14)."""
    table = np.ascontiguousarray(freqs, dtype=np.uint16)
    if table.shape != (256,) or int(table.sum()) != 1 << 14:
        raise ValueError("shared freq table must be u16[256] summing to 2**14")
    return table


def _canvas(h: int, w: int, levels: int):
    step = 1 << levels
    return np.zeros((cdiv(h, step) * step, cdiv(w, step) * step), dtype=np.uint8)


def split_grid_np(grid: np.ndarray, levels: int):
    """Row-major residual grid -> ``(anchors, subbands)`` on the host.

    The order of the JAX ``encode_subbands``: anchors, then per level
    (coarsest first) the (q01, q10, q11) quads, in canvas shapes.  The
    canvas padding holds 0 here, where ``encode_subbands`` holds the
    padding residuals; the container writes this form.
    """
    h, w = grid.shape
    levels = effective_levels(levels, h, w)
    step = 1 << levels
    canvas = _canvas(h, w, levels)
    canvas[:h, :w] = grid
    anchors = canvas[::step, ::step].copy()
    subbands = []
    for level in range(levels):
        s1 = 1 << (levels - level - 1)
        q01 = canvas[0 :: 2 * s1, s1 :: 2 * s1].copy()
        q10 = canvas[s1 :: 2 * s1, 0 :: 2 * s1].copy()
        q11 = canvas[s1 :: 2 * s1, s1 :: 2 * s1].copy()
        subbands.append((q01, q10, q11))
    return anchors, subbands


def assemble_grid_np(
    anchors: np.ndarray, subbands, height: int, width: int, levels: int
) -> np.ndarray:
    """Inverse of :func:`split_grid_np` (crops the canvas padding)."""
    levels = effective_levels(levels, height, width)
    step = 1 << levels
    canvas = _canvas(height, width, levels)
    canvas[::step, ::step] = anchors
    for level, (q01, q10, q11) in enumerate(subbands):
        s1 = 1 << (levels - level - 1)
        canvas[0 :: 2 * s1, s1 :: 2 * s1] = q01
        canvas[s1 :: 2 * s1, 0 :: 2 * s1] = q10
        canvas[s1 :: 2 * s1, s1 :: 2 * s1] = q11
    return canvas[:height, :width].copy()


def _subband_payload(archive: Archive) -> bytes:
    anchors, subbands = split_grid_np(archive.grid, archive.metadata.scale_level)
    parts = [anchors.tobytes()]
    for quads in subbands:
        parts.extend(q.tobytes() for q in quads)
    return b"".join(parts)


_MT_THRESHOLD = 1 << 20  # two-chunk rANS from 1 MB of payload up
_POOLS_LOCK = threading.Lock()
_MT_POOL = None
_CANDIDATE_POOL = None


def _candidate_pool() -> ThreadPoolExecutor:
    # Races write_thgi's candidates.  Distinct from the rANS-MT chunk pool,
    # so that a candidate using that pool cannot deadlock it.
    global _CANDIDATE_POOL
    with _POOLS_LOCK:
        if _CANDIDATE_POOL is None:
            _CANDIDATE_POOL = ThreadPoolExecutor(4, thread_name_prefix="thgi")
        return _CANDIDATE_POOL


def _mt_pool() -> ThreadPoolExecutor:
    # Persistent: the native coder's output buffers are per thread, so
    # fresh threads would page-fault multi-MB buffers on every call.
    global _MT_POOL
    with _POOLS_LOCK:
        if _MT_POOL is None:
            _MT_POOL = ThreadPoolExecutor(2, thread_name_prefix="ransmt")
        return _MT_POOL


def _rans_mt_encode(raw: bytes) -> bytes:
    """Two halves, each a self-contained rANS stream, coded on two threads
    (the native coder releases the GIL).  Body: u64 LE length of the first
    stream, then both streams."""
    mid = len(raw) // 2
    view = memoryview(raw)
    a, b = _mt_pool().map(rans_encode, (view[:mid], view[mid:]))
    return struct.pack("<Q", len(a)) + a + b


def _rans_mt_decode(body: bytes, raw_size: int) -> bytes:
    (len_a,) = struct.unpack_from("<Q", body, 0)
    mid = raw_size // 2
    ex = _mt_pool()
    fa = ex.submit(rans_decode, body[8 : 8 + len_a], mid)
    fb = ex.submit(rans_decode, body[8 + len_a :], raw_size - mid)
    return fa.result() + fb.result()


def _entropy_candidate_jobs(raw: bytes, fast=False, allowed=None, freqs=None, device="cuda"):
    """``(codec tag, thunk)`` candidates for one payload, in the JAX
    writer's order.

    The thunks release the GIL (zlib, the native coders through ctypes,
    the device), so the writer races them on a pool; one that raises
    ValueError or RuntimeError only drops its candidate.  DEFLATE's two
    strategies are two jobs.  ``fast`` gives the one device-coded job on
    ``device``: the device rANS, or the bit-plane pack when ``allowed``
    names bitpack and not rans_tpu.
    """

    def keep(tag):
        return allowed is None or tag in allowed

    jobs = []
    if fast:
        if keep(_CODEC_RANS_TPU):
            jobs.append((_CODEC_RANS_TPU, lambda: tpurans.encode_bytes(raw, device)))
        elif keep(_CODEC_BITPACK):
            jobs.append((_CODEC_BITPACK,
                         lambda: bitpack.pack_bytes(np.frombuffer(raw, np.uint8), device)))
        return jobs
    if keep(_CODEC_DEFLATE):
        for strategy in (zlib.Z_FILTERED, zlib.Z_DEFAULT_STRATEGY):
            jobs.append((_CODEC_DEFLATE, lambda s=strategy: _deflate_one(raw, s)))
    if len(raw) >= _MT_THRESHOLD:
        if keep(_CODEC_RANS_MT):
            jobs.append((_CODEC_RANS_MT, lambda: _rans_mt_encode(raw)))
    elif keep(_CODEC_RANS):
        jobs.append((_CODEC_RANS, lambda: rans_encode(raw)))
    if freqs is not None and keep(_CODEC_RANS_SHARED):
        # The standard rANS stream with its 512-byte table prefix cut: the
        # table is stored once elsewhere, or given again on read.
        def _rans_shared():
            # A table must cover every byte of the payload: a zero
            # frequency makes the native coder divide by zero, which kills
            # the process instead of dropping the candidate.
            present = np.unique(np.frombuffer(raw, np.uint8))
            if present.size and not np.all(freqs[present] > 0):
                missing = [int(b) for b in present[freqs[present] == 0][:8]]
                raise ValueError(f"shared freq table assigns 0 to payload bytes {missing}")
            return rans_encode(raw, freqs)[_RANS_TABLE_BYTES:]

        jobs.append((_CODEC_RANS_SHARED, _rans_shared))
    return jobs


def _ctx_pieces(meta: Metadata):
    a_shape, q_shapes = subband_shapes(meta.height, meta.width, meta.scale_level)
    return ctxcoder.piece_table(a_shape, q_shapes)


def _ctx_shift(meta: Metadata) -> int:
    # From the metadata, so that decoders recover it: lossy residual
    # statistics drift, and the faster shift 4 codes them smaller;
    # lossless prefers 5.
    return 5 if meta.quantization_level == QuantizationLevel.LOSSLESS else 4


_CODEC_NAMES = {
    "deflate": _CODEC_DEFLATE,
    "rans": _CODEC_RANS,
    "bitpack": _CODEC_BITPACK,
    "rans_mt": _CODEC_RANS_MT,
    "ctx": _CODEC_CTX,
    "rans_shared": _CODEC_RANS_SHARED,
    "ctx_mt": _CODEC_CTX_MT,
    "rans_tpu": _CODEC_RANS_TPU,
}


# The span of a candidate job, by codec tag: coder.<codec name>.
_CODER_SPANS = {tag: f"coder.{name}" for name, tag in _CODEC_NAMES.items()}

# Races won, by (layout tag, codec tag): one count for each write_thgi
# call outside the fast mode.  Clear it to start a count afresh.
RACE_WINS: collections.Counter = collections.Counter()
_WINS_LOCK = threading.Lock()


def _coded(name: str, nbytes: int, fn):
    with span(name, nbytes):
        return fn()


def write_thgi(
    archive: Archive,
    layouts=("rowmajor", "subband"),
    fast: bool = False,
    codecs=None,
    freqs=None,
    device="cuda",
) -> bytes:
    """Serialize to the ``.thgi`` container, the bytes of the JAX writer.

    Every (layout, codec) candidate is coded, and the smallest wins; a
    tie goes to the first in order: row-major jobs, then subband jobs,
    then the ctx coder.  The subband payload is built from the cropped
    grid (:func:`split_grid_np`), so its padding holds 0.  The ctx
    candidate races only where the native coder is present (the Python
    coder would take minutes), unless ``codecs`` asks for it.  Each job
    is the span ``coder.<codec>`` on the pool's thread, a child of the
    caller's open span; outside the fast mode the winner is counted in
    :data:`RACE_WINS`.

    ``codecs`` restricts the candidates to names of ``_CODEC_NAMES``;
    ``freqs`` (u16[256] summing to 2**14, from
    :func:`..ops.entropy.normalized_freqs`) adds the shared-table rANS,
    whose blocks decode only with the same table.

    ``fast=True`` is the device-coded mode: one candidate, the device
    rANS (or, with ``codecs=["bitpack"]``, the bit-plane pack), its
    kernels on ``device``, on the row-major layout alone whenever that is
    among ``layouts``.  ``device`` serves nothing else.
    """
    if freqs is not None:
        freqs = _check_freqs(freqs)
    if fast and "rowmajor" in layouts:
        # Throughput over size: one device pass on one layout, not a race
        # between two layouts coded alike.
        layouts = ("rowmajor",)
    allowed = None
    if codecs is not None:
        try:
            allowed = {_CODEC_NAMES[c] for c in codecs}
        except KeyError as e:
            raise ValueError(
                f"unknown codec {e.args[0]!r}; expected one of {sorted(_CODEC_NAMES)}"
            ) from None

    def keep(tag):
        return allowed is None or tag in allowed

    jobs = []  # (layout, tag, raw_len, thunk)
    if "rowmajor" in layouts:
        raw = archive.grid.tobytes()
        for tag, fn in _entropy_candidate_jobs(raw, fast, allowed, freqs, device):
            jobs.append((_LAYOUT_ROWMAJOR, tag, len(raw), fn))
    if "subband" in layouts and archive.metadata.scale_level > 0:
        with span("thgi.payload") as sp:
            raw = _subband_payload(archive)
            sp.nbytes = len(raw)
        for tag, fn in _entropy_candidate_jobs(raw, fast, allowed, freqs, device):
            jobs.append((_LAYOUT_SUBBAND, tag, len(raw), fn))
        if not fast and (keep(_CODEC_CTX) or keep(_CODEC_CTX_MT)) and (
            allowed is not None or native.available()
        ):
            pieces = _ctx_pieces(archive.metadata)
            shift = _ctx_shift(archive.metadata)
            # Large payloads take the chunk-parallel framing, small ones
            # the single stream, which is smaller; an explicit ctx_mt
            # request is honoured at any size.
            forced_mt = allowed is not None and _CODEC_CTX_MT in allowed
            if keep(_CODEC_CTX_MT) and (forced_mt or ctxcoder.ctx_mt_chunks(len(raw)) > 1):
                jobs.append((_LAYOUT_SUBBAND, _CODEC_CTX_MT, len(raw),
                             lambda: ctxcoder.ctx_encode_mt(raw, pieces, shift)))
            elif keep(_CODEC_CTX):
                jobs.append((_LAYOUT_SUBBAND, _CODEC_CTX, len(raw),
                             lambda: ctxcoder.ctx_encode(raw, pieces, shift)))

    pool, coded = _candidate_pool(), carry(_coded)
    futures = [
        (layout, tag, raw_len, pool.submit(coded, _CODER_SPANS[tag], raw_len, fn))
        for layout, tag, raw_len, fn in jobs
    ]
    candidates = []
    with span("thgi.wait"):
        for layout, tag, raw_len, fut in futures:
            try:
                candidates.append((layout, tag, raw_len, fut.result()))
            except ValueError:
                pass  # this coder cannot take the payload; the others still race
            except RuntimeError:
                if fast:
                    raise  # the device coder failed (a CUDA error): not a refusal
    if not candidates:
        raise ValueError(f"no valid candidates for layouts={layouts!r} codecs={codecs!r}")
    layout, tag, raw_len, body = min(candidates, key=lambda c: len(c[3]))
    if not fast:
        with _WINS_LOCK:
            RACE_WINS[layout, tag] += 1
    return _thgi_frame(archive.metadata, layout, tag, raw_len, body)


def _thgi_frame(meta: Metadata, layout: int, codec: int, raw_size: int, body: bytes) -> bytes:
    """A ``.thgi`` container: header + coded body."""
    return b"".join((
        struct.pack("<I", THGI_MAGIC),
        meta.pack(),
        struct.pack("<BBQ", layout, codec, raw_size),
        body,
    ))


def frame_rans_tpu(meta: Metadata, payloads) -> list:
    """The fast ``.thgi`` of each device-rANS payload of ``meta``'s plane
    (codec 7, row-major layout): what ``HGICodec.write_fast_batch``
    returns."""
    n = meta.width * meta.height
    return [_thgi_frame(meta, _LAYOUT_ROWMAJOR, _CODEC_RANS_TPU, n, p) for p in payloads]


def _expected_raw_size(meta: Metadata, layout: int) -> int:
    """The payload size a layout implies for a metadata: the bomb guard of
    every decoder, since the declared size must equal it before any
    decode allocates."""
    if layout == _LAYOUT_ROWMAJOR:
        return meta.width * meta.height
    if layout == _LAYOUT_SUBBAND:
        a_shape, q_shapes = subband_shapes(meta.height, meta.width, meta.scale_level)
        return a_shape[0] * a_shape[1] + 3 * sum(h * w for h, w in q_shapes)
    raise ValueError(f"unknown layout tag {layout}")


_THGI_HEAD = struct.Struct("<BBQ")  # layout, codec, raw size


def _parse_thgi_header(data: bytes):
    """A ``.thgi`` header -> ``(metadata, layout, codec tag, raw_size, body)``,
    the declared size checked against the layout's."""
    if _magic(data) != THGI_MAGIC:
        raise ValueError("incorrect magic number")
    off = 4
    meta = Metadata.unpack(data[off : off + _METADATA.size])
    off += _METADATA.size
    if len(data) < off + _THGI_HEAD.size:
        raise ValueError("truncated archive")
    layout, tag, raw_size = _THGI_HEAD.unpack_from(data, off)
    off += _THGI_HEAD.size
    if raw_size != _expected_raw_size(meta, layout):
        raise ValueError(f"declared payload size {raw_size} does not match layout")
    return meta, layout, tag, raw_size, data[off:]


def _shared_rans_decode(body: bytes, raw_size: int, freqs) -> bytes:
    """Decode a table-cut shared-rANS stream by putting the table back."""
    if freqs is None:
        raise ValueError("archive uses a shared coder table; pass freqs= (u16[256])")
    return rans_decode(_check_freqs(freqs).tobytes() + body, raw_size)


def read_thgi_payload(data: bytes, freqs=None, device="cuda"):
    """A ``.thgi`` container -> ``(metadata, layout, raw_payload, raw_size)``.

    ``raw_payload`` is the decoded byte stream; ``freqs`` is the shared
    table of blocks written with ``write_thgi(..., freqs=...)``.  Codec 2
    unpacks with K7 on ``device``, which serves nothing else; every other
    codec, codec 7 included, decodes on the host.
    """
    meta, layout, tag, raw_size, body = _parse_thgi_header(data)
    if tag == _CODEC_DEFLATE:
        raw = _inflate_raw(body, max_size=raw_size)
    elif tag == _CODEC_RANS:
        raw = rans_decode(body, raw_size)
    elif tag == _CODEC_RANS_SHARED:
        raw = _shared_rans_decode(body, raw_size, freqs)
    elif tag == _CODEC_RANS_MT:
        raw = _rans_mt_decode(body, raw_size)
    elif tag == _CODEC_BITPACK:
        raw = bitpack.unpack_bytes(body, expected_n=raw_size, device=device).tobytes()
    elif tag == _CODEC_RANS_TPU:
        raw = tpurans.decode_bytes(body, expected_n=raw_size).tobytes()
    elif tag in (_CODEC_CTX, _CODEC_CTX_MT):
        if layout != _LAYOUT_SUBBAND:
            raise ValueError("ctx codec requires the subband layout")
        decode = ctxcoder.ctx_decode if tag == _CODEC_CTX else ctxcoder.ctx_decode_mt
        raw = decode(body, _ctx_pieces(meta), _ctx_shift(meta))
    else:
        raise ValueError(f"unknown entropy codec tag {tag}")
    if len(raw) < raw_size:
        raise ValueError("truncated payload")
    return meta, layout, raw, raw_size


def _slice_subbands(meta: Metadata, raw: bytes, raw_size: int, upto=None):
    """Slice a subband payload into ``(anchors, subbands[:upto])``.

    ``upto=None`` takes every level and checks the full size; an explicit
    ``upto`` slices the prefix a preview needs.
    """
    a_shape, q_shapes = subband_shapes(meta.height, meta.width, meta.scale_level)
    if upto is None:
        expected = a_shape[0] * a_shape[1] + 3 * sum(h * w for h, w in q_shapes)
        if raw_size != expected:
            raise ValueError(f"subband payload size {raw_size} != expected {expected}")
        upto = len(q_shapes)
    pos = 0

    def take(shape):
        nonlocal pos
        n = shape[0] * shape[1]
        arr = np.frombuffer(raw, np.uint8, count=n, offset=pos).reshape(shape)
        pos += n
        return arr

    anchors = take(a_shape)
    subbands = [tuple(take(s) for _ in range(3)) for s in q_shapes[:upto]]
    return anchors, subbands


def read_thgi_subbands(data: bytes, freqs=None, device="cuda"):
    """A subband-layout ``.thgi`` -> ``(metadata, anchors, subbands)``.

    The arrays (read-only views of the payload) feed
    ``HGICodec.decode_subbands`` directly.  Raises ValueError for a
    row-major archive; callers then take :func:`read_thgi`.  ``device``
    as for :func:`read_thgi_payload`.
    """
    meta, layout, raw, raw_size = read_thgi_payload(data, freqs, device)
    if layout != _LAYOUT_SUBBAND:
        raise ValueError("archive is not in subband layout")
    anchors, subbands = _slice_subbands(meta, raw, raw_size)
    return meta, anchors, subbands


def is_subband_thgi(data: bytes) -> bool:
    """Whether ``data`` is a subband-layout ``.thgi``, from its header
    alone (checked as the readers check it); no payload is decoded."""
    return _magic(data) == THGI_MAGIC and _parse_thgi_header(data)[1] == _LAYOUT_SUBBAND


def read_thgi_preview(data: bytes, upto: int, freqs=None, device="cuda"):
    """Decode only the payload prefix that a level-``upto`` preview needs.

    Returns ``(metadata, anchors, subbands_prefix, upto)``, ``upto``
    clamped to the archive's effective depth.  The host coders of the
    subband layout decode front to back, so only the prefix is decoded; a
    row-major archive, and one of the fast codecs (which have no such
    prefix), is decoded whole and split.  ``device`` as for
    :func:`read_thgi_payload`.
    """
    meta, layout, tag, raw_size, body = _parse_thgi_header(data)
    a_shape, q_shapes = subband_shapes(meta.height, meta.width, meta.scale_level)
    upto = max(0, min(int(upto), len(q_shapes)))
    need = a_shape[0] * a_shape[1] + 3 * sum(h * w for h, w in q_shapes[:upto])

    if layout != _LAYOUT_SUBBAND or tag in _FAST_CODECS:
        archive = read_thgi(data, freqs, device)
        anchors, subbands = split_grid_np(archive.grid, meta.scale_level)
        return meta, anchors, subbands[:upto], upto

    if tag == _CODEC_DEFLATE:
        raw = zlib.decompressobj(-15).decompress(body, need)
    elif tag == _CODEC_RANS:
        raw = rans_decode(body, need)
    elif tag == _CODEC_RANS_SHARED:
        raw = _shared_rans_decode(body, need, freqs)
    elif tag == _CODEC_RANS_MT:
        (len_a,) = struct.unpack_from("<Q", body, 0)
        mid = raw_size // 2
        raw = rans_decode(body[8 : 8 + len_a], min(need, mid))
        if need > mid:
            raw += rans_decode(body[8 + len_a :], need - mid)
    elif tag == _CODEC_CTX:
        pieces = _ctx_pieces(meta)[: 1 + 3 * upto]
        raw = ctxcoder.ctx_decode(body, pieces, _ctx_shift(meta))
    elif tag == _CODEC_CTX_MT:
        # The chunk split derives from the full piece table; only the
        # chunks that cover the prefix are decoded.
        raw = ctxcoder.ctx_decode_mt(body, _ctx_pieces(meta), _ctx_shift(meta), upto_bytes=need)
    else:
        raise ValueError(f"unknown entropy codec tag {tag}")
    if len(raw) < need:
        raise ValueError("truncated payload")
    anchors, subbands = _slice_subbands(meta, raw, need, upto=upto)
    return meta, anchors, subbands, upto


def read_preview(data: bytes, upto: int, freqs=None, device="cuda"):
    """:func:`read_thgi_preview` for a ``.thgi``; a ``.hgi`` is read whole
    and split on the host.  Returns ``(metadata, anchors, subbands_prefix,
    upto)``."""
    if _magic(data) == THGI_MAGIC:
        return read_thgi_preview(data, upto, freqs, device)
    archive = read_hgi(data)
    meta = archive.metadata
    anchors, subbands = split_grid_np(archive.grid, meta.scale_level)
    upto = max(0, min(int(upto), len(subbands)))
    return meta, anchors, subbands[:upto], upto


def read_thgi(data: bytes, freqs=None, device="cuda") -> Archive:
    """Parse a ``.thgi`` container of either layout into an :class:`Archive`
    (``device`` as for :func:`read_thgi_payload`)."""
    meta, layout, raw, raw_size = read_thgi_payload(data, freqs, device)
    if layout == _LAYOUT_ROWMAJOR:
        if raw_size != meta.width * meta.height:
            raise ValueError("payload size does not match dimensions")
        grid = np.frombuffer(raw, dtype=np.uint8, count=raw_size)
        return Archive(meta, grid.reshape(meta.height, meta.width).copy())
    if layout == _LAYOUT_SUBBAND:
        anchors, subbands = _slice_subbands(meta, raw, raw_size)
        return Archive(
            meta, assemble_grid_np(anchors, subbands, meta.height, meta.width, meta.scale_level)
        )
    raise ValueError(f"unknown layout tag {layout}")


def write_archive(archive: Archive, fmt: str = "hgi", freqs=None) -> bytes:
    if fmt == "hgi":
        if freqs is not None:
            raise ValueError(".hgi is the fixed reference layout; shared tables need fmt='thgi'")
        return write_hgi(archive)
    if fmt == "thgi":
        return write_thgi(archive, freqs=freqs)
    raise ValueError(f"unknown container format {fmt!r}")


def read_archive(data: bytes, freqs=None, device="cuda") -> Archive:
    """Auto-detect the container format from the magic (``device`` as for
    :func:`read_thgi_payload`)."""
    magic = _magic(data)
    if magic == HGI_MAGIC:
        return read_hgi(data)
    if magic == THGI_MAGIC:
        return read_thgi(data, freqs, device)
    raise ValueError("incorrect magic number")


# -- .thgit: a plane as independent tile blocks --------------------------------

THGIT_MAGIC = 0x7161_A555  # v1: u64 length a block, no CRC, no shared table
THGIT2_MAGIC = 0x7161_A556  # v2: u8 flags [+ table], u64 length + u32 CRC a block

_THGIT2_FLAG_TABLE = 1
_THGIT2_HEAD = struct.Struct("<IIIIIB")  # magic, tile, width, height, blocks, flags
_THGIT2_FRAME = struct.Struct("<QI")  # block length, crc32


def thgit2_header(tile: int, width: int, height: int, n_blocks: int, freqs=None) -> bytes:
    """A ``.thgit`` v2 header.

    u32 LE magic, tile, width, height and block count, u8 flags (bit 0: a
    shared rANS table follows), then the u16 LE table[256] when flagged.
    Blocks follow as :func:`thgit2_block_frame` frames in row-major tile
    order.
    """
    flags, table = 0, b""
    if freqs is not None:
        flags |= _THGIT2_FLAG_TABLE
        table = _check_freqs(freqs).tobytes()
    return _THGIT2_HEAD.pack(THGIT2_MAGIC, tile, width, height, n_blocks, flags) + table


def thgit2_block_frame(block: bytes) -> bytes:
    """One tile block: u64 LE length, u32 LE CRC32 of the block, the block."""
    return _THGIT2_FRAME.pack(len(block), zlib.crc32(block)) + block


def thgit2_resume_point(data: bytes, tile: int, width: int, height: int):
    """Where a job resumes an existing ``.thgit``: ``(complete blocks, byte
    offset after them, shared table)``.

    Only a v2 file whose header names the job's ``(tile, width, height)``
    resumes; its first partial or CRC-bad block ends the prefix.  A v1
    file (no CRC framing to append to) or another job's file gives None:
    the job starts from scratch.
    """
    if len(data) < _THGIT2_HEAD.size:
        return None
    magic, t, w, h, n, flags = _THGIT2_HEAD.unpack_from(data, 0)
    if magic != THGIT2_MAGIC or (t, w, h) != (tile, width, height):
        return None
    freqs = None
    off = _THGIT2_HEAD.size
    if flags & _THGIT2_FLAG_TABLE:
        if len(data) < off + _RANS_TABLE_BYTES:
            return None
        freqs = np.frombuffer(data, dtype="<u2", count=256, offset=off).copy()
        off += _RANS_TABLE_BYTES
    k = 0
    while k < n and off + _THGIT2_FRAME.size <= len(data):
        blen, crc = _THGIT2_FRAME.unpack_from(data, off)
        body = off + _THGIT2_FRAME.size
        if body + blen > len(data) or zlib.crc32(data[body : body + blen]) != crc:
            break  # a partial or corrupt block: rewrite from here
        off = body + blen
        k += 1
    return k, off, freqs


def parse_thgit(data: bytes):
    """A ``.thgit`` (v1 or v2) -> ``(tile, width, height, blocks, freqs)``.

    ``blocks`` are the tile archives in row-major order and ``freqs`` the
    shared rANS table (None without one).  Each v2 block's CRC is checked;
    a mismatch raises ValueError naming the block.
    """
    if len(data) < 20:
        raise ValueError("truncated tiled archive")
    magic, tile, width, height, n = struct.unpack_from("<IIIII", data, 0)
    freqs = None
    if magic == THGIT_MAGIC:
        off, v2 = 20, False
    elif magic == THGIT2_MAGIC:
        if len(data) < _THGIT2_HEAD.size:
            raise ValueError("truncated tiled archive")
        flags = data[20]
        off, v2 = _THGIT2_HEAD.size, True
        if flags & _THGIT2_FLAG_TABLE:
            if len(data) < off + _RANS_TABLE_BYTES:
                raise ValueError("truncated shared table")
            freqs = np.frombuffer(data, dtype="<u2", count=256, offset=off).copy()
            off += _RANS_TABLE_BYTES
    else:
        raise ValueError("incorrect magic number")
    if tile == 0:
        raise ValueError("implausible tiled header (zero tile size)")
    hdr = _THGIT2_FRAME.size if v2 else 8
    blocks = []
    for i in range(n):
        if off + hdr > len(data):
            raise ValueError(f"truncated at block {i}/{n}")
        if v2:
            blen, crc = _THGIT2_FRAME.unpack_from(data, off)
        else:
            (blen,) = struct.unpack_from("<Q", data, off)
            crc = None
        off += hdr
        if blen > len(data) - off:
            raise ValueError(f"truncated at block {i}/{n}")
        block = data[off : off + blen]
        off += blen
        if crc is not None and zlib.crc32(block) != crc:
            raise ValueError(f"CRC mismatch in block {i}/{n}")
        blocks.append(block)
    return tile, width, height, blocks, freqs
