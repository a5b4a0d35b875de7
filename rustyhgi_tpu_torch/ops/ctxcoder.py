"""Context-adaptive binary range coder for subband residual payloads.

Counterpart of ``rustyhgi_tpu/ops/ctxcoder.py``; this module is the
specification of codecs 4 (``ctx``) and 6 (``ctx_mt``) of the ``.thgi``
container, and ``native/ctx_coder.cpp`` (through :mod:`.native`) its
bit-identical production twin.

* **zigzag remap**: mod-256 residuals cluster near 0 and 255; zigzag
  folds them to small magnitudes;
* **bit-tree coding**: each zigzag byte is 8 binary decisions down an
  adaptive 255-node probability tree (12-bit probabilities, no tables
  sent).  The adaptation shift comes from the archive's metadata: 4 for
  the lossy presets, 5 for lossless;
* **2D activity contexts**: a byte's tree is picked by (pyramid-level
  group, activity bucket), activity = zigzag(left) + zigzag(up) within
  the same subband piece;
* **anchor delta coding**: the anchors piece holds raw pixels and is
  coded as left-neighbour deltas (up-neighbour in column 0), group 0.

The range coder is the carryless Subbotin-style one: 32-bit ``low``,
``range`` and ``code``; when the top byte of ``low`` and ``low + range``
disagree and ``range`` is below 2**16, ``range`` is cut to the next 2**16
boundary so the byte can ship.

Piece order and shapes follow the container's subband payload: anchors,
then per level (coarsest first) the (q01, q10, q11) quads; the shapes
derive from the archive's metadata, so the stream needs no framing.
"""

from __future__ import annotations

import threading
from typing import List, Optional, Sequence, Tuple

import numpy as np

__all__ = [
    "piece_table",
    "py_ctx_encode",
    "py_ctx_decode",
    "ctx_encode",
    "ctx_decode",
    "ctx_encode_mt",
    "ctx_decode_mt",
    "ctx_mt_chunks",
    "split_pieces",
]

_PROB_BITS = 12
_PROB_INIT = 1 << (_PROB_BITS - 1)  # 2048
_ADAPT_SHIFT = 5  # default; lossy archives use 4 (utils/container.py)
_TOP = 1 << 24
_N_GROUPS = 5  # anchors + 4 level groups (deep levels clamp to the last)
_N_ACT = 5  # activity buckets
_ACT_THRESHOLDS = (1, 3, 8, 20)


def piece_table(
    anchor_shape: Tuple[int, int], quad_shapes: Sequence[Tuple[int, int]]
) -> List[Tuple[int, int, int]]:
    """(h, w, group) rows for every piece of a subband payload.

    Group 0 is the anchors piece (delta-coded); quads of level ``l``
    (coarsest first) share group ``min(l + 1, 4)``.
    """
    rows = [(anchor_shape[0], anchor_shape[1], 0)]
    for level, (h, w) in enumerate(quad_shapes):
        g = min(level + 1, _N_GROUPS - 1)
        rows.extend([(h, w, g)] * 3)
    return rows


def _act_bucket(act: int) -> int:
    if act < _ACT_THRESHOLDS[0]:
        return 0
    if act < _ACT_THRESHOLDS[1]:
        return 1
    if act < _ACT_THRESHOLDS[2]:
        return 2
    if act < _ACT_THRESHOLDS[3]:
        return 3
    return 4


def _zigzag(v: int) -> int:
    return v * 2 if v < 128 else (256 - v) * 2 - 1


def _unzigzag(z: int) -> int:
    return z >> 1 if (z & 1) == 0 else (256 - ((z + 1) >> 1)) & 255


_MASK = 0xFFFFFFFF
_BOT = 1 << 16


class _Encoder:
    """Carryless binary range encoder (Subbotin-style, 32-bit)."""

    def __init__(self, adapt_shift: int = _ADAPT_SHIFT) -> None:
        self.low = 0
        self.range = _MASK
        self.shift = adapt_shift
        self.out = bytearray()

    def _renorm(self) -> None:
        while True:
            if (self.low ^ (self.low + self.range)) < _TOP:
                pass  # top byte settled; ship it
            elif self.range < _BOT:
                # top byte disputed but range too small to wait: truncate
                # range to the next 2**16 boundary (never zero here — an
                # aligned low would have settled the top byte above).
                self.range = (-self.low) & (_BOT - 1)
            else:
                return
            self.out.append((self.low >> 24) & 0xFF)
            self.low = (self.low << 8) & _MASK
            self.range = self.range << 8

    def encode(self, probs: np.ndarray, idx: int, bit: int) -> None:
        p = int(probs[idx])
        bound = (self.range >> _PROB_BITS) * p
        if bit == 0:
            self.range = bound
            probs[idx] = p + (((1 << _PROB_BITS) - p) >> self.shift)
        else:
            self.low = (self.low + bound) & _MASK
            self.range -= bound
            probs[idx] = p - (p >> self.shift)
        self._renorm()

    def flush(self) -> bytes:
        for _ in range(4):
            self.out.append((self.low >> 24) & 0xFF)
            self.low = (self.low << 8) & _MASK
        return bytes(self.out)


class _Decoder:
    def __init__(self, data: bytes, adapt_shift: int = _ADAPT_SHIFT) -> None:
        self.data = data
        self.pos = 0
        self.low = 0
        self.range = _MASK
        self.shift = adapt_shift
        self.code = 0
        for _ in range(4):
            self.code = (self.code << 8) | self._byte()

    def _byte(self) -> int:
        b = self.data[self.pos] if self.pos < len(self.data) else 0
        self.pos += 1
        return b

    def _renorm(self) -> None:
        while True:
            if (self.low ^ (self.low + self.range)) < _TOP:
                pass
            elif self.range < _BOT:
                self.range = (-self.low) & (_BOT - 1)
            else:
                return
            self.code = ((self.code << 8) | self._byte()) & _MASK
            self.low = (self.low << 8) & _MASK
            self.range = self.range << 8

    def decode(self, probs: np.ndarray, idx: int) -> int:
        p = int(probs[idx])
        bound = (self.range >> _PROB_BITS) * p
        if ((self.code - self.low) & _MASK) < bound:
            bit = 0
            self.range = bound
            probs[idx] = p + (((1 << _PROB_BITS) - p) >> self.shift)
        else:
            bit = 1
            self.low = (self.low + bound) & _MASK
            self.range -= bound
            probs[idx] = p - (p >> self.shift)
        self._renorm()
        return bit


def _new_models() -> np.ndarray:
    return np.full(
        (_N_GROUPS * _N_ACT, 256), _PROB_INIT, dtype=np.int32
    )


def _tree_encode(enc: _Encoder, model: np.ndarray, z: int) -> None:
    node = 1
    for k in range(7, -1, -1):
        bit = (z >> k) & 1
        enc.encode(model, node, bit)
        node = (node << 1) | bit


def _tree_decode(dec: _Decoder, model: np.ndarray) -> int:
    node = 1
    for _ in range(8):
        node = (node << 1) | dec.decode(model, node)
    return node & 0xFF


def py_ctx_encode(
    payload: bytes,
    pieces: Sequence[Tuple[int, int, int]],
    adapt_shift: int = _ADAPT_SHIFT,
) -> bytes:
    """Encode a concatenated subband payload (pure-Python specification)."""
    models = _new_models()
    enc = _Encoder(adapt_shift)
    src = np.frombuffer(payload, dtype=np.uint8)
    pos = 0
    for h, w, group in pieces:
        plane = src[pos : pos + h * w].reshape(h, w)
        pos += h * w
        prev_z = [0] * w
        for y in range(h):
            left_z = 0
            for x in range(w):
                v = int(plane[y, x])
                if group == 0:
                    pred = (
                        int(plane[y, x - 1])
                        if x
                        else (int(plane[y - 1, x]) if y else 128)
                    )
                    sym = (v - pred) & 255
                else:
                    sym = v
                z = _zigzag(sym)
                ctx = group * _N_ACT + _act_bucket(left_z + prev_z[x])
                _tree_encode(enc, models[ctx], z)
                prev_z[x] = z
                left_z = z
    if pos != len(src):
        raise ValueError("piece table does not cover the payload")
    return enc.flush()


def py_ctx_decode(
    data: bytes,
    pieces: Sequence[Tuple[int, int, int]],
    adapt_shift: int = _ADAPT_SHIFT,
) -> bytes:
    """Decode back to the concatenated subband payload."""
    models = _new_models()
    dec = _Decoder(data, adapt_shift)
    total = sum(h * w for h, w, _ in pieces)
    out = np.empty(total, dtype=np.uint8)
    pos = 0
    for h, w, group in pieces:
        plane = out[pos : pos + h * w].reshape(h, w)
        pos += h * w
        prev_z = [0] * w
        for y in range(h):
            left_z = 0
            for x in range(w):
                ctx = group * _N_ACT + _act_bucket(left_z + prev_z[x])
                z = _tree_decode(dec, models[ctx])
                sym = _unzigzag(z)
                if group == 0:
                    pred = (
                        int(plane[y, x - 1])
                        if x
                        else (int(plane[y - 1, x]) if y else 128)
                    )
                    plane[y, x] = (pred + sym) & 255
                else:
                    plane[y, x] = sym
                prev_z[x] = z
                left_z = z
    return out.tobytes()


def ctx_encode(
    payload: bytes,
    pieces: Sequence[Tuple[int, int, int]],
    adapt_shift: int = _ADAPT_SHIFT,
) -> bytes:
    """Context-coder encode; the native coder when it is there (a native
    failure falls back to the Python coder, as in the JAX package)."""
    from .native import available, native_ctx_compress

    if available():
        try:
            return native_ctx_compress(payload, pieces, adapt_shift)
        except (RuntimeError, ValueError):
            pass
    return py_ctx_encode(payload, pieces, adapt_shift)


def ctx_decode(
    data: bytes,
    pieces: Sequence[Tuple[int, int, int]],
    adapt_shift: int = _ADAPT_SHIFT,
) -> bytes:
    """Context-coder decode; the native coder when it is there."""
    from .native import available, native_ctx_decompress

    if available():
        try:
            return native_ctx_decompress(data, pieces, adapt_shift)
        except (RuntimeError, ValueError):
            pass
    return py_ctx_decode(data, pieces, adapt_shift)


# -- parallel (chunked) framing ---------------------------------------------
#
# The coder is inherently serial within a stream (every bit's context
# depends on all prior adaptation), so throughput scales by splitting the
# payload into K independent chunks coded on threads (the native coder
# releases the GIL through ctypes).  Chunk boundaries snap to row
# boundaries inside residual pieces — a row slice of a (h, w, group!=0)
# piece codes exactly like a standalone (rows, w, group) piece, because
# values are coded verbatim and only the activity contexts (prev_z) carry
# across rows.  The anchors piece (group 0) is atomic: its delta coding
# reads the previous ROW's decoded values, which another chunk's thread
# would not have produced yet.  Each chunk restarts the probability
# models, costing ~0.3-1% size on the reference images.
#
# Stream layout: u8 K, u32 LE chunk_len[K], chunk streams back to back.
# The split is a pure function of (pieces, K), so decoders recompute it.

_CTX_MT_MAX_CHUNKS = 8
_CTX_MT_CHUNK_BYTES = 1 << 20  # ~1 MB per chunk target


def ctx_mt_chunks(total_bytes: int) -> int:
    """Deterministic chunk count for a payload size (1 = use plain ctx).

    Rounded, not floored, division: a 1080p plane (2,073,600 B) gets 2
    chunks instead of falling just under a power-of-two threshold.
    """
    k = (total_bytes + _CTX_MT_CHUNK_BYTES // 2) // _CTX_MT_CHUNK_BYTES
    return max(1, min(_CTX_MT_MAX_CHUNKS, k))


_CTX_POOL = None
_CTX_POOL_LOCK = threading.Lock()


def _ctx_pool():
    """Shared persistent thread pool for the chunk-parallel coders.

    Persistent, because the native coder's output buffers are per thread
    (:func:`.native._out_buffer`): fresh threads would allocate and
    page-fault them again on every call.
    """
    global _CTX_POOL
    with _CTX_POOL_LOCK:
        if _CTX_POOL is None:
            from concurrent.futures import ThreadPoolExecutor

            _CTX_POOL = ThreadPoolExecutor(
                max_workers=8, thread_name_prefix="ctxmt"
            )
        return _CTX_POOL


def split_pieces(
    pieces: Sequence[Tuple[int, int, int]], k: int
) -> List[Tuple[int, List[Tuple[int, int, int]]]]:
    """Split a piece table into K contiguous payload spans.

    Returns ``[(byte_offset, sub_pieces), ...]`` of length K (some spans
    may be empty when the payload is small).  Cut points are piece starts
    and, within group!=0 pieces, row starts; each target offset
    ``round(total*j/K)`` snaps to the next allowed cut.  Pure function of
    (pieces, k) — encoder and decoder derive identical splits.
    """
    total = sum(h * w for h, w, _ in pieces)
    cuts = [0]
    for j in range(1, k):
        target = total * j // k
        # walk pieces to find the smallest allowed cut >= max(target, prev+0)
        target = max(target, cuts[-1])
        pos = 0
        chosen = total
        for h, w, g in pieces:
            size = h * w
            if pos >= target:
                chosen = pos
                break
            if pos + size > target and g != 0 and w > 0:
                # inside this piece: snap up to a row boundary
                row = -(-(target - pos) // w)
                chosen = min(pos + row * w, pos + size)
                break
            pos += size
        cuts.append(min(chosen, total))
    cuts.append(total)

    spans: List[Tuple[int, List[Tuple[int, int, int]]]] = []
    for j in range(k):
        lo, hi = cuts[j], cuts[j + 1]
        sub: List[Tuple[int, int, int]] = []
        pos = 0
        for h, w, g in pieces:
            size = h * w
            s, e = max(lo, pos), min(hi, pos + size)
            if e > s:
                assert w == 0 or ((s - pos) % w == 0 and (e - pos) % w == 0)
                rows = (e - s) // w if w else 0
                sub.append((rows, w, g))
            pos += size
        spans.append((lo, sub))
    return spans


def ctx_encode_mt(
    payload: bytes,
    pieces: Sequence[Tuple[int, int, int]],
    adapt_shift: int = _ADAPT_SHIFT,
    k: Optional[int] = None,
) -> bytes:
    """Chunk-parallel context encode (see module framing notes)."""
    import struct

    if k is None:
        k = ctx_mt_chunks(len(payload))
    k = max(1, min(_CTX_MT_MAX_CHUNKS, int(k)))
    spans = split_pieces(pieces, k)
    sizes = [sum(h * w for h, w, _ in sub) for _, sub in spans]

    def job(args):
        lo, sub, size = args
        return ctx_encode(payload[lo : lo + size], sub, adapt_shift)

    jobs = [(lo, sub, size) for (lo, sub), size in zip(spans, sizes)]
    if len(jobs) > 1:
        chunks = list(_ctx_pool().map(job, jobs))
    else:
        chunks = [job(jobs[0])]
    head = struct.pack("<B", k) + b"".join(
        struct.pack("<I", len(c)) for c in chunks
    )
    return head + b"".join(chunks)


def ctx_decode_mt(
    data: bytes,
    pieces: Sequence[Tuple[int, int, int]],
    adapt_shift: int = _ADAPT_SHIFT,
    upto_bytes: Optional[int] = None,
) -> bytes:
    """Chunk-parallel context decode.

    ``upto_bytes`` decodes only the chunks covering the payload prefix of
    that many bytes (progressive preview) — the result may be longer.
    """
    import struct

    if len(data) < 1:
        raise ValueError("truncated ctx_mt stream")
    k = data[0]
    if not 1 <= k <= _CTX_MT_MAX_CHUNKS:
        raise ValueError(f"implausible ctx_mt chunk count {k}")
    head = 1 + 4 * k
    if len(data) < head:
        raise ValueError("truncated ctx_mt stream")
    lens = struct.unpack_from(f"<{k}I", data, 1)
    if sum(lens) > len(data) - head:
        raise ValueError("truncated ctx_mt stream")
    spans = split_pieces(pieces, k)

    offs = [head]
    for ln in lens[:-1]:
        offs.append(offs[-1] + ln)

    todo = []
    for j, (lo, sub) in enumerate(spans):
        if upto_bytes is not None and lo >= upto_bytes:
            break
        todo.append((j, lo, sub))

    def job(args):
        j, lo, sub = args
        blob = data[offs[j] : offs[j] + lens[j]]
        return ctx_decode(blob, sub, adapt_shift)

    if len(todo) > 1:
        parts = list(_ctx_pool().map(job, todo))
    else:
        parts = [job(todo[0])] if todo else []
    return b"".join(parts)
