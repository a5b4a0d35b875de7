"""The racing ``.thgi`` writer and its readers in plain Python and NumPy:
what ``encode-tiled`` without ``--fast`` writes for each tile.

A tile's residual grid (:mod:`.hgi`) is coded in two layouts, each by
several coders, and the smallest coded body wins:

* the row-major layout (0): the grid's bytes;
* the subband layout (1, at a depth above 0): the grid on its canvas (the
  grid zero-padded to whole cells of the coarsest step), as the anchors
  (every ``2**L``-th pixel both ways), then each level's quads q01, q10,
  q11, coarsest first;
* the coders, in the race's order: raw DEFLATE at level 9 (window bits
  -15, memLevel 9) with ``Z_FILTERED`` and with the default strategy, the
  host rANS (codec 1, :mod:`.hostrans`), on each layout, then the ctx
  coder (codec 4, :mod:`.ctx`) on the subband layout, its shift 5 for a
  lossless archive and 4 otherwise.  DEFLATE is codec 0 whichever
  strategy won.

The first candidate in that order wins a tie.  The ``.thgi``: u32 magic
0x7B61A555 | u32 quantization tag | u32 interpolation tag | u32 width |
u32 height | u64 depth | u8 layout | u8 codec | u64 payload size | the
body.  Payloads from 1 MiB up take other framings (two-stream rANS,
chunked ctx) that this reference does not write: it raises there.
"""

from __future__ import annotations

import struct
import zlib
from typing import Dict, List, Sequence, Tuple

import numpy as np

from . import ctx, hgi, hostrans

__all__ = ["MT_BYTES", "LAYOUTS", "CODECS", "subband_payload", "subband_pieces",
           "race", "race_tiles", "read_blocks", "decode_tiles", "tally"]

THGI_MAGIC = 0x7B61_A555
ROWMAJOR, SUBBAND = 0, 1
DEFLATE, RANS, CTX = 0, 1, 4
LAYOUTS = {ROWMAJOR: "rowmajor", SUBBAND: "subband"}
CODECS = {DEFLATE: "deflate", RANS: "rans", CTX: "ctx"}
MT_BYTES = 1 << 20  # payloads from here up take framings this reference lacks
_META = struct.Struct("<IIIIQ")
_HEAD = struct.Struct("<BBQ")
HEAD = 4 + _META.size + _HEAD.size


def _canvas(grids: np.ndarray, levels: int) -> Tuple[np.ndarray, int]:
    b, h, w = grids.shape
    lv = hgi.effective_levels(levels, h, w)
    step = 1 << lv
    canvas = np.zeros((b, -(-h // step) * step, -(-w // step) * step), np.uint8)
    canvas[:, :h, :w] = grids
    return canvas, lv


def subband_pieces(h: int, w: int, levels: int) -> List[Tuple[int, int, int]]:
    """The ctx coder's ``(h, w, group)`` pieces of an ``h x w`` grid's
    subband payload."""
    lv = hgi.effective_levels(levels, h, w)
    step = 1 << lv
    ch, cw = -(-h // step) * step, -(-w // step) * step
    quads = [(ch >> (lv - level), cw >> (lv - level)) for level in range(lv)]
    return ctx.piece_table((ch // step, cw // step), quads)


def subband_payload(grids: np.ndarray, levels: int) -> np.ndarray:
    """uint8 ``[B, H, W]`` grids -> ``[B, N]`` subband payloads."""
    canvas, lv = _canvas(grids, levels)
    b = canvas.shape[0]
    step = 1 << lv
    parts = [canvas[:, ::step, ::step]]
    for level in range(lv):
        s1 = 1 << (lv - level - 1)
        parts += [canvas[:, 0 :: 2 * s1, s1 :: 2 * s1], canvas[:, s1 :: 2 * s1, 0 :: 2 * s1],
                  canvas[:, s1 :: 2 * s1, s1 :: 2 * s1]]
    return np.concatenate([p.reshape(b, -1) for p in parts], 1)


def _assemble(payloads: np.ndarray, h: int, w: int, levels: int) -> np.ndarray:
    """Inverse of :func:`subband_payload`, cropped to ``h x w``."""
    b = payloads.shape[0]
    canvas, lv = _canvas(np.zeros((b, h, w), np.uint8), levels)
    step = 1 << lv
    views = [canvas[:, ::step, ::step]]
    for level in range(lv):
        s1 = 1 << (lv - level - 1)
        views += [canvas[:, 0 :: 2 * s1, s1 :: 2 * s1], canvas[:, s1 :: 2 * s1, 0 :: 2 * s1],
                  canvas[:, s1 :: 2 * s1, s1 :: 2 * s1]]
    pos = 0
    for v in views:
        size = v.shape[1] * v.shape[2]
        v[...] = payloads[:, pos : pos + size].reshape(v.shape)
        pos += size
    return canvas[:, :h, :w]


def _deflate(raw: bytes, strategy: int) -> bytes:
    co = zlib.compressobj(9, zlib.DEFLATED, -15, 9, strategy)
    return co.compress(raw) + co.flush()


def _frame(h: int, w: int, levels: int, preset: str, predictor: str, layout: int, codec: int,
           raw_size: int, body: bytes) -> bytes:
    meta = _META.pack(hgi.TAGS[preset], hgi.PREDICTOR_TAGS[predictor], w, h, levels)
    return b"".join((struct.pack("<I", THGI_MAGIC), meta, _HEAD.pack(layout, codec, raw_size),
                     body))


def race(grids: np.ndarray, levels: int, preset: str, predictor: str = "crossed",
         tie: str = "first", codecs: Sequence[str] = ("deflate", "rans", "ctx"),
         ) -> Tuple[List[bytes], List[Tuple[int, int]]]:
    """Residual grids ``[B, H, W]`` of one shape -> each one's racing
    ``.thgi`` and the ``(layout, codec)`` that won it.  ``codecs`` names
    the coders that race (of ``CODECS``' names); ``tie="last"`` gives a
    tie to the later candidate: the benchmark's control."""
    grids = np.ascontiguousarray(grids, np.uint8)
    b, h, w = grids.shape
    layouts = [(ROWMAJOR, grids.reshape(b, -1))]
    if levels > 0:
        layouts.append((SUBBAND, subband_payload(grids, levels)))
    bodies: List[List[Tuple[int, int, int, bytes]]] = [[] for _ in range(b)]
    for layout, raw in layouts:
        if raw.shape[1] >= MT_BYTES:
            raise ValueError(f"a {raw.shape[1]}-byte payload takes the two-stream framings")
        for i in range(b) if "deflate" in codecs else ():
            data = raw[i].tobytes()
            for strategy in (zlib.Z_FILTERED, zlib.Z_DEFAULT_STRATEGY):
                bodies[i].append((layout, DEFLATE, raw.shape[1], _deflate(data, strategy)))
        for i, body in enumerate(hostrans.encode(raw) if "rans" in codecs else ()):
            bodies[i].append((layout, RANS, raw.shape[1], body))
    if levels > 0 and "ctx" in codecs:
        shift = 5 if preset == "lossless" else 4
        raw = layouts[1][1]
        for i, body in enumerate(ctx.encode(raw, subband_pieces(h, w, levels), shift)):
            bodies[i].append((SUBBAND, CTX, raw.shape[1], body))
    out, wins = [], []
    for cands in bodies:
        order = cands if tie == "first" else cands[::-1]
        layout, codec, size, body = min(order, key=lambda c: len(c[3]))
        out.append(_frame(h, w, levels, preset, predictor, layout, codec, size, body))
        wins.append((layout, codec))
    return out, wins


def race_tiles(tiles: np.ndarray, levels: int, preset: str, predictor: str = "crossed",
               error: int = None, tie: str = "first"):
    """uint8 tiles ``[B, T, T]`` -> their racing ``.thgi`` blocks and wins.
    ``error`` quantizes with another preset's error than the header's."""
    grid, _ = hgi.encode(tiles, levels, hgi.ERRORS[preset] if error is None else error, predictor)
    return race(grid, levels, preset, predictor, tie)


def read_blocks(blobs: Sequence[bytes]):
    """Each ``.thgi``'s ``(h, w, levels, predictor, layout, codec, shift,
    raw_size, body)``, ``shift`` the ctx coder's by its quantization tag;
    ValueError on a wrong magic, layout, codec or size."""
    heads = []
    for blob in blobs:
        if len(blob) < HEAD or struct.unpack_from("<I", blob)[0] != THGI_MAGIC:
            raise ValueError("not a .thgi")
        quant, interp, w, h, levels = _META.unpack_from(blob, 4)
        layout, codec, raw = _HEAD.unpack_from(blob, 4 + _META.size)
        if layout not in LAYOUTS or codec not in CODECS or (codec == CTX and layout != SUBBAND):
            raise ValueError(f"not a racing .thgi this reference reads: {layout}, {codec}")
        want = h * w if layout == ROWMAJOR else sum(a * c for a, c, _ in subband_pieces(h, w, levels))
        if raw != want:
            raise ValueError(f"payload size {raw} where the layout holds {want}")
        predictor = "left_top" if interp == hgi.PREDICTOR_TAGS["left_top"] else "crossed"
        shift = 5 if quant == hgi.TAGS["lossless"] else 4
        heads.append((h, w, levels, predictor, layout, codec, shift, raw, blob[HEAD:]))
    return heads


def decode_tiles(blobs: Sequence[bytes]) -> np.ndarray:
    """Racing ``.thgi`` archives of one shape -> uint8 ``[B, H, W]`` planes.
    Archives of one layout, codec and shift are decoded together."""
    heads = read_blocks(blobs)
    if len({head[:4] for head in heads}) != 1:
        raise ValueError("archives differ in shape, depth or predictor")
    h, w, levels, predictor = heads[0][:4]
    groups: Dict[Tuple[int, int, int], List[int]] = {}
    for i, head in enumerate(heads):
        groups.setdefault(head[4:7], []).append(i)
    grids = np.empty((len(blobs), h, w), np.uint8)
    for (layout, codec, shift), idx in groups.items():
        raw = heads[idx[0]][7]
        bodies = [heads[i][8] for i in idx]
        if codec == DEFLATE:
            got = np.stack([np.frombuffer(_inflate(body, raw), np.uint8) for body in bodies])
        elif codec == RANS:
            got = hostrans.decode(bodies, raw)
        else:
            got = ctx.decode(bodies, subband_pieces(h, w, levels), shift)
        if layout == ROWMAJOR:
            grids[idx] = got.reshape(-1, h, w)
        else:
            grids[idx] = _assemble(got, h, w, levels)
    return hgi.decode(grids, levels, predictor)


def _inflate(body: bytes, size: int) -> bytes:
    do = zlib.decompressobj(-15)
    out = do.decompress(body, size)
    if len(out) != size or do.unconsumed_tail or do.flush():
        raise ValueError("a DEFLATE body of another size than its header's")
    return out


def tally(wins) -> Dict[str, int]:
    """Wins ``[(layout, codec)]`` counted by ``"<layout>.<codec>"``."""
    out: Dict[str, int] = {}
    for a, c in wins:
        key = f"{LAYOUTS[a]}.{CODECS[c]}"
        out[key] = out.get(key, 0) + 1
    return out
