"""Codec 1 of ``.thgi``, the host's static rANS, in plain NumPy, a batch of
streams of one length coded in lockstep.

Stream: u16 LE freq[256], the byte counts normalized to 2**14; u8
``0xD0`` (16 interleaved states); u32 LE length of all states' parts;
u32 LE length of each of the 16 parts; the parts.  Symbol ``i`` belongs
to state ``i mod 16``.  Each state starts at 2**16 and codes its symbols
last to first: before a symbol of frequency ``f`` it emits its low 16
bits and shifts right by 16 when it is at least ``f << 18``; then
``x = (x // f << 14) + x % f + cum``.  A state's part is its final value
(u32 big-endian), then its emitted words, little-endian, in the order a
decoder reads them (the last emitted first).

The table: ``counts * 2**14 // total`` for each present byte, clipped to
[1, 2**14 - 1]; the drift to 2**14 goes to the most frequent byte (the
first of equals) when that keeps it in [1, 2**14 - 1], else bytes take
it in index order, each as far as the bounds allow.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np

__all__ = ["WAYS", "normalize", "encode", "decode"]

SCALE_BITS = 14
M = 1 << SCALE_BITS
STATE_L = 1 << 16
WAYS = 16
VARIANT = 0xC0 | WAYS
HEAD = 512 + 1 + 4 + 4 * WAYS


def _normalize_one(counts: np.ndarray) -> np.ndarray:
    counts = counts.astype(np.int64)
    total = int(counts.sum())
    freq = np.zeros(256, np.int64)
    if total == 0:
        freq[:] = M // 256
        freq[0] += M % 256
        return freq
    present = counts > 0
    freq[present] = np.clip(counts[present] * M // total, 1, M - 1)
    drift = M - int(freq.sum())
    top = int(counts.argmax())
    if 1 <= freq[top] + drift <= M - 1:
        freq[top] += drift
        return freq
    for i in range(256):
        if drift == 0:
            break
        f = int(freq[i])
        if drift > 0:
            d = min(drift, M - 1 - f) if f else min(drift, M - 1)
        else:
            d = max(drift, -(f - 1 if f else 0))
        freq[i] = f + d
        drift -= d
    if int(freq.sum()) != M:
        raise ValueError("the counts cannot be normalized")
    return freq


def normalize(counts: np.ndarray) -> np.ndarray:
    """``[B, 256]`` byte counts -> ``[B, 256]`` tables summing to 2**14."""
    return np.stack([_normalize_one(c) for c in np.atleast_2d(counts)])


def encode(data: np.ndarray) -> List[bytes]:
    """uint8 ``[B, n]`` -> one codec-1 stream each."""
    data = np.ascontiguousarray(data, np.uint8)
    b, n = data.shape
    freq = normalize(np.stack([np.bincount(row, minlength=256) for row in data]))
    cum = np.cumsum(freq, 1) - freq
    rows = -(-n // WAYS)
    sym = np.zeros((b, rows * WAYS), np.int64)
    sym[:, :n] = data
    valid = (np.arange(rows * WAYS) < n).reshape(rows, WAYS)
    fs = np.where(valid, np.take_along_axis(freq, sym, 1).reshape(b, rows, WAYS), 1)
    cs = np.take_along_axis(cum, sym, 1).reshape(b, rows, WAYS)
    words = np.zeros((b, rows, WAYS), np.int64)
    emits = np.zeros((b, rows, WAYS), bool)
    x = np.full((b, WAYS), STATE_L, np.int64)
    for r in range(rows - 1, -1, -1):
        f, c, ok = fs[:, r], cs[:, r], valid[r]
        emit = (x >= (f << 18)) & ok
        words[:, r] = x & 0xFFFF
        emits[:, r] = emit
        x = np.where(emit, x >> 16, x)
        x = np.where(ok, ((x // f) << SCALE_BITS) + x % f + c, x)
    out = []
    for i in range(b):
        parts = [int(x[i, w]).to_bytes(4, "big") + words[i, :, w][emits[i, :, w]].astype("<u2")
                 .tobytes() for w in range(WAYS)]
        lens = np.array([len(p) for p in parts], "<u4")
        out.append(b"".join([freq[i].astype("<u2").tobytes(), bytes([VARIANT]),
                             int(lens.sum()).to_bytes(4, "little"), lens.tobytes()] + parts))
    return out


def decode(streams: Sequence[bytes], n: int) -> np.ndarray:
    """Codec-1 streams of ``n`` symbols each -> uint8 ``[B, n]``.  Raises
    ValueError on a malformed stream."""
    b = len(streams)
    rows = -(-n // WAYS)
    freq = np.empty((b, 256), np.int64)
    x = np.empty((b, WAYS), np.int64)
    words = []
    for i, s in enumerate(streams):
        if len(s) < HEAD:
            raise ValueError("rans stream too short")
        freq[i] = np.frombuffer(s, "<u2", 256)
        if freq[i].sum() != M or s[512] != VARIANT:
            raise ValueError("bad rans table or variant")
        total = int.from_bytes(s[513:517], "little")
        lens = np.frombuffer(s, "<u4", WAYS, 517).astype(np.int64)
        if lens.sum() != total or (lens < 4).any() or (lens % 2).any() or len(s) < HEAD + total:
            raise ValueError("inconsistent rans stream lengths")
        starts = HEAD + np.concatenate(([0], np.cumsum(lens)[:-1]))
        for w in range(WAYS):
            part = s[starts[w] : starts[w] + lens[w]]
            x[i, w] = int.from_bytes(part[:4], "big")
            words.append(np.frombuffer(part, "<u2", offset=4).astype(np.int64))
    counts = np.array([len(w) for w in words]).reshape(b, WAYS)
    flat = np.concatenate(words + [np.zeros(1, np.int64)])
    ptr = (np.cumsum(counts.reshape(-1)) - counts.reshape(-1)).reshape(b, WAYS)
    end = ptr + counts
    cum = np.cumsum(freq, 1) - freq
    slot2sym = np.stack([np.repeat(np.arange(256), f) for f in freq])
    plane = np.arange(b)[:, None]
    valid = (np.arange(rows * WAYS) < n).reshape(rows, WAYS)
    out = np.zeros((b, rows, WAYS), np.uint8)
    for r in range(rows):
        ok = valid[r]
        slot = x & (M - 1)
        s = slot2sym[plane, slot]
        out[:, r] = s
        nx = freq[plane, s] * (x >> SCALE_BITS) + slot - cum[plane, s]
        need = (nx < STATE_L) & ok
        if (need & (ptr >= end)).any():
            raise ValueError("rans stream underrun")
        nx = np.where(need, (nx << 16) | flat[np.minimum(ptr, len(flat) - 1)], nx)
        x = np.where(ok, nx, x)
        ptr = ptr + need
    if (ptr != end).any():
        raise ValueError("trailing rans words")
    return out.reshape(b, -1)[:, :n]
