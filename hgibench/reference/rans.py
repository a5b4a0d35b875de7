"""Lane-parallel interleaved rANS (codec 7 of ``.thgi``) in plain NumPy.

The format, as the fast ``.thgi`` stores it: a stream of ``n`` symbols is
zero-padded to ``T * L`` and laid out ``sym[t, l] = flat[t * L + l]``,
``L`` a power of two near ``n / 512`` in [128, 8192].  The table is the
padded stream's histogram normalized to ``M = 2**14``.  ``L`` lanes with
u32 states starting at ``2**16`` code the rows last to first, emitting the
low 16 bits when ``state >> 18 >= freq`` (then ``state >>= 16``), and step
``state = (state // f << 14) + state % f + cum``.  The words are stored
lane-major, each lane's in decode order.

Payload (little-endian): u32 n | u32 L | u16 freq[256] | u16 counts[L] |
u32 state[L] | the words.  Encoder and decoder work on a batch of
streams of one length, each with its own table and lanes.
"""

from __future__ import annotations

from typing import List

import numpy as np

__all__ = ["lanes_for", "head_bytes", "normalize", "encode", "decode"]

SCALE_BITS = 14
M = 1 << SCALE_BITS
STATE_L = 1 << 16
RENORM_SHIFT = 18
MIN_LANES, MAX_LANES = 128, 8192


def lanes_for(n: int) -> int:
    target = max(MIN_LANES, min(MAX_LANES, n // 512))
    return 1 << (target.bit_length() - 1)


def head_bytes(n: int) -> int:
    """Bytes of a payload before its words: n, L, the table, the counts
    and the states."""
    return 8 + 512 + 6 * lanes_for(n)


def normalize(counts: np.ndarray) -> np.ndarray:
    """``[B, 256]`` counts -> tables summing to ``M``: the float32 quotient,
    the drift given to the first most frequent symbol, then six rounds of
    +-1 units spread in index order (the format's table, which the writer
    of the JAX package defined)."""
    counts = counts.astype(np.int64)
    total = counts.sum(-1, keepdims=True)
    scaled = np.floor(counts.astype(np.float32) * np.float32(M) / total.astype(np.float32))
    scaled = scaled.astype(np.int64)
    freq = np.where(counts > 0, np.clip(scaled, 1, M - 1), 0)
    drift = M - freq.sum(-1, keepdims=True)
    mx = counts.argmax(-1)[:, None]
    fmx = np.take_along_axis(freq, mx, -1)
    give = np.minimum(np.maximum(drift, 1 - fmx), (M - 1) - fmx)
    np.put_along_axis(freq, mx, fmx + give, -1)
    drift = drift - give
    for _ in range(6):
        pos = drift > 0
        eligible = np.where(pos, freq < M - 1, freq > 1)
        rank = np.cumsum(eligible, -1)
        delta = (eligible & (rank <= np.abs(drift))).astype(np.int64)
        signed = np.where(pos, delta, -delta)
        freq = freq + signed
        drift = drift - signed.sum(-1, keepdims=True)
    return freq


def encode(sym: np.ndarray) -> List[bytes]:
    """uint8 ``[B, n]`` -> one payload per stream."""
    sym = np.asarray(sym, dtype=np.uint8)
    b, n = sym.shape
    lanes = lanes_for(n)
    rows = -(-n // lanes)
    padded = np.zeros((b, rows * lanes), np.int64)
    padded[:, :n] = sym
    hist = np.stack([np.bincount(p, minlength=256) for p in padded])
    freq = normalize(hist)
    cum = np.cumsum(freq, -1) - freq
    grid = padded.reshape(b, rows, lanes)
    fs = np.take_along_axis(freq, padded, -1).reshape(b, rows, lanes)
    cs = np.take_along_axis(cum, padded, -1).reshape(b, rows, lanes)
    words = np.empty((b, rows, lanes), np.int64)
    emits = np.empty((b, rows, lanes), bool)
    x = np.full((b, lanes), STATE_L, np.int64)
    for t in range(rows - 1, -1, -1):
        f, c = fs[:, t], cs[:, t]
        emit = (x >> RENORM_SHIFT) >= f
        words[:, t] = x & 0xFFFF
        emits[:, t] = emit
        x = np.where(emit, x >> 16, x)
        q = x // f
        x = (q << SCALE_BITS) + (x - q * f) + c
    del grid
    counts = emits.sum(1)
    out = []
    for i in range(b):
        body = words[i].T[emits[i].T]
        out.append(b"".join((
            int(n).to_bytes(4, "little"), int(lanes).to_bytes(4, "little"),
            freq[i].astype("<u2").tobytes(), counts[i].astype("<u2").tobytes(),
            x[i].astype("<u4").tobytes(), body.astype("<u2").tobytes(),
        )))
    return out


def decode(payloads: List[bytes]) -> np.ndarray:
    """Payloads of streams of one length -> uint8 ``[B, n]``.

    Raises ValueError on a malformed payload: a table that does not sum to
    ``M``, a lane that runs out of words or keeps some, or a lane that does
    not unwind to the initial state.
    """
    heads = []
    for data in payloads:
        n, lanes = int.from_bytes(data[0:4], "little"), int.from_bytes(data[4:8], "little")
        heads.append((n, lanes))
    if len(set(heads)) != 1:
        raise ValueError("streams differ in length or lanes")
    n, lanes = heads[0]
    if not (MIN_LANES <= lanes <= MAX_LANES) or lanes & (lanes - 1) or lanes != lanes_for(n):
        raise ValueError(f"invalid lane count {lanes} for {n} symbols")
    rows = -(-n // lanes)
    b = len(payloads)
    hdr = head_bytes(n)
    freq = np.empty((b, 256), np.int64)
    counts = np.empty((b, lanes), np.int64)
    states = np.empty((b, lanes), np.int64)
    streams = []
    for i, data in enumerate(payloads):
        freq[i] = np.frombuffer(data, "<u2", 256, 8)
        counts[i] = np.frombuffer(data, "<u2", lanes, 8 + 512)
        states[i] = np.frombuffer(data, "<u4", lanes, 8 + 512 + 2 * lanes)
        total = int(counts[i].sum())
        if freq[i].sum() != M or len(data) != hdr + 2 * total:
            raise ValueError(f"stream {i}: bad table or length")
        streams.append(np.frombuffer(data, "<u2", total, hdr).astype(np.int64))
    cum = np.cumsum(freq, -1) - freq
    slot2sym = np.stack([np.repeat(np.arange(256), f) for f in freq])  # [b, M]
    words = np.concatenate(streams + [np.zeros(1, np.int64)])
    base = np.concatenate(([0], np.cumsum([s.size for s in streams])))[:-1]
    starts = (base[:, None] + np.cumsum(counts, -1) - counts).reshape(-1)
    ends = starts + counts.reshape(-1)
    ptr = starts.copy()
    plane = np.repeat(np.arange(b), lanes)
    x = states.reshape(-1)
    out = np.empty((rows, b * lanes), np.uint8)
    for t in range(rows):
        slot = x & (M - 1)
        s = slot2sym[plane, slot]
        out[t] = s
        x = freq[plane, s] * (x >> SCALE_BITS) + slot - cum[plane, s]
        need = x < STATE_L
        if (need & (ptr >= ends)).any():
            raise ValueError("stream underrun")
        x = np.where(need, (x << 16) | words[ptr], x)
        ptr = ptr + need
    if (ptr != ends).any() or (x != STATE_L).any():
        raise ValueError("trailing words or state mismatch")
    return out.reshape(rows, b, lanes).transpose(1, 0, 2).reshape(b, -1)[:, :n]
