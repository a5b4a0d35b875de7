"""Static order-0 rANS for the ``.thgi`` container.

Counterpart of ``rustyhgi_tpu/ops/entropy.py``: the native coder of
``native/rans.cpp`` (through :mod:`.native`) and its bit-identical
pure-Python mirror, which defines the stream and serves where the native
library is absent.  Stream layout: u16 LE freq[256] normalized to 2**14,
u8 variant ``0xC0 | 16``, u32 LE total length, u32 LE length of each of
the 16 interleaved streams, then the streams.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

__all__ = ["rans_encode", "rans_decode", "normalized_freqs"]

_SCALE_BITS = 14
_M = 1 << _SCALE_BITS
_WORD_L = 1 << 16  # word-renorm lower bound (native/rans.cpp kWordL)


def normalized_freqs(counts: np.ndarray) -> np.ndarray:
    """Normalize raw symbol counts to a u16[256] table summing to 2**14.

    Mirrors native/rans.cpp normalize_freqs, so that host- and
    device-derived histograms give identical shared tables.
    """
    counts = np.asarray(counts, dtype=np.uint64)
    total = int(counts.sum())
    freq = np.zeros(256, dtype=np.int64)
    if total == 0:
        freq[:] = _M // 256
        freq[0] += _M % 256
        return freq.astype(np.uint16)
    present = counts > 0
    scaled = (counts.astype(object) * _M) // total  # exact integer math
    # Every present symbol in [1, _M - 1]: the word-renorm threshold
    # f << 18 must fit uint32.
    freq[present] = np.clip(np.array(scaled[present], dtype=np.int64), 1, _M - 1)
    drift = _M - int(freq.sum())
    max_sym = int(counts.argmax())
    nf = int(freq[max_sym]) + drift
    if 1 <= nf <= _M - 1:
        freq[max_sym] = nf
    else:
        for i in range(256):
            if drift == 0:
                break
            f = int(freq[i])
            room_up = _M - 1 - f
            room_dn = f - 1 if f > 0 else 0
            if drift > 0:
                d = min(drift, room_up)
                if f == 0:
                    d = min(drift, _M - 1)
            else:
                d = max(drift, -room_dn)
            freq[i] = f + d
            drift -= d
    if int(freq.sum()) != _M:
        raise ValueError("could not normalize the symbol counts")
    return freq.astype(np.uint16)


def rans_encode(data: bytes, freqs: Optional[np.ndarray] = None) -> bytes:
    """rANS-compress bytes; the native coder when it is there.

    A native failure falls back to the Python coder, which either writes
    the same stream or raises its own error, as the JAX package does.
    """
    from .native import available, native_rans_compress

    if available():
        try:
            return native_rans_compress(data, freqs)
        except (RuntimeError, ValueError):
            pass
    return _py_rans_encode(data, freqs)


def rans_decode(data: bytes, raw_size: int) -> bytes:
    """Decompress a rANS stream of known raw size; native when it is there."""
    from .native import available, native_rans_decompress

    if available():
        try:
            return native_rans_decompress(data, raw_size)
        except (RuntimeError, ValueError):
            pass
    return _py_rans_decode(data, raw_size)


# -- pure-Python mirror (slow; defines the stream) ----------------------------

_WAYS = 16  # interleave width; must match native/rans.cpp kWays
_VARIANT = 0xC0 | _WAYS  # per-state word-renormalized streams


def _py_rans_encode(data: bytes, freqs: Optional[np.ndarray] = None) -> bytes:
    src = np.frombuffer(data, dtype=np.uint8)
    if freqs is None:
        freq = normalized_freqs(np.bincount(src, minlength=256))
    else:
        freq = np.ascontiguousarray(freqs, dtype=np.uint16)
        if freq.shape != (256,) or int(freq.sum()) != _M:
            raise ValueError("freq table must be u16[256] summing to 2**14")
    cum = np.zeros(257, dtype=np.uint32)
    cum[1:] = np.cumsum(freq)

    # Word renorm (at most one u16 a symbol), one independent stream per
    # state, emitted backward.
    outs = [bytearray() for _ in range(_WAYS)]
    x = [_WORD_L] * _WAYS
    for i in range(len(src) - 1, -1, -1):
        s = int(src[i])
        fs = int(freq[s])
        w = i % _WAYS
        xs = x[w]
        if xs >= ((_WORD_L >> _SCALE_BITS) << 16) * fs:
            outs[w].append((xs >> 8) & 0xFF)  # reversed later -> LE pairs
            outs[w].append(xs & 0xFF)
            xs >>= 16
        x[w] = ((xs // fs) << _SCALE_BITS) + (xs % fs) + int(cum[s])
    streams = [x[w].to_bytes(4, "big") + bytes(outs[w][::-1]) for w in range(_WAYS)]
    total = sum(len(s) for s in streams)
    return b"".join(
        [freq.astype("<u2").tobytes(), bytes([_VARIANT]), total.to_bytes(4, "little")]
        + [len(s).to_bytes(4, "little") for s in streams]
        + streams
    )


def _py_rans_decode(data: bytes, raw_size: int) -> bytes:
    hdr = 512 + 1 + 4 + 4 * _WAYS
    if len(data) < hdr:
        raise ValueError("rans stream too short")
    freq = np.frombuffer(data[:512], dtype="<u2").astype(np.uint32)
    cum = np.zeros(257, dtype=np.uint32)
    cum[1:] = np.cumsum(freq)
    if int(cum[256]) != _M:
        raise ValueError("invalid rans frequency table")
    if data[512] != _VARIANT:
        raise ValueError(f"unsupported rans stream variant {data[512]:#x}")
    total = int.from_bytes(data[513:517], "little")
    lens = [int.from_bytes(data[517 + 4 * w : 521 + 4 * w], "little") for w in range(_WAYS)]
    if sum(lens) != total or any(n < 4 for n in lens):
        raise ValueError("inconsistent rans stream lengths")
    body = data[hdr : hdr + total]
    if len(body) < total:
        raise ValueError("truncated rans stream")

    slot2sym = np.zeros(_M, dtype=np.uint8)
    for s in range(256):
        slot2sym[cum[s] : cum[s + 1]] = s

    streams, x, pos = [], [], []
    off = 0
    for w in range(_WAYS):
        chunk = body[off : off + lens[w]]
        off += lens[w]
        x.append(int.from_bytes(chunk[:4], "big"))
        streams.append(chunk)
        pos.append(4)

    out = bytearray(raw_size)
    mask = _M - 1
    for i in range(raw_size):
        w = i % _WAYS
        xs = x[w]
        slot = xs & mask
        s = int(slot2sym[slot])
        out[i] = s
        xs = int(freq[s]) * (xs >> _SCALE_BITS) + slot - int(cum[s])
        if xs < _WORD_L:
            st, p = streams[w], pos[w]
            if p + 2 > len(st):
                raise ValueError("rans stream underrun")
            xs = (xs << 16) | st[p] | (st[p + 1] << 8)
            pos[w] = p + 2
        x[w] = xs
    return bytes(out)
