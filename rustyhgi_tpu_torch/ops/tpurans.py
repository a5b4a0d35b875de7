"""Lane-parallel interleaved rANS on the device (X1), codec 7 of ``.thgi``.

Counterpart of ``rustyhgi_tpu/ops/tpurans.py``, byte for byte.  The flat
stream of ``n`` symbols is zero-padded to ``T * L`` and laid out
``sym[t, l] = flat[t * L + l]``; the padding zeros are counted and coded
like any other symbol.  The table is the stream's histogram normalized to
``M = 2**14`` on the device; ``L`` independent rANS lanes (u32 states,
u16 word renormalization, at most one word per symbol) encode the rows
last to first, so that the decoder runs first to last.  The words are
stored lane-major, each lane's in decode order (the reverse of emission),
so the first ``sum(counts)`` words of the output are the payload's body.

Two versions compute the same outputs:

* :func:`encode_plain`, plain PyTorch: ``torch.bincount``, the
  normalizer op for op, the lane scan as a loop over the ``T`` symbol
  rows on ``[B, L]`` tensors, and the stored order by mask and index;
* the CUDA kernel ``rans_tpu_encode`` of ``csrc/hgi_entropy.cu``, which
  :func:`encode_batch` launches for a CUDA tensor (``rans_launches``
  counts its calls); for a CPU tensor, and only then, it takes the plain
  version.  Its lanes divide by no variable: :func:`reciprocal` and
  :func:`quotient` are their division-free step in plain Python, which
  the CPU tests hold against ``//``.

Both take ``[B, n]`` planes, each with its own table and lanes, and
return ``(freq [B, 256] int32, counts [B, L] int32, states [B, L] int32,
stream [B * T * L] int16)``: ``states`` holds the u32 bits and ``stream``
the u16 bits, and the planes' words lie one after another from offset 0,
so that one copy of ``stream[:counts.sum()]`` fetches every body exactly.

Payload layout (little-endian):
  u32 n | u32 L | u16 freq[256] | u16 counts[L] | u32 state[L] |
  per lane, counts[l] u16 words in decode order, lane-major.

The decoder runs on the host: the native one of ``native/tpu_rans.cpp``
when the library is present, else its vectorized NumPy mirror below, with
the same output and the same errors.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from . import _build
from ._build import _on, raise_on

__all__ = [
    "MAX_SYMBOLS",
    "lanes_for",
    "encode_plain",
    "encode_batch",
    "encode_device",
    "fetch_heads",
    "fetch_words",
    "frame_payloads",
    "finalize_stream",
    "encode_bytes",
    "decode_bytes",
    "reciprocal",
    "quotient",
    "LANE_BLOCK",
    "rans_launches",
]

rans_launches = 0

_SCALE_BITS = 14
_M = 1 << _SCALE_BITS
_STATE_L = 1 << 16  # state lower bound; renormalization emits one u16
_RENORM_SHIFT = 18  # emit iff state >= freq << 18, compared shifted

# The histogram's totals go through float32 in the normalizer, exact up
# to 2**24 symbols; larger planes take the host coders.
MAX_SYMBOLS = 1 << 24

_MIN_LANES, _MAX_LANES = 128, 8192

# Lanes a block of the kernel's lane stage codes (32, 64 or 128):
# ``python -m rustyhgi_tpu_torch.tools.chip_probe sweep`` times each.
LANE_BLOCK = 32


def lanes_for(n: int) -> int:
    """Lane count of an n-symbol stream: about 512 symbols a lane, a power
    of two in [128, 8192].  Part of the format: the payload stores it."""
    target = max(_MIN_LANES, min(_MAX_LANES, n // 512))
    return 1 << (target.bit_length() - 1)


def _shape(n: int) -> Tuple[int, int]:
    if n == 0:
        raise ValueError("empty stream")
    if n > MAX_SYMBOLS:
        raise ValueError(f"stream of {n} symbols exceeds {MAX_SYMBOLS}")
    lanes = lanes_for(n)
    return lanes, -(-n // lanes)


def _normalize(counts: torch.Tensor) -> torch.Tensor:
    """``[B, 256]`` int64 counts -> tables summing to exactly ``M``.

    The JAX ``_normalize_device`` op for op: the float32 quotient, the
    drift absorbed by the first most frequent symbol, then six rounds of
    +-1 units spread in index order.  Any valid table decodes, since the
    table is stored; this one is the JAX writer's.
    """
    total = counts.sum(-1, keepdim=True)
    present = counts > 0
    scaled = torch.floor(counts.float() * float(_M) / total.float()).long()
    freq = torch.where(present, scaled.clamp(1, _M - 1), torch.zeros_like(scaled))
    drift = _M - freq.sum(-1, keepdim=True)
    mx = counts.argmax(-1, keepdim=True)  # the first maximum
    fmx = freq.gather(-1, mx)
    give = torch.minimum(torch.maximum(drift, 1 - fmx), (_M - 1) - fmx)
    freq = freq.scatter_add(-1, mx, give)
    drift = drift - give
    for _ in range(6):
        pos = drift > 0
        eligible = torch.where(pos, freq < _M - 1, freq > 1)
        rank = eligible.long().cumsum(-1)
        delta = (eligible & (rank <= drift.abs())).long()
        signed = torch.where(pos, delta, -delta)
        freq = freq + signed
        drift = drift - signed.sum(-1, keepdim=True)
    return freq


def _bits(x: torch.Tensor, width: int, dtype: torch.dtype) -> torch.Tensor:
    """Unsigned ``width``-bit values (int64) as the signed type's bits."""
    return torch.where(x >= 1 << (width - 1), x - (1 << width), x).to(dtype)


def reciprocal(f: int) -> Tuple[int, int]:
    """The kernel's reciprocal of a frequency ``f`` in ``[1, M)``: ``(m,
    extra)``, ``m`` a u64 with ``quotient(x, m) == x // f`` for every u32
    ``x`` when ``f >= 2``.

    ``m = floor((2**64 - 1) / f) + 1``: then ``m * f = 2**64 + d`` with
    ``0 <= d < f``, and ``x * m / 2**64 = x / f + x * d / (f * 2**64)``,
    whose second term is below ``1 / f`` for ``x < 2**32``, too small to
    reach the next integer.  For ``f = 1`` that ``m`` is ``2**64``, one
    past u64: the kernel takes ``m = 2**64 - 1``, whose quotient is
    ``x - 1`` for ``x >= 1``, and ``extra = M - 1`` restores the state
    (``x + (x - 1) * (M - 1) + M - 1 == x * M``).  The lanes' step is then
    ``x + q * (M - f) + cum + extra``, no division on the state's chain.
    """
    if not 1 <= f < _M:
        raise ValueError(f"frequency {f} outside [1, {_M})")
    if f == 1:
        return (1 << 64) - 1, _M - 1
    return ((1 << 64) - 1) // f + 1, 0


def quotient(x, m):
    """``hi64(x * m)`` for u32 ``x`` and u64 ``m`` (ints or numpy arrays,
    elementwise) as the kernel forms it: ``(x * m_hi + hi32(x * m_lo)) >>
    32``, two 32x32 multiplies whose sums stay below ``2**64``."""
    m = np.asarray(m, dtype=np.uint64)
    m_lo, m_hi = m & np.uint64(0xFFFFFFFF), m >> np.uint64(32)
    x = np.asarray(x, dtype=np.uint64)
    mid = (x * m_lo) >> np.uint64(32)
    return (x * m_hi + mid) >> np.uint64(32)


def _check(sym: torch.Tensor) -> Tuple[int, int, int, int]:
    if sym.dtype != torch.uint8 or sym.dim() != 2:
        raise ValueError(f"symbols must be uint8 [B, n], got {sym.dtype} {tuple(sym.shape)}")
    b, n = sym.shape
    lanes, rows = _shape(n)
    return b, n, lanes, rows


def encode_plain(sym: torch.Tensor):
    """X1's plain version: uint8 ``[B, n]`` -> ``(freq, counts, states,
    stream)`` as the module docstring says, on ``sym``'s device."""
    b, n, lanes, rows = _check(sym)
    dev = sym.device
    padded = torch.zeros(b, rows * lanes, dtype=torch.long, device=dev)
    padded[:, :n] = sym
    hist = torch.bincount(
        (padded + 256 * torch.arange(b, device=dev)[:, None]).reshape(-1),
        minlength=256 * b,
    ).reshape(b, 256)
    freq = _normalize(hist)
    cum = freq.cumsum(-1) - freq
    grid = padded.reshape(b, rows, lanes)
    fs = freq.gather(-1, grid.reshape(b, -1)).reshape(b, rows, lanes)
    cs = cum.gather(-1, grid.reshape(b, -1)).reshape(b, rows, lanes)
    words = torch.empty(b, rows, lanes, dtype=torch.long, device=dev)
    emits = torch.empty(b, rows, lanes, dtype=torch.bool, device=dev)
    x = torch.full((b, lanes), _STATE_L, dtype=torch.long, device=dev)
    for t in range(rows - 1, -1, -1):  # rANS is LIFO: last row first
        f, c = fs[:, t], cs[:, t]
        emit = (x >> _RENORM_SHIFT) >= f
        words[:, t] = x & 0xFFFF
        emits[:, t] = emit
        x = torch.where(emit, x >> 16, x)
        q = x // f
        x = (q << _SCALE_BITS) + (x - q * f) + c
    # Stored order: lane-major, each lane's rows ascending, which is the
    # reverse of emission; the planes one after another.
    body = words.transpose(1, 2)[emits.transpose(1, 2)]
    stream = torch.zeros(b * rows * lanes, dtype=torch.int16, device=dev)
    stream[: body.numel()] = _bits(body, 16, torch.int16)
    return (freq.int(), emits.sum(1, dtype=torch.int32),
            _bits(x, 32, torch.int32), stream)


def encode_batch(sym: torch.Tensor, lane_block: int = LANE_BLOCK):
    """X1: uint8 ``[B, n]`` -> ``(freq, counts, states, stream)``.

    The kernel on a CUDA tensor, the plain version on a CPU tensor.
    Raises ValueError for an empty or oversized stream, as JAX does.
    ``lane_block`` (32, 64 or 128 lanes a block) changes the kernel's
    launch, never its output.
    """
    global rans_launches
    if sym.device.type == "cpu":
        return encode_plain(sym)
    if sym.device.type != "cuda":
        raise ValueError(f"symbols must be a CPU or CUDA tensor, got {sym.device}")
    b, n, lanes, rows = _check(sym)
    if not sym.is_contiguous():
        raise ValueError("symbols must be contiguous")
    if lane_block not in (32, 64, 128):
        raise ValueError(f"lane_block must be 32, 64 or 128, got {lane_block}")
    blocks = b * (lanes // lane_block)
    if blocks >= 1 << 31:
        raise ValueError(f"batch of {b} planes is beyond the kernel's range")

    def new(*shape, dtype=torch.int32):
        return torch.empty(shape, dtype=dtype, device=sym.device)

    freq, counts, states = new(b, 256), new(b, lanes), new(b, lanes)
    stream = new(b * rows * lanes, dtype=torch.int16)
    entries = new(b, 256, 4)  # the lanes' per-symbol entries, scratch
    scratch = new(b * rows * lanes, dtype=torch.int16)  # each lane's words
    status = new(blocks + 1, dtype=torch.int64)  # look-back words, ticket
    lib = _build.load()
    with _on(sym.device):
        cu_stream = torch.cuda.current_stream().cuda_stream
        rc = lib.rans_tpu_encode(
            sym.data_ptr(), freq.data_ptr(), counts.data_ptr(), states.data_ptr(),
            stream.data_ptr(), entries.data_ptr(), scratch.data_ptr(), status.data_ptr(),
            b, n, lanes, rows, lane_block, cu_stream,
        )
    rans_launches += 1
    raise_on(rc, "rans_tpu_encode")
    return freq, counts, states, stream


def encode_device(flat: torch.Tensor):
    """X1 on one uint8 ``[n]`` stream -> ``(freq [256], counts [L],
    states [L], stream [T * L])``, as JAX ``encode_device`` (whose stream
    is ``[T, L]``)."""
    freq, counts, states, stream = encode_batch(flat.reshape(1, -1))
    return freq[0], counts[0], states[0], stream


# -- host side: the exact fetch and the framing --------------------------------


def fetch_heads(freq, counts, states):
    """First fetch: the tables, word counts and final states of every
    plane, one device-to-host copy.  Returns numpy ``(freq [B, 256] i64,
    counts [B, L] i64, states [B, L] u32)``."""
    lanes = counts.shape[-1]
    head = torch.cat([freq, counts, states], -1).cpu().numpy()
    return (head[:, :256].astype(np.int64), head[:, 256 : 256 + lanes].astype(np.int64),
            head[:, 256 + lanes :].view(np.uint32))


def fetch_words(stream, counts: np.ndarray) -> np.ndarray:
    """Second fetch: exactly the ``counts.sum()`` coded words of every
    plane, one device-to-host copy, as u16."""
    return stream[: int(counts.sum())].cpu().numpy().view(np.uint16)


def frame_payloads(n: int, freq: np.ndarray, counts: np.ndarray, states: np.ndarray,
                   words: np.ndarray) -> List[bytes]:
    """The fetched batch -> one payload per plane (host framing)."""
    out, pos = [], 0
    for f, c, s in zip(freq, counts, states):
        total = int(c.sum())
        out.append(finalize_stream(n, f, c, s, words[pos : pos + total]))
        pos += total
    return out


def finalize_stream(n: int, freq, counts, states, stream) -> bytes:
    """Frame one plane's outputs into the payload (pure framing).

    ``stream`` holds at least ``counts.sum()`` words in stored order.
    """
    freq = np.asarray(freq)
    counts = np.asarray(counts, dtype=np.int64)
    states = np.asarray(states, dtype=np.uint32)
    words = np.asarray(stream, dtype=np.uint16).reshape(-1)
    total = int(counts.sum())
    if words.shape[0] < total:
        raise ValueError("stream prefix shorter than the word count")
    return b"".join((
        int(n).to_bytes(4, "little"),
        int(counts.shape[0]).to_bytes(4, "little"),
        freq.astype("<u2").tobytes(),
        counts.astype("<u2").tobytes(),
        states.astype("<u4").tobytes(),
        words[:total].astype("<u2").tobytes(),
    ))


def encode_bytes(data: bytes, device="cuda") -> bytes:
    """Encode a byte string: X1 on ``device``, the exact fetch, framing.

    The empty stream is the 8-byte header of zeros.
    """
    if len(data) == 0:
        return (0).to_bytes(4, "little") + (0).to_bytes(4, "little")
    flat = torch.frombuffer(bytearray(data), dtype=torch.uint8).to(device)
    freq, counts, states, stream = encode_batch(flat[None])
    heads = fetch_heads(freq, counts, states)
    return frame_payloads(len(data), *heads, fetch_words(stream, heads[1]))[0]


def decode_bytes(data: bytes, expected_n: int = None) -> np.ndarray:
    """Decode a payload back to uint8 ``[n]`` on the host.

    The native decoder when the library is present, else the NumPy
    mirror; both accept and reject alike.  ``expected_n``, when given,
    must equal the embedded size: a hostile payload cannot declare its
    own allocation.  Raises ValueError on any malformed input.
    """
    if len(data) < 8:
        raise ValueError("truncated rans_tpu stream")
    from . import native

    if native.available():
        size = expected_n if expected_n is not None else int.from_bytes(data[0:4], "little")
        return native.native_rans_tpu_decode(data, size)
    return _decode_numpy(data, expected_n)


def _decode_numpy(data: bytes, expected_n: int = None) -> np.ndarray:
    """The vectorized NumPy decoder: lanes advance in lockstep, one step
    per symbol row.  ``data`` holds at least the 8-byte header."""
    n = int.from_bytes(data[0:4], "little")
    L = int.from_bytes(data[4:8], "little")
    if expected_n is not None and n != expected_n:
        raise ValueError(f"rans_tpu stream size {n} does not match declared {expected_n}")
    if n == 0:
        if L != 0:
            raise ValueError("empty stream with nonzero lane count")
        return np.zeros(0, np.uint8)
    if not (_MIN_LANES <= L <= _MAX_LANES) or L & (L - 1):
        raise ValueError(f"invalid rans_tpu lane count {L}")
    T = -(-n // L)
    hdr = 8 + 512 + 2 * L + 4 * L
    if len(data) < hdr:
        raise ValueError("truncated rans_tpu stream")
    freq = np.frombuffer(data, "<u2", count=256, offset=8).astype(np.int64)
    if int(freq.sum()) != _M:
        raise ValueError("invalid rans_tpu frequency table")
    counts = np.frombuffer(data, "<u2", count=L, offset=8 + 512).astype(np.int64)
    if counts.max(initial=0) > T:
        raise ValueError("rans_tpu lane count exceeds symbol rows")
    states = np.frombuffer(data, "<u4", count=L, offset=8 + 512 + 2 * L).astype(np.int64)
    total = int(counts.sum())
    if len(data) < hdr + 2 * total:
        raise ValueError("truncated rans_tpu stream body")
    stream = np.frombuffer(data, "<u2", count=total, offset=hdr).astype(np.int64)

    cum = np.concatenate(([0], np.cumsum(freq)))
    slot2sym = np.repeat(np.arange(256, dtype=np.uint8), freq)
    starts = np.concatenate(([0], np.cumsum(counts)))[:-1]
    ends = starts + counts
    ptr = starts.copy()
    x = states
    out = np.empty((T, L), np.uint8)
    guard = max(total - 1, 0)
    for t in range(T):
        slot = x & (_M - 1)
        s = slot2sym[slot]
        out[t] = s
        s64 = s.astype(np.int64)
        x = freq[s64] * (x >> _SCALE_BITS) + slot - cum[s64]
        need = x < _STATE_L
        if total:
            x = np.where(need, (x << 16) | stream[np.minimum(ptr, guard)], x)
        elif need.any():
            raise ValueError("rans_tpu stream underrun")
        ptr = ptr + need
    if (ptr != ends).any():
        raise ValueError("rans_tpu stream underrun or trailing words")
    # Every lane unwinds to the encoder's initial state: a whole-stream
    # integrity check.
    if (x != _STATE_L).any():
        raise ValueError("rans_tpu state mismatch (corrupt stream)")
    return out.reshape(-1)[:n]
