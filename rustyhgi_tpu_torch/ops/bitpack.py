"""Bit-plane pack (K6) and unpack (K7), codec 2 of ``.thgi``.

Counterpart of ``rustyhgi_tpu/ops/pallas_kernels.py``, byte for byte.
Residual bytes are zigzag-folded (0, 255, 1, 254, ... -> 0, 1, 2, 3, ...),
the stream is cut into blocks of 1024 symbols, each an ``[8, 128]`` tile
(``block[k, j] = flat[1024 * i + 128 * k + j]``, zero-padded at the end),
and each block keeps only its ``width`` lowest bit-planes, ``width`` being
the bit length of the block's largest folded value.  Plane ``r`` is one
row of 128 bytes: ``out[r, j] = sum_k bit_r(z[k, j]) << k``.

The codec-2 body (little-endian): u32 n | u32 nb | ceil(nb / 2) bytes of
width nibbles (block 2i low, 2i+1 high, the last padded with 0) | each
block's kept planes, one block after another.

Two contracts, each with a CUDA kernel of ``csrc/hgi_entropy.cu`` and a
plain PyTorch version:

* JAX's: :func:`pack_blocks` (all 8 planes of every block and the
  widths) and :func:`unpack_blocks` (all 8 planes back to symbols), plain
  versions :func:`pack_plain` and :func:`unpack_plain`; the host framing
  :func:`finalize_packed` and :func:`expand_packed` keeps the used planes
  and re-expands them with zeros, as JAX's does;
* codec 2's, the body itself on the card: :func:`pack_stream` (K6
  compacting: the widths, their scan and only the kept planes, written
  into place) and :func:`unpack_stream` (K7 reading only the kept
  planes), plain versions :func:`pack_stream_plain` and
  :func:`unpack_stream_plain`.

:func:`pack_bytes` and :func:`unpack_bytes` are codec 2's write and read.
On the card the write copies the stream over, fetches the planes' total
(8 bytes) and then exactly the body; the read checks the body on the host
as :func:`expand_packed` does, copies it over as it is, and fetches the
``n`` symbols.  ``h2d_bytes`` and ``d2h_bytes`` count what they copy.

Every wrapper launches its kernel for a CUDA tensor (``pack_launches``
counts K6's calls, ``unpack_launches`` K7's, either contract); for a CPU
tensor, and only then, it takes the plain version.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from . import _build
from ._build import _on, raise_on

__all__ = [
    "BLOCK",
    "zigzag",
    "unzigzag",
    "pack_plain",
    "unpack_plain",
    "pack_blocks",
    "unpack_blocks",
    "pack_stream_plain",
    "unpack_stream_plain",
    "pack_compact",
    "pack_stream",
    "unpack_stream",
    "finalize_packed",
    "expand_packed",
    "check_body",
    "pack_bytes",
    "unpack_bytes",
    "pack_launches",
    "unpack_launches",
    "h2d_bytes",
    "d2h_bytes",
]

pack_launches = 0
unpack_launches = 0
h2d_bytes = 0  # host-to-card bytes of pack_bytes and unpack_bytes
d2h_bytes = 0  # card-to-host bytes of pack_stream, pack_bytes and unpack_bytes

BLOCK = 1024  # symbols per block: an [8, 128] tile
_SUB, _LANE = 8, 128
_WARPS = 8  # warps a CTA of the kernels (kPackWarps)
_COUNTERS = 1  # compacting K6's ticket word before its look-back words (kPackCounters)
_MAX_N = (1 << 32) - 1  # the header's u32


def zigzag(v: torch.Tensor) -> torch.Tensor:
    """Fold mod-256 residuals to small magnitudes (integer in and out)."""
    return torch.where(v < 128, v * 2, (256 - v) * 2 - 1)


def unzigzag(z: torch.Tensor) -> torch.Tensor:
    return torch.where((z & 1) == 0, z >> 1, (256 - ((z + 1) >> 1)) & 255)


def _blocks(flat: torch.Tensor) -> Tuple[torch.Tensor, int]:
    n = flat.shape[0]
    nb = -(-n // BLOCK)
    padded = torch.zeros(nb * BLOCK, dtype=torch.uint8, device=flat.device)
    padded[:n] = flat
    return padded.reshape(nb, _SUB, _LANE), nb


def _check(x: torch.Tensor, name: str, rank: int) -> None:
    if x.dtype != torch.uint8 or x.dim() != rank:
        raise ValueError(f"{name} must be uint8 of rank {rank}, got {x.dtype} {tuple(x.shape)}")


def pack_plain(flat: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """K6's plain version: uint8 ``[n]`` -> ``(packed [nb, 8, 128] uint8,
    widths [nb] int32, nb)``."""
    _check(flat, "stream", 1)
    blocks, nb = _blocks(flat)
    z = zigzag(blocks.int())
    m = z.amax((1, 2)) if nb else z.new_zeros(0)
    widths = sum((m >= (1 << r)).int() for r in range(8))
    k = torch.arange(_SUB, device=flat.device).reshape(1, _SUB, 1)
    planes = [(((z >> r) & 1) << k).sum(1) for r in range(8)]  # each [nb, 128]
    return torch.stack(planes, 1).to(torch.uint8), widths, nb


def unpack_plain(expanded: torch.Tensor) -> torch.Tensor:
    """K7's plain version: bit-planes ``[nb, 8, 128]`` -> flat uint8
    ``[nb * 1024]``."""
    _check(expanded, "planes", 3)
    p = expanded.int()
    k = torch.arange(_SUB, device=p.device).reshape(1, _SUB, 1)
    z = torch.zeros_like(p)
    for r in range(8):
        z = z | (((p[:, r : r + 1, :] >> k) & 1) << r)
    return unzigzag(z).to(torch.uint8).reshape(-1)


def _kept(widths: torch.Tensor) -> torch.Tensor:
    """``[nb, 8]`` bool: the planes a block keeps."""
    return torch.arange(_SUB, device=widths.device)[None, :] < widths[:, None]


def pack_stream_plain(flat: torch.Tensor) -> torch.Tensor:
    """Compacting K6's plain version: uint8 ``[n]`` -> the codec-2 body,
    uint8, on ``flat``'s device."""
    packed, widths, nb = pack_plain(flat)
    n = flat.shape[0]
    nib = torch.zeros(nb + nb % 2, dtype=torch.uint8, device=flat.device)
    nib[:nb] = widths
    head = torch.tensor(list(n.to_bytes(4, "little") + nb.to_bytes(4, "little")),
                        dtype=torch.uint8, device=flat.device)
    return torch.cat([head, nib[0::2] | (nib[1::2] << 4), packed[_kept(widths)].reshape(-1)])


def unpack_stream_plain(body: torch.Tensor, n: int) -> torch.Tensor:
    """Compacted K7's plain version: a codec-2 body of a stream of ``n``
    symbols (checked as :func:`check_body` does) -> uint8 ``[n]``."""
    _check(body, "body", 1)
    nb = -(-n // BLOCK)
    nnib = (nb + 1) // 2
    nib = body[8 : 8 + nnib]
    widths = torch.stack([nib & 15, nib >> 4], 1).reshape(-1)[:nb].long()
    total = int(widths.sum())
    expanded = torch.zeros(nb, _SUB, _LANE, dtype=torch.uint8, device=body.device)
    expanded[_kept(widths)] = body[8 + nnib : 8 + nnib + total * _LANE].reshape(total, _LANE)
    return unpack_plain(expanded)[:n]


def _check_cuda(x: torch.Tensor, name: str) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{name} must be a CPU or CUDA tensor, got {x.device}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_n(n: int) -> None:
    if not 0 <= n <= _MAX_N:
        raise ValueError(f"a bitpack stream holds at most {_MAX_N} symbols, got {n}")


PER_WARP = (1, 2, 4)  # the blocks a warp of the kernels can take


def per_warp(nb: int, compacting_k6: bool = False) -> int:
    """Blocks a warp of the kernels takes on ``nb`` blocks.  On an H100
    (``chip_probe sweep``, PERF.md section 6): at 2025 blocks (1080x1920)
    more CTAs win, one block a warp, two for compacting K6, whose
    look-back is shorter over fewer CTAs; at 16200 (8x1080x1920) four
    do."""
    return 4 if nb >= 8192 else (2 if compacting_k6 else 1)


def _per(per: Optional[int], nb: int, compacting_k6: bool = False) -> int:
    if per is None:
        return per_warp(nb, compacting_k6)
    if per not in PER_WARP:
        raise ValueError(f"per must be one of {PER_WARP}, got {per}")
    return per


def _ctas(nb: int, per: int) -> int:
    return -(-nb // (_WARPS * per))


def pack_blocks(flat: torch.Tensor,
                per: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """K6: uint8 ``[n]`` -> ``(packed [nb, 8, 128], widths [nb] int32,
    nb)``; only the first ``widths[i]`` planes of block ``i`` carry data.
    ``per``: blocks a warp, else :func:`per_warp`'s."""
    global pack_launches
    if flat.device.type == "cpu":
        return pack_plain(flat)
    _check(flat, "stream", 1)
    _check_cuda(flat, "stream")
    n = flat.shape[0]
    nb = -(-n // BLOCK)
    packed = torch.empty(nb, _SUB, _LANE, dtype=torch.uint8, device=flat.device)
    widths = torch.empty(nb, dtype=torch.int32, device=flat.device)
    if nb == 0:
        return packed, widths, 0
    per = _per(per, nb)
    lib = _build.load()
    with _on(flat.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.bitpack_pack(flat.data_ptr(), packed.data_ptr(), widths.data_ptr(), n, nb, per,
                              stream)
    pack_launches += 1
    raise_on(rc, "bitpack_pack")
    return packed, widths, nb


def unpack_blocks(expanded: torch.Tensor, per: Optional[int] = None) -> torch.Tensor:
    """K7: bit-planes ``[nb, 8, 128]`` (absent planes zero) -> flat uint8
    ``[nb * 1024]``.  ``per``: blocks a warp, else :func:`per_warp`'s."""
    global unpack_launches
    if expanded.device.type == "cpu":
        return unpack_plain(expanded)
    _check(expanded, "planes", 3)
    _check_cuda(expanded, "planes")
    if tuple(expanded.shape[1:]) != (_SUB, _LANE):
        raise ValueError(f"planes must be [nb, 8, 128], got {tuple(expanded.shape)}")
    nb = expanded.shape[0]
    out = torch.empty(nb * BLOCK, dtype=torch.uint8, device=expanded.device)
    if nb == 0:
        return out
    per = _per(per, nb)
    lib = _build.load()
    with _on(expanded.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.bitpack_unpack(expanded.data_ptr(), out.data_ptr(), nb, per, stream)
    unpack_launches += 1
    raise_on(rc, "bitpack_unpack")
    return out


def pack_compact(flat: torch.Tensor, per: Optional[int] = None) -> Tuple[torch.Tensor, int, int]:
    """Compacting K6 on a CUDA uint8 ``[n]``, ``n > 0``, with no copy to
    the host: ``(buf, head, start)``.  ``buf[:8]`` will hold the kept
    planes' total ``t`` (int64) and ``buf[head : start + 128 * t]`` the
    codec-2 body, its planes from ``start``, a multiple of 16.  ``per``:
    blocks a warp, else :func:`per_warp`'s."""
    global pack_launches
    _check(flat, "stream", 1)
    _check_cuda(flat, "stream")
    n = flat.shape[0]
    _check_n(n)
    if n == 0:
        raise ValueError("pack_compact needs a stream of at least one symbol")
    nb = -(-n // BLOCK)
    nnib = (nb + 1) // 2
    start = -(-(16 + nnib) // 16) * 16  # past the total and the header
    head = start - 8 - nnib
    buf = torch.empty(start + nb * BLOCK, dtype=torch.uint8, device=flat.device)
    per = _per(per, nb, compacting_k6=True)
    words = torch.empty(_COUNTERS + _ctas(nb, per), dtype=torch.int64, device=flat.device)
    lib = _build.load()
    with _on(flat.device):
        rc = lib.bitpack_pack_compact(flat.data_ptr(), buf.data_ptr(), head, words.data_ptr(),
                                      n, per, torch.cuda.current_stream().cuda_stream)
    pack_launches += 1
    raise_on(rc, "bitpack_pack_compact")
    return buf, head, start


def pack_stream(flat: torch.Tensor) -> torch.Tensor:
    """Compacting K6: uint8 ``[n]`` -> the codec-2 body on the same
    device.  On the card the body's length is known after the first
    fetch, the planes' total (8 bytes)."""
    global d2h_bytes
    if flat.device.type == "cpu":
        return pack_stream_plain(flat)
    _check(flat, "stream", 1)
    _check_cuda(flat, "stream")
    if flat.shape[0] == 0:  # the header alone, n = nb = 0: no kernel to launch
        return torch.zeros(8, dtype=torch.uint8, device=flat.device)
    buf, head, start = pack_compact(flat)
    total = int(buf[:8].view(torch.int64).item())
    d2h_bytes += 8
    return buf[head : start + _LANE * total]


def unpack_stream(body: torch.Tensor, n: int, per: Optional[int] = None) -> torch.Tensor:
    """Compacted K7: a codec-2 body (uint8, on the device, any alignment;
    checked on the host as :func:`check_body` does) of a stream of ``n``
    symbols -> uint8 ``[n]``.  Only the kept planes are read.  ``per``:
    blocks a warp, else :func:`per_warp`'s."""
    global unpack_launches
    if body.device.type == "cpu":
        return unpack_stream_plain(body, n)
    _check(body, "body", 1)
    _check_cuda(body, "body")
    _check_n(n)
    nb = -(-n // BLOCK)
    if body.shape[0] < 8 + (nb + 1) // 2:
        raise ValueError("truncated bitpack stream")
    out = torch.empty(nb * BLOCK, dtype=torch.uint8, device=body.device)
    if nb == 0:
        return out
    per = _per(per, nb)
    lib = _build.load()
    with _on(body.device):
        rc = lib.bitpack_unpack_compact(body.data_ptr(), out.data_ptr(), body.shape[0], n, per,
                                        torch.cuda.current_stream().cuda_stream)
    unpack_launches += 1
    raise_on(rc, "bitpack_unpack_compact")
    return out[:n]


# -- host framing -------------------------------------------------------------


def finalize_packed(packed: np.ndarray, widths: np.ndarray, nb: int, n: int) -> bytes:
    """Keep only the used planes of each block.

    Layout: u32 LE n, u32 LE nb, nb width nibbles (2 a byte, padded),
    then the kept planes one after another (128 bytes a plane).
    """
    packed = np.asarray(packed)[:nb]
    widths = np.asarray(widths)[:nb].astype(np.uint8)
    mask = np.arange(_SUB)[None, :] < widths[:, None]
    body = packed[mask]  # [sum(widths), 128]
    nib = widths.copy()
    if nib.size % 2:
        nib = np.append(nib, 0)
    nibbles = (nib[0::2] | (nib[1::2] << 4)).astype(np.uint8)
    return b"".join((
        int(n).to_bytes(4, "little"),
        int(nb).to_bytes(4, "little"),
        nibbles.tobytes(),
        body.tobytes(),
    ))


def _frame(data: bytes, expected_n=None) -> Tuple[int, np.ndarray, np.ndarray]:
    """The checks of :func:`expand_packed` up to its planes, in its order
    and with its errors: ``(n, widths [nb] uint8, planes [sum(widths), 128]
    uint8)``, the planes a view of ``data``."""
    if len(data) < 8:
        raise ValueError("truncated bitpack stream")
    n = int.from_bytes(data[0:4], "little")
    nb = int.from_bytes(data[4:8], "little")
    if expected_n is not None and n != expected_n:
        raise ValueError(f"bitpack stream size {n} does not match declared {expected_n}")
    if nb != -(-n // BLOCK):
        raise ValueError("bitpack block count does not match stream size")
    nnib = (nb + 1) // 2
    nibbles = np.frombuffer(data, np.uint8, count=nnib, offset=8)
    widths = np.empty(2 * nnib, np.uint8)
    widths[0::2] = nibbles & 0xF
    widths[1::2] = nibbles >> 4
    widths = widths[:nb]
    total_planes = int(widths.sum(dtype=np.int64))
    body = np.frombuffer(
        data, np.uint8, count=total_planes * _LANE, offset=8 + nnib
    ).reshape(total_planes, _LANE)
    return n, widths, body


def expand_packed(data: bytes, expected_n: int = None) -> Tuple[np.ndarray, int]:
    """Inverse of :func:`finalize_packed`: ``(expanded [nb, 8, 128] uint8,
    n)`` with the absent planes zero.

    ``expected_n``, when given, is the header-derived stream size, which
    the embedded one must equal (the bomb guard); a body shorter than its
    widths declare, or widths above 8, raise ValueError.
    """
    n, widths, body = _frame(data, expected_n)
    expanded = np.zeros((widths.size, _SUB, _LANE), np.uint8)
    mask = np.arange(_SUB)[None, :] < widths[:, None]
    expanded[mask] = body
    return expanded, n


def check_body(data: bytes, expected_n: int = None) -> int:
    """The host's checks of a codec-2 body before it is unpacked, with
    :func:`expand_packed`'s errors, without expanding it: returns ``n``."""
    n, widths, _ = _frame(data, expected_n)
    if widths.size and int(widths.max()) > _SUB:
        expand_packed(data, expected_n)  # raises numpy's error, as JAX's expander does
        raise ValueError("bitpack width above 8")
    return n


def pack_bytes(flat_u8, device="cuda") -> bytes:
    """Codec 2's write: K6 compacting on ``device`` -> the body's bytes.
    On the card: one copy of the stream over, the planes' total back,
    then exactly the body."""
    global h2d_bytes, d2h_bytes
    arr = np.asarray(flat_u8, dtype=np.uint8).reshape(-1)
    device = torch.device(device)
    if device.type == "cpu":
        return pack_stream(torch.from_numpy(arr.copy())).numpy().tobytes()
    staged = torch.empty(arr.size, dtype=torch.uint8, pin_memory=True)
    staged.numpy()[:] = arr
    flat = torch.empty(arr.size, dtype=torch.uint8, device=device)
    flat.copy_(staged, non_blocking=True)
    h2d_bytes += arr.size
    body = pack_stream(flat)
    out = torch.empty(body.shape[0], dtype=torch.uint8, pin_memory=True)
    out.copy_(body, non_blocking=True)
    torch.cuda.current_stream(body.device).synchronize()
    d2h_bytes += body.shape[0]
    return out.numpy().tobytes()


def unpack_bytes(data: bytes, expected_n: int = None, device="cuda") -> np.ndarray:
    """Codec 2's read: the host's checks (:func:`check_body`), K7 on
    ``device`` -> uint8 ``[n]``.  On the card: one copy of the body over,
    placed so that its planes start on a 16-byte boundary, and the ``n``
    symbols back."""
    global h2d_bytes, d2h_bytes
    n = check_body(data, expected_n)
    if n == 0:
        return np.zeros(0, np.uint8)
    device = torch.device(device)
    if device.type == "cpu":
        return unpack_stream(torch.frombuffer(bytearray(data), dtype=torch.uint8), n).numpy()
    staged = torch.empty(len(data), dtype=torch.uint8, pin_memory=True)
    staged.numpy()[:] = np.frombuffer(data, np.uint8)
    pad = -(8 + (-(-n // BLOCK) + 1) // 2) % 16
    buf = torch.empty(pad + len(data), dtype=torch.uint8, device=device)
    buf[pad:].copy_(staged, non_blocking=True)
    h2d_bytes += len(data)
    flat = unpack_stream(buf[pad:], n)
    out = torch.empty(n, dtype=torch.uint8, pin_memory=True)
    out.copy_(flat, non_blocking=True)
    torch.cuda.current_stream(flat.device).synchronize()
    d2h_bytes += n
    return out.numpy()
