"""Bit-plane pack (K6) and unpack (K7), codec 2 of ``.thgi``.

Counterpart of ``rustyhgi_tpu/ops/pallas_kernels.py``, byte for byte.
Residual bytes are zigzag-folded (0, 255, 1, 254, ... -> 0, 1, 2, 3, ...),
the stream is cut into blocks of 1024 symbols, each an ``[8, 128]`` tile
(``block[k, j] = flat[1024 * i + 128 * k + j]``, zero-padded at the end),
and each block keeps only its ``width`` lowest bit-planes, ``width`` being
the bit length of the block's largest folded value.  Plane ``r`` is one
row of 128 bytes: ``out[r, j] = sum_k bit_r(z[k, j]) << k``.

The device emits all 8 planes of every block plus the widths; the host
keeps the used ones (:func:`finalize_packed`) and, on read, re-expands
them with zeros (:func:`expand_packed`).  The TPU kernels pad to chunks of
128 blocks; here the padding stops at whole blocks, and the bytes are the
same because only the real blocks are framed.

:func:`pack_blocks` and :func:`unpack_blocks` launch the CUDA kernels
``bitpack_pack`` and ``bitpack_unpack`` of ``csrc/hgi_entropy.cu`` for a
CUDA tensor (``pack_launches`` and ``unpack_launches`` count them); for a
CPU tensor, and only then, they take the plain versions
:func:`pack_plain` and :func:`unpack_plain`.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from . import _build

__all__ = [
    "BLOCK",
    "zigzag",
    "unzigzag",
    "pack_plain",
    "unpack_plain",
    "pack_blocks",
    "unpack_blocks",
    "finalize_packed",
    "expand_packed",
    "pack_bytes",
    "unpack_bytes",
    "pack_launches",
    "unpack_launches",
]

pack_launches = 0
unpack_launches = 0

BLOCK = 1024  # symbols per block: an [8, 128] tile
_SUB, _LANE = 8, 128


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


def _raise_on(lib, rc: int, entry: str) -> None:
    if rc != 0:
        msg = lib.hgi_error_string(rc).decode()
        raise RuntimeError(f"{entry} failed: CUDA error {rc} ({msg})")


def _check_cuda(x: torch.Tensor, name: str) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{name} must be a CPU or CUDA tensor, got {x.device}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def pack_blocks(flat: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """K6: uint8 ``[n]`` -> ``(packed [nb, 8, 128], widths [nb] int32,
    nb)``; only the first ``widths[i]`` planes of block ``i`` carry data."""
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
    lib = _build.load()
    with torch.cuda.device(flat.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.bitpack_pack(flat.data_ptr(), packed.data_ptr(), widths.data_ptr(), n, nb, stream)
    pack_launches += 1
    _raise_on(lib, rc, "bitpack_pack")
    return packed, widths, nb


def unpack_blocks(expanded: torch.Tensor) -> torch.Tensor:
    """K7: bit-planes ``[nb, 8, 128]`` (absent planes zero) -> flat uint8
    ``[nb * 1024]``."""
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
    lib = _build.load()
    with torch.cuda.device(expanded.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.bitpack_unpack(expanded.data_ptr(), out.data_ptr(), nb, stream)
    unpack_launches += 1
    _raise_on(lib, rc, "bitpack_unpack")
    return out


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


def expand_packed(data: bytes, expected_n: int = None) -> Tuple[np.ndarray, int]:
    """Inverse of :func:`finalize_packed`: ``(expanded [nb, 8, 128] uint8,
    n)`` with the absent planes zero.

    ``expected_n``, when given, is the header-derived stream size, which
    the embedded one must equal (the bomb guard); a body shorter than its
    widths declare, or widths above 8, raise ValueError.
    """
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
    expanded = np.zeros((nb, _SUB, _LANE), np.uint8)
    mask = np.arange(_SUB)[None, :] < widths[:, None]
    expanded[mask] = body
    return expanded, n


def pack_bytes(flat_u8, device="cuda") -> bytes:
    """K6 on ``device`` and the host framing of a uint8 stream."""
    flat = torch.from_numpy(np.array(flat_u8, dtype=np.uint8).reshape(-1))
    packed, widths, nb = pack_blocks(flat.to(device))
    return finalize_packed(packed.cpu().numpy(), widths.cpu().numpy(), nb, flat.shape[0])


def unpack_bytes(data: bytes, expected_n: int = None, device="cuda") -> np.ndarray:
    """Inverse of :func:`pack_bytes`, K7 on ``device`` -> uint8 ``[n]``."""
    expanded, n = expand_packed(data, expected_n=expected_n)
    if n == 0:
        return np.zeros(0, np.uint8)
    flat = unpack_blocks(torch.from_numpy(expanded).to(device))
    return flat[:n].cpu().numpy()
