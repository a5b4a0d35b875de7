"""The codec's two CUDA kernels, K1 (encode) and K2 (decode).

Counterpart of ``rustyhgi_tpu/ops/pallas_codec.py``: K1 replaces
``_encode_batch`` and K2 ``_decode_batch``.  The kernels live in
``csrc/hgi_codec.cu`` (its header note says what they compute, what
bounds them on the card, and why the design is what it is) and are built
by :mod:`._build` at first use.

A wrapper takes its kernel's plain version (:mod:`.pyramid`) for a tensor
on the CPU, and only then.  For a CUDA tensor it launches the kernel or
raises: it checks the dtype (uint8), rank (2 or 3) and contiguity, and
raises when the kernel reports an error.  The kernels cover every depth,
shape, predictor and quantizer table, so no CUDA configuration routes to
the plain version.

``encode_launches`` and ``decode_launches`` count the calls of each
kernel's C entry point (each runs the whole level loop), so a run can
show that it went through the kernels.

The quantizer table lives in the library's ``__constant__`` memory and is
copied there on the current stream before each lossy encode's launches,
so calls on one stream may use different tables; lossy encodes with
different tables on two streams at once would race for it.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np
import torch

from ..dyadic import effective_levels
from . import _build, pyramid
from .predictors import PREDICTORS, check_predictor

__all__ = ["encode_plane", "decode_plane", "encode_launches", "decode_launches"]

encode_launches = 0
decode_launches = 0

# Corner offsets are formed as y0 * w + x0 + step in the kernels; keeping
# both dims at or below 2**30 keeps `1 << levels` and every step in int.
_MAX_DIM = 1 << 30
_MAX_BATCH = 1 << 31


def _check_cuda(x: torch.Tensor, name: str) -> Tuple[int, int, int]:
    if x.device.type != "cuda":
        raise ValueError(f"{name} must be a CPU or CUDA tensor, got {x.device}")
    if x.dtype != torch.uint8:
        raise ValueError(f"{name} must be uint8, got {x.dtype}")
    if x.dim() not in (2, 3):
        raise ValueError(f"{name} must be [H, W] or [B, H, W], got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    b = x.shape[0] if x.dim() == 3 else 1
    h, w = x.shape[-2:]
    if max(h, w) > _MAX_DIM or b >= _MAX_BATCH:
        raise ValueError(f"{name} shape {tuple(x.shape)} is beyond the kernels' range")
    return b, h, w


def _raise_on(lib, rc: int, entry: str) -> None:
    if rc != 0:
        msg = lib.hgi_error_string(rc).decode()
        raise RuntimeError(f"{entry} failed: CUDA error {rc} ({msg})")


def _table_bytes(table: torch.Tensor) -> ctypes.Array:
    t = table.detach().to("cpu", torch.int64).reshape(-1)
    if t.numel() != 256 or bool(((t < 0) | (t > 255)).any()):
        raise ValueError("quantizer table must hold 256 values in [0, 255]")
    return (ctypes.c_uint8 * 256).from_buffer_copy(t.numpy().astype(np.uint8))


def encode_plane(
    image: torch.Tensor,
    levels: int,
    table: Optional[torch.Tensor] = None,
    predictor: str = "crossed",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1: uint8 ``[H, W]``/``[B, H, W]`` -> ``(grid, recon)``.

    Same contract as :func:`.pyramid.encode_plane`: ``table`` None is the
    lossless path, and ``recon`` is then ``image`` itself.
    """
    global encode_launches
    predictor = check_predictor(predictor)
    if image.device.type == "cpu":
        return pyramid.encode_plane(image, levels, table, predictor)
    b, h, w = _check_cuda(image, "image")
    tab = None if table is None else _table_bytes(table)
    grid = torch.empty_like(image)
    recon = image if tab is None else torch.empty_like(image)
    if image.numel() == 0:
        return grid, recon
    lib = _build.load()
    with torch.cuda.device(image.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.hgi_encode(
            image.data_ptr(), grid.data_ptr(),
            None if tab is None else recon.data_ptr(), tab,
            b, h, w, effective_levels(levels, h, w), PREDICTORS[predictor],
            stream,
        )
    encode_launches += 1
    _raise_on(lib, rc, "hgi_encode")
    return grid, recon


def decode_plane(
    grid: torch.Tensor, levels: int, predictor: str = "crossed"
) -> torch.Tensor:
    """K2: uint8 ``[H, W]``/``[B, H, W]`` residual grid -> image."""
    global decode_launches
    predictor = check_predictor(predictor)
    if grid.device.type == "cpu":
        return pyramid.decode_plane(grid, levels, predictor)
    b, h, w = _check_cuda(grid, "grid")
    out = torch.empty_like(grid)
    if grid.numel() == 0:
        return out
    lib = _build.load()
    with torch.cuda.device(grid.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.hgi_decode(
            grid.data_ptr(), out.data_ptr(), b, h, w,
            effective_levels(levels, h, w), PREDICTORS[predictor], stream,
        )
    decode_launches += 1
    _raise_on(lib, rc, "hgi_decode")
    return out
