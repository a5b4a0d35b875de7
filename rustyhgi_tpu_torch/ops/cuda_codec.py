"""The codec's five CUDA kernels, on the row-major grid and the subband layout.

Counterpart of ``rustyhgi_tpu/ops/pallas_codec.py``:

* K1 :func:`encode_plane` replaces ``_encode_batch``;
* K2 :func:`decode_plane` replaces ``_decode_batch``;
* K3 :func:`encode_subbands` replaces ``_encode_sub_batch``;
* K4 :func:`assemble_grid` replaces ``_repack_words``;
* K5 :func:`decode_subbands` and :func:`decode_preview` replace
  ``_decode_sub_batch`` (K4's words fed into K2's decode): K5 reads the
  quads directly.

The kernels live in ``csrc/hgi_codec.cu`` (its header note says what they
compute, what bounds them on the card, and why the design is what it is)
and are built by :mod:`._build` at first use.  The fast mode's device
coders, in ``csrc/hgi_entropy.cu`` of the same library, have wrappers of
their own: X1 in :mod:`.tpurans`, K6 and K7 in :mod:`.bitpack`.  In
``write_fast`` K1's grid goes on the device straight into X1.

A wrapper takes its kernel's plain version (:mod:`.pyramid`) for a tensor
on the CPU, and only then.  For a CUDA tensor it launches the kernel or
raises: it checks the dtype (uint8), rank (2 or 3), contiguity and, for
the subband layout, every shape, and raises when the kernel reports an
error.  The kernels cover every depth, shape, predictor and quantizer
table, so no CUDA configuration routes to the plain version.

``encode_launches``, ``decode_launches``, ``encode_subbands_launches``,
``assemble_launches`` and ``decode_subbands_launches`` count the calls of
each kernel's C entry point (each runs the whole level loop), so a run can
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

from ..dyadic import canvas_shapes, cdiv, effective_levels
from . import _build, pyramid
from .predictors import PREDICTORS, check_predictor

__all__ = [
    "encode_plane",
    "decode_plane",
    "encode_subbands",
    "assemble_grid",
    "decode_subbands",
    "decode_preview",
    "encode_launches",
    "decode_launches",
    "encode_subbands_launches",
    "assemble_launches",
    "decode_subbands_launches",
]

encode_launches = 0
decode_launches = 0
encode_subbands_launches = 0
assemble_launches = 0
decode_subbands_launches = 0

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


# -- subband layout (K3, K4, K5) ----------------------------------------------


def _ptrs(tensors) -> ctypes.Array:
    """A host array of the tensors' device pointers."""
    return (ctypes.c_void_p * len(tensors))(*(t.data_ptr() for t in tensors))


def _check_layout(anchors, subbands, h: int, w: int, levels: int, upto: int):
    """Check a CUDA subband layout of depth ``levels`` for an ``h x w``
    plane, of which the first ``upto`` levels are read; returns the batch
    and the flat list of the quads read."""
    b, _, _ = _check_cuda(anchors, "anchors")
    if max(h, w) > _MAX_DIM or min(h, w) < 0:
        raise ValueError(f"shape {(h, w)} is beyond the kernels' range")
    lead = tuple(anchors.shape[:-2])
    a_shape, q_shapes = canvas_shapes(h, w, levels)
    if tuple(anchors.shape[-2:]) != a_shape:
        raise ValueError(
            f"anchors shape {tuple(anchors.shape)} does not match {(h, w)} at "
            f"depth {levels}: expected {lead + a_shape}"
        )
    if len(subbands) < upto:
        raise ValueError(f"{upto} levels needed, {len(subbands)} given")
    flat = []
    for level, (quads, q_shape) in enumerate(zip(subbands[:upto], q_shapes)):
        if len(quads) != 3:
            raise ValueError(f"level {level} must hold 3 quads, got {len(quads)}")
        for q in quads:
            _check_cuda(q, f"level {level} quad")
            if q.device != anchors.device or tuple(q.shape) != lead + q_shape:
                raise ValueError(
                    f"level {level} quad {tuple(q.shape)} on {q.device}: expected "
                    f"{lead + q_shape} on {anchors.device}"
                )
            flat.append(q)
    return b, flat


def encode_subbands(
    image: torch.Tensor,
    levels: int,
    table: Optional[torch.Tensor] = None,
    predictor: str = "crossed",
    want_recon: bool = True,
):
    """K3: uint8 ``[H, W]``/``[B, H, W]`` -> ``(anchors, subbands, recon)``.

    Same contract as :func:`.pyramid.encode_subbands`, padding residuals
    included.
    """
    global encode_subbands_launches
    predictor = check_predictor(predictor)
    if image.device.type == "cpu":
        return pyramid.encode_subbands(image, levels, table, predictor, want_recon)
    b, h, w = _check_cuda(image, "image")
    lv = effective_levels(levels, h, w)
    lead = tuple(image.shape[:-2])
    a_shape, q_shapes = canvas_shapes(h, w, lv)
    anchors = image.new_empty(lead + a_shape)
    subbands = [tuple(image.new_empty(lead + s) for _ in range(3)) for s in q_shapes]
    tab = None if table is None else _table_bytes(table)
    recon = image if tab is None else torch.empty_like(image)
    if image.numel():
        lib = _build.load()
        with torch.cuda.device(image.device):
            stream = torch.cuda.current_stream().cuda_stream
            rc = lib.hgi_encode_subbands(
                image.data_ptr(), anchors.data_ptr(),
                _ptrs([q for quads in subbands for q in quads]),
                None if tab is None else recon.data_ptr(), tab,
                b, h, w, lv, PREDICTORS[predictor], stream,
            )
        encode_subbands_launches += 1
        _raise_on(lib, rc, "hgi_encode_subbands")
    return anchors, subbands, (recon if want_recon else None)


def assemble_grid(anchors: torch.Tensor, subbands, shape: Tuple[int, int]) -> torch.Tensor:
    """K4: the subband layout -> the row-major uint8 grid of ``shape``.

    Same contract as :func:`.pyramid.assemble_grid`: the depth is
    ``len(subbands)``.
    """
    global assemble_launches
    if anchors.device.type == "cpu":
        return pyramid.assemble_grid(anchors, subbands, shape)
    h, w = (int(d) for d in shape)
    lv = len(subbands)
    b, flat = _check_layout(anchors, subbands, h, w, lv, lv)
    grid = anchors.new_empty((*anchors.shape[:-2], h, w))
    if grid.numel() == 0:
        return grid
    lib = _build.load()
    with torch.cuda.device(anchors.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.hgi_assemble_grid(
            anchors.data_ptr(), _ptrs(flat), grid.data_ptr(), b, h, w, lv, stream,
        )
    assemble_launches += 1
    _raise_on(lib, rc, "hgi_assemble_grid")
    return grid


def decode_preview(
    anchors: torch.Tensor,
    subbands,
    shape: Tuple[int, int],
    levels: int,
    upto: int,
    predictor: str = "crossed",
) -> torch.Tensor:
    """K5 stopped after ``upto`` levels: the image sampled every
    ``2**(L-upto)`` pixels, as :func:`.pyramid.decode_preview`."""
    global decode_subbands_launches
    predictor = check_predictor(predictor)
    if anchors.device.type == "cpu":
        return pyramid.decode_preview(anchors, subbands, shape, levels, upto, predictor)
    h, w = (int(d) for d in shape)
    lv = effective_levels(levels, h, w)
    upto = max(0, min(int(upto), lv))
    b, flat = _check_layout(anchors, subbands, h, w, lv, upto)
    s = 1 << (lv - upto)
    out = anchors.new_empty((*anchors.shape[:-2], cdiv(h, s), cdiv(w, s)))
    if out.numel() == 0:
        return out
    lib = _build.load()
    with torch.cuda.device(anchors.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.hgi_decode_subbands(
            anchors.data_ptr(), _ptrs(flat), out.data_ptr(), b, h, w, lv, upto,
            PREDICTORS[predictor], stream,
        )
    decode_subbands_launches += 1
    _raise_on(lib, rc, "hgi_decode_subbands")
    return out


def decode_subbands(
    anchors: torch.Tensor,
    subbands,
    shape: Tuple[int, int],
    levels: int,
    predictor: str = "crossed",
) -> torch.Tensor:
    """K5: the subband layout -> the uint8 image of ``shape``."""
    return decode_preview(anchors, subbands, shape, levels, levels, predictor)
