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
the subband layout, every shape (the shapes a layout must have are kept
per plane shape, depth, batch and device, and all its quads are compared
with them in one pass), and raises when the kernel reports an error.  A
wrapper makes the tensor's device current only when it is not already.
The kernels cover every depth, shape, predictor and quantizer
table, so no CUDA configuration routes to the plain version.

``encode_launches``, ``decode_launches``, ``encode_subbands_launches``,
``assemble_launches`` and ``decode_subbands_launches`` count the calls of
each kernel's C entry point (each runs the whole level loop), so a run can
show that it went through the kernels.

The quantizer table reaches the kernels by value, as a 256-byte launch
argument that each block copies to shared memory, so calls on any
streams may use any tables at once.  :func:`table_arg` checks and
converts a table tensor once and keeps the result for as long as the
tensor lives unchanged, so a codec's calls do no host work for it.

K1's lossy path tiles its finest ``min(L, FINE_LEVELS)`` levels in
``TILE`` tiles in one launch, and launches once more per coarser level;
its lossless path is one launch at any depth.  K3 is K1 writing quads,
in the same two designs: its lossy tiles (the same ``TILE`` and
``FINE_LEVELS``; :func:`encode_subbands_tiled` takes others) are cut on
the canvas, and its lossless path is one launch at any depth.  K3 writes
the anchors and every quad into one buffer, each a contiguous view at a
16-byte aligned offset kept per plane shape, depth and batch, so a call
allocates one tensor (two with a recon).  K4 is one launch, a gather by
row class.  K4 and K5 take quads on any byte boundary, separately
allocated or views of one buffer.  K2 and K5 tile their
finest ``min(L, DECODE_FINE_LEVELS)`` levels (K5's preview:
``min(upto, DECODE_FINE_LEVELS)``) the same way, in tiles of
:func:`decode_tile`'s size, so they too are one launch at
``L <= DECODE_FINE_LEVELS``; :func:`decode_plane_tiled` and
:func:`decode_preview_tiled` take the tiling as :func:`encode_plane_tiled`
does.
"""

from __future__ import annotations

import ctypes
import functools
import weakref
from typing import Optional, Tuple

import numpy as np
import torch

from ..dyadic import canvas_shapes, cdiv, effective_levels
from . import _build, pyramid
from ._build import QTable, _on, raise_on
from .predictors import PREDICTORS, check_predictor

__all__ = [
    "encode_plane",
    "encode_plane_tiled",
    "decode_plane",
    "decode_plane_tiled",
    "encode_subbands",
    "encode_subbands_tiled",
    "assemble_grid",
    "decode_subbands",
    "decode_preview",
    "decode_preview_tiled",
    "table_arg",
    "TILE",
    "FINE_LEVELS",
    "DECODE_TILES",
    "decode_tile",
    "DECODE_FINE_LEVELS",
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

# Lossy K1's tiles (rows, columns: multiples of 16 and of 2**FINE_LEVELS)
# and the number of finest levels they take in one launch, chosen by
# ``python -m rustyhgi_tpu_torch.tools.chip_probe sweep``.
TILE = (64, 128)
FINE_LEVELS = 4
# K2's and K5's tiles and tiled levels, under the same rules and chosen by
# the same sweep; fine 0 runs every level in a launch of its own.  A call
# takes DECODE_TILES[1]; DECODE_TILES[0] when it would cut fewer of those
# than the card has SMs, as a preview does, so that no SM idles while one
# block's latency sets the time; DECODE_TILES[2] when it would cut more
# than DECODE_TILES_SWITCH (:func:`decode_tile`).
DECODE_TILES = ((32, 64), (64, 128), (128, 128))
DECODE_TILES_SWITCH = 1024
DECODE_FINE_LEVELS = 4

_NO_TABLE = QTable()  # the lossless paths read no table
_tables = {}  # id(tensor) -> (weakref to it, its version, QTable)


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


def _check_tiling(tile: Tuple[int, int], fine: int) -> Tuple[int, int]:
    """The tile's rows and columns, or ValueError unless the kernels take
    them: multiples of 16 and of ``2**fine``, ``fine`` in 0-5."""
    th, tw = (int(d) for d in tile)
    if not 0 <= fine <= 5 or min(th, tw) <= 0 or th % 16 or tw % 16 or (th | tw) % (1 << fine):
        raise ValueError(f"tile {tile} must be multiples of 16 and of 2**{fine}, fine in [0, 5]")
    return th, tw


def decode_tile(b: int, h: int, w: int, sms: int) -> Tuple[int, int]:
    """K2's and K5's tile for ``b`` planes of ``h x w`` on a card of
    ``sms`` SMs (see DECODE_TILES)."""
    th, tw = DECODE_TILES[1]
    n = b * cdiv(h, th) * cdiv(w, tw)
    return DECODE_TILES[0 if n < sms else 2 if n > DECODE_TILES_SWITCH else 1]


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def table_arg(table: torch.Tensor) -> QTable:
    """The kernels' by-value copy of a 256-entry quantizer table.

    Checked and converted once per tensor: the result is kept until the
    tensor dies or is changed in place (its version counter moves).
    Raises ValueError unless the table holds 256 values in [0, 255].
    """
    key = id(table)
    hit = _tables.get(key)
    if hit is not None and hit[0]() is table and hit[1] == table._version:
        return hit[2]
    t = table.detach().to("cpu", torch.int64).reshape(-1)
    if t.numel() != 256 or bool(((t < 0) | (t > 255)).any()):
        raise ValueError("quantizer table must hold 256 values in [0, 255]")
    arg = QTable.from_buffer_copy(t.numpy().astype(np.uint8).tobytes())
    _tables[key] = (weakref.ref(table, lambda _, key=key: _tables.pop(key, None)),
                    table._version, arg)
    return arg


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
    return encode_plane_tiled(image, levels, table, predictor)


def encode_plane_tiled(
    image: torch.Tensor,
    levels: int,
    table: Optional[torch.Tensor] = None,
    predictor: str = "crossed",
    tile: Tuple[int, int] = TILE,
    fine: int = FINE_LEVELS,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`encode_plane` with the lossy path's tiling given: ``tile``
    (rows, columns, multiples of 16 and of ``2**fine``) and ``fine``, the
    finest levels a tile runs (0-5).  The output does not depend on them;
    ``chip_probe sweep`` times each choice."""
    global encode_launches
    predictor = check_predictor(predictor)
    if image.device.type == "cpu":
        return pyramid.encode_plane(image, levels, table, predictor)
    th, tw = _check_tiling(tile, fine)
    b, h, w = _check_cuda(image, "image")
    tab = None if table is None else table_arg(table)
    grid = torch.empty_like(image)
    recon = image if tab is None else torch.empty_like(image)
    if image.numel() == 0:
        return grid, recon
    lib = _build.load()
    with _on(image.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.hgi_encode(
            image.data_ptr(), grid.data_ptr(),
            None if tab is None else recon.data_ptr(), _NO_TABLE if tab is None else tab,
            tab is not None,
            b, h, w, effective_levels(levels, h, w), PREDICTORS[predictor],
            th, tw, fine, stream,
        )
    encode_launches += 1
    raise_on(rc, "hgi_encode")
    return grid, recon


def decode_plane(
    grid: torch.Tensor, levels: int, predictor: str = "crossed"
) -> torch.Tensor:
    """K2: uint8 ``[H, W]``/``[B, H, W]`` residual grid -> image."""
    return decode_plane_tiled(grid, levels, predictor)


def decode_plane_tiled(
    grid: torch.Tensor,
    levels: int,
    predictor: str = "crossed",
    tile: Optional[Tuple[int, int]] = None,
    fine: int = DECODE_FINE_LEVELS,
) -> torch.Tensor:
    """:func:`decode_plane` with the tiling given, under the rules of
    :func:`encode_plane_tiled` (``tile`` None: :func:`decode_tile`);
    ``fine`` 0 launches every level on its own.  The output does not
    depend on them."""
    global decode_launches
    predictor = check_predictor(predictor)
    if grid.device.type == "cpu":
        return pyramid.decode_plane(grid, levels, predictor)
    th, tw = _check_tiling(tile or DECODE_TILES[0], fine)
    b, h, w = _check_cuda(grid, "grid")
    if tile is None:
        th, tw = decode_tile(b, h, w, _sms(grid.device.index))
    out = torch.empty_like(grid)
    if grid.numel() == 0:
        return out
    lib = _build.load()
    with _on(grid.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.hgi_decode(
            grid.data_ptr(), out.data_ptr(), b, h, w,
            effective_levels(levels, h, w), PREDICTORS[predictor], th, tw, fine, stream,
        )
    decode_launches += 1
    raise_on(rc, "hgi_decode")
    return out


# -- subband layout (K3, K4, K5) ----------------------------------------------


_VOID_PP = ctypes.POINTER(ctypes.c_void_p)


def _ptrs(tensors) -> ctypes.Array:
    """A host array of the tensors' device pointers."""
    return (ctypes.c_void_p * len(tensors))(*[t.data_ptr() for t in tensors])


_layouts = {}  # (h, w, levels, upto, lead, device) -> (anchors shape, quad shapes read)


def _expected_layout(h: int, w: int, levels: int, upto: int, lead: tuple, device):
    key = (h, w, levels, upto, lead, device)
    hit = _layouts.get(key)
    if hit is None:
        if len(_layouts) >= 256:
            _layouts.clear()
        a_shape, q_shapes = canvas_shapes(h, w, levels)
        hit = _layouts[key] = (lead + a_shape,
                               [lead + s for s in q_shapes[:upto] for _ in range(3)])
    return hit


def _check_layout(anchors, subbands, h: int, w: int, levels: int, upto: int):
    """Check a CUDA subband layout of depth ``levels`` for an ``h x w``
    plane, of which the first ``upto`` levels are read; returns the batch
    and the flat list of the quads read."""
    b, _, _ = _check_cuda(anchors, "anchors")
    if max(h, w) > _MAX_DIM or min(h, w) < 0:
        raise ValueError(f"shape {(h, w)} is beyond the kernels' range")
    device = anchors.device
    a_shape, q_shapes = _expected_layout(h, w, levels, upto, tuple(anchors.shape[:-2]), device)
    if anchors.shape != a_shape:
        raise ValueError(
            f"anchors shape {tuple(anchors.shape)} does not match {(h, w)} at "
            f"depth {levels}: expected {a_shape}"
        )
    if len(subbands) < upto:
        raise ValueError(f"{upto} levels needed, {len(subbands)} given")
    flat = [q for quads in subbands[:upto] for q in quads]
    if len(flat) != len(q_shapes) or not all(
        q.dtype == torch.uint8 and q.device == device and q.shape == s and q.is_contiguous()
        for q, s in zip(flat, q_shapes)
    ):
        _quad_fault(subbands[:upto], q_shapes[::3], device)
    return b, flat


def _quad_fault(subbands, q_shapes, device) -> None:
    """Raise ValueError naming the first quad the kernels do not take."""
    for level, (quads, q_shape) in enumerate(zip(subbands, q_shapes)):
        if len(quads) != 3:
            raise ValueError(f"level {level} must hold 3 quads, got {len(quads)}")
        for q in quads:
            _check_cuda(q, f"level {level} quad")
            if q.device != device or q.shape != q_shape:
                raise ValueError(
                    f"level {level} quad {tuple(q.shape)} on {q.device}: expected "
                    f"{q_shape} on {device}"
                )
    raise ValueError("the subband layout does not match its shapes")


_buffers = {}  # (h, w, levels, lead) -> _SubbandBuffer


class _SubbandBuffer:
    """Where K3's outputs lie in the one buffer it writes: the anchors and
    then each level's q01, q10, q11, each a contiguous ``shape`` at a
    16-byte aligned ``offset``; ``quad_offsets`` are the quads' as uint64,
    to which the buffer's address is added for the kernel's pointers."""

    __slots__ = ("size", "views", "quad_offsets")

    def __init__(self, h: int, w: int, levels: int, lead: tuple):
        a_shape, q_shapes = canvas_shapes(h, w, levels)
        shapes = [lead + a_shape] + [lead + s for s in q_shapes for _ in range(3)]
        views, size = [], 0
        for shape in shapes:
            # A contiguous tensor's strides: the product of the dims after each.
            strides = tuple(int(np.prod(shape[i + 1 :])) for i in range(len(shape)))
            views.append((shape, strides, size))
            size += -(-int(np.prod(shape)) // 16) * 16
        self.size = size
        self.views = tuple(views)
        self.quad_offsets = np.array([off for _, _, off in views[1:]], np.uint64)


def _subband_buffer(h: int, w: int, levels: int, lead: tuple) -> _SubbandBuffer:
    key = (h, w, levels, lead)
    hit = _buffers.get(key)
    if hit is None:
        if len(_buffers) >= 256:
            _buffers.clear()
        hit = _buffers[key] = _SubbandBuffer(h, w, levels, lead)
    return hit


def encode_subbands(
    image: torch.Tensor,
    levels: int,
    table: Optional[torch.Tensor] = None,
    predictor: str = "crossed",
    want_recon: bool = True,
):
    """K3: uint8 ``[H, W]``/``[B, H, W]`` -> ``(anchors, subbands, recon)``.

    Same contract as :func:`.pyramid.encode_subbands`, padding residuals
    included.  The anchors and every quad are contiguous views of one
    buffer, each on a 16-byte boundary.
    """
    return encode_subbands_tiled(image, levels, table, predictor, want_recon)


def encode_subbands_tiled(
    image: torch.Tensor,
    levels: int,
    table: Optional[torch.Tensor] = None,
    predictor: str = "crossed",
    want_recon: bool = True,
    tile: Tuple[int, int] = TILE,
    fine: int = FINE_LEVELS,
):
    """:func:`encode_subbands` with the lossy path's tiling given, under
    the rules of :func:`encode_plane_tiled`; the output does not depend on
    it.  With ``want_recon`` False no recon is written where no coarser
    level reads it: always when lossless, and at ``L <= fine``."""
    global encode_subbands_launches
    predictor = check_predictor(predictor)
    if image.device.type == "cpu":
        return pyramid.encode_subbands(image, levels, table, predictor, want_recon)
    th, tw = _check_tiling(tile, fine)
    b, h, w = _check_cuda(image, "image")
    lv = effective_levels(levels, h, w)
    layout = _subband_buffer(h, w, lv, tuple(image.shape[:-2]))
    buf = torch.empty(layout.size, dtype=torch.uint8, device=image.device)
    anchors, *quads = [buf.as_strided(shape, strides, off) for shape, strides, off in layout.views]
    subbands = [tuple(quads[i : i + 3]) for i in range(0, len(quads), 3)]
    tab = None if table is None else table_arg(table)
    if tab is None:
        recon = image
    elif want_recon or lv > fine:
        recon = torch.empty_like(image)
    else:
        recon = None
    if image.numel():
        lib = _build.load()
        ptrs = layout.quad_offsets + np.uint64(buf.data_ptr())
        with _on(image.device):
            stream = torch.cuda.current_stream().cuda_stream
            rc = lib.hgi_encode_subbands(
                image.data_ptr(), anchors.data_ptr(), ptrs.ctypes.data_as(_VOID_PP),
                None if tab is None or recon is None else recon.data_ptr(),
                _NO_TABLE if tab is None else tab,
                tab is not None, b, h, w, lv, PREDICTORS[predictor], th, tw, fine, stream,
            )
        encode_subbands_launches += 1
        raise_on(rc, "hgi_encode_subbands")
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
    with _on(anchors.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.hgi_assemble_grid(
            anchors.data_ptr(), _ptrs(flat), grid.data_ptr(), b, h, w, lv, stream,
        )
    assemble_launches += 1
    raise_on(rc, "hgi_assemble_grid")
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
    return decode_preview_tiled(anchors, subbands, shape, levels, upto, predictor)


def decode_preview_tiled(
    anchors: torch.Tensor,
    subbands,
    shape: Tuple[int, int],
    levels: int,
    upto: int,
    predictor: str = "crossed",
    tile: Optional[Tuple[int, int]] = None,
    fine: int = DECODE_FINE_LEVELS,
) -> torch.Tensor:
    """:func:`decode_preview` with the tiling given, as
    :func:`decode_plane_tiled` (in a block a tile)."""
    global decode_subbands_launches
    predictor = check_predictor(predictor)
    if anchors.device.type == "cpu":
        return pyramid.decode_preview(anchors, subbands, shape, levels, upto, predictor)
    h, w = (int(d) for d in shape)
    lv = effective_levels(levels, h, w)
    upto = max(0, min(int(upto), lv))
    s = 1 << (lv - upto)
    th, tw = _check_tiling(tile or DECODE_TILES[0], fine)
    b, flat = _check_layout(anchors, subbands, h, w, lv, upto)
    if tile is None:
        th, tw = decode_tile(b, cdiv(h, s), cdiv(w, s), _sms(anchors.device.index))
    out = anchors.new_empty((*anchors.shape[:-2], cdiv(h, s), cdiv(w, s)))
    if out.numel() == 0:
        return out
    lib = _build.load()
    with _on(anchors.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.hgi_decode_subbands(
            anchors.data_ptr(), _ptrs(flat), out.data_ptr(), b, h, w, lv, upto,
            PREDICTORS[predictor], th, tw, fine, stream,
        )
    decode_subbands_launches += 1
    raise_on(rc, "hgi_decode_subbands")
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
