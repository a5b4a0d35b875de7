"""The plain PyTorch version of the whole codec.

Counterpart of the dyadic engine ``rustyhgi_tpu/ops/pyramid.py`` and the
plain version of the CUDA kernels in :mod:`.cuda_codec`.  It runs the
reference's per-level sweep (src/encoder.rs:39-71, src/decoder.rs:18-46)
as strided slices, one pass per level, using two structural facts
(SURVEY.md §3.5):

1. a refined pixel reads only the 4 corners of its enclosing cell, all
   written at strictly coarser levels, so a level has no inner dependency;
2. the prediction depends only on those corners, so the three refined
   pixels of a cell share one prediction.

For level ``l`` of ``L`` (``step = 2**(L-l)``, ``sub = step/2``) the cell
corners are the ``step`` lattice ``x[..., ::step, ::step]``, zero-padded
by one on the right and bottom: that padding is the reference's rule that
out-of-bounds corners read 0 (interpolator.rs:75-82).  The refined pixels
are the three slices at offsets ``(0, sub)``, ``(sub, 0)`` and
``(sub, sub)``; a slice that starts outside the image is empty.

The subband functions (counterparts of ``encode_subbands``,
``decode_subbands``, ``decode_preview``, ``assemble_grid`` and
``split_grid`` of the JAX engine) work on the canvas: the image
zero-padded up to multiples of ``2**L``.  Each quad of level ``l`` is one
refined slice of the canvas, ``(hp >> (L-l)) x (wp >> (L-l))``; a
reconstruction in the padding is set to 0 after each level, which is the
out-of-bounds-reads-0 rule again, and a residual in the padding is
``code(0 - pred)``, as the JAX engine emits it.

All arithmetic runs in int32: the crossed tree sums to 1020, and ``& 255``
reproduces the reference's u8 wrapping (encoder.rs:53,63).  The CPU tests
hold this module against ``rustyhgi_tpu.oracle`` and the JAX engines, and
``chip_smoke.py`` holds the kernels against it on the card.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..dyadic import cdiv, effective_levels
from . import predictors

__all__ = [
    "encode_plane",
    "decode_plane",
    "encode_subbands",
    "decode_subbands",
    "decode_preview",
    "assemble_grid",
    "split_grid",
]

_I32 = torch.int32


def _check(x: torch.Tensor, name: str) -> None:
    if x.dtype != torch.uint8 or x.dim() not in (2, 3):
        raise ValueError(
            f"{name} must be uint8 [H, W] or [B, H, W], got {x.dtype} "
            f"{tuple(x.shape)}"
        )


def _cell_prediction(lattice: torch.Tensor, tree) -> torch.Tensor:
    """One prediction per cell of an int32 corner lattice (OOB corners 0)."""
    p = F.pad(lattice, (0, 1, 0, 1))
    return tree(p[..., :-1, :-1], p[..., :-1, 1:], p[..., 1:, :-1], p[..., 1:, 1:])


def _refined(step: int):
    """Offsets of q01, q10 and q11 on the ``step`` lattice."""
    sub = step >> 1
    return ((0, sub), (sub, 0), (sub, sub))


def _pad_canvas(x: torch.Tensor, levels: int) -> torch.Tensor:
    """Zero-pad the last two dims up to multiples of ``2**levels``."""
    h, w = x.shape[-2:]
    step = 1 << levels
    return F.pad(x, (0, cdiv(w, step) * step - w, 0, cdiv(h, step) * step - h))


def _quantize(diff: torch.Tensor, p: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Quantized residual with the overflow fixup (encoder.rs:53-60): the
    raw difference where quantizing flips the carry past 255."""
    q = table[diff]
    return torch.where((p + q > 255) != (p + diff > 255), diff, q)


def encode_plane(
    image: torch.Tensor,
    levels: int,
    table: Optional[torch.Tensor] = None,
    predictor: str = "crossed",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Encode uint8 ``[H, W]`` or ``[B, H, W]`` -> ``(grid, recon)``, both uint8.

    ``table`` is the quantizer's 256-entry table (see
    :mod:`.quantizers`), or None for the identity.  With None the encode
    is lossless: each residual is the wrapped difference, and ``recon`` is
    ``image`` itself (no copy).  Otherwise each level predicts from the
    *reconstructed* coarser lattice (encoder.rs:63-64) and applies the
    overflow fixup: store the raw difference when quantizing flips the
    carry past 255 (encoder.rs:53-60).
    """
    _check(image, "image")
    tree = predictors.tree(predictor)
    h, w = image.shape[-2:]
    lv = effective_levels(levels, h, w)
    src = image.to(_I32)
    grid = src.clone()  # anchors stay raw (encoder.rs:26-37)
    if table is None:
        recon = src
    else:
        recon = src.clone()
        table = table.to(device=image.device, dtype=_I32)
    for level in range(lv):
        step = 1 << (lv - level)
        pred = _cell_prediction(recon[..., ::step, ::step], tree)
        for oy, ox in _refined(step):
            fine = src[..., oy::step, ox::step]
            p = pred[..., : fine.shape[-2], : fine.shape[-1]]
            diff = (fine - p) & 255
            if table is None:
                grid[..., oy::step, ox::step] = diff
                continue
            g = _quantize(diff, p, table)
            grid[..., oy::step, ox::step] = g
            recon[..., oy::step, ox::step] = (p + g) & 255
    if table is None:
        return grid.to(torch.uint8), image
    return grid.to(torch.uint8), recon.to(torch.uint8)


def decode_plane(
    grid: torch.Tensor, levels: int, predictor: str = "crossed"
) -> torch.Tensor:
    """Decode a uint8 ``[H, W]`` or ``[B, H, W]`` residual grid to the image.

    Mirrors decoder.rs:18-46: anchors are copied, then level by level
    ``image[q] = (pred + grid[q]) & 255``.
    """
    _check(grid, "grid")
    tree = predictors.tree(predictor)
    h, w = grid.shape[-2:]
    lv = effective_levels(levels, h, w)
    res = grid.to(_I32)
    out = res.clone()
    for level in range(lv):
        step = 1 << (lv - level)
        pred = _cell_prediction(out[..., ::step, ::step], tree)
        for oy, ox in _refined(step):
            g = res[..., oy::step, ox::step]
            p = pred[..., : g.shape[-2], : g.shape[-1]]
            out[..., oy::step, ox::step] = (p + g) & 255
    return out.to(torch.uint8)


# -- subband layout ----------------------------------------------------------


def encode_subbands(
    image: torch.Tensor,
    levels: int,
    table: Optional[torch.Tensor] = None,
    predictor: str = "crossed",
    want_recon: bool = True,
):
    """Encode uint8 ``[H, W]``/``[B, H, W]`` to ``(anchors, subbands, recon)``.

    ``anchors`` is the ``2**L`` lattice of the canvas and ``subbands[l]``
    the ``(q01, q10, q11)`` residual quads of level ``l``, coarsest first,
    all uint8 in canvas shapes; the values are :func:`encode_plane`'s grid
    where the pixel lies in the image.  ``recon`` is as in
    :func:`encode_plane` (``image`` itself when lossless), or None with
    ``want_recon=False``.
    """
    _check(image, "image")
    tree = predictors.tree(predictor)
    h, w = image.shape[-2:]
    lv = effective_levels(levels, h, w)
    src = _pad_canvas(image.to(_I32), lv)
    anchors = src[..., :: 1 << lv, :: 1 << lv].to(torch.uint8)
    if table is None:
        recon = src  # the canvas padding already reads 0
    else:
        recon = src.clone()
        table = table.to(device=image.device, dtype=_I32)
    subbands = []
    for level in range(lv):
        step = 1 << (lv - level)
        pred = _cell_prediction(recon[..., ::step, ::step], tree)
        quads = []
        for oy, ox in _refined(step):
            diff = (src[..., oy::step, ox::step] - pred) & 255
            if table is None:
                quads.append(diff.to(torch.uint8))
                continue
            g = _quantize(diff, pred, table)
            quads.append(g.to(torch.uint8))
            recon[..., oy::step, ox::step] = (pred + g) & 255
        if table is not None:
            recon[..., h:, :] = 0
            recon[..., :, w:] = 0
        subbands.append(tuple(quads))
    if not want_recon:
        return anchors, subbands, None
    if table is None:
        return anchors, subbands, image
    return anchors, subbands, recon[..., :h, :w].to(torch.uint8)


def decode_preview(
    anchors: torch.Tensor,
    subbands,
    shape: Tuple[int, int],
    levels: int,
    upto: int,
    predictor: str = "crossed",
) -> torch.Tensor:
    """Decode only the coarsest ``upto`` levels of a subband layout.

    Returns the full image sampled every ``s = 2**(L-upto)`` pixels,
    ``(ceil(H/s), ceil(W/s))``, exactly as the JAX ``decode_preview``.
    ``subbands`` needs only its first ``upto`` levels.  The decode runs
    on the preview's own canvas, where level ``l`` has step
    ``2**(upto-l)`` and reads the archive's level-``l`` quads.
    """
    _check(anchors, "anchors")
    tree = predictors.tree(predictor)
    h, w = shape
    lv = effective_levels(levels, h, w)
    upto = max(0, min(int(upto), lv))
    s = 1 << (lv - upto)
    ho, wo = cdiv(h, s), cdiv(w, s)
    top = 1 << upto
    out = torch.zeros(
        (*anchors.shape[:-2], cdiv(ho, top) * top, cdiv(wo, top) * top),
        dtype=_I32, device=anchors.device,
    )
    out[..., ::top, ::top] = anchors.to(_I32)
    for level in range(upto):
        step = 1 << (upto - level)
        pred = _cell_prediction(out[..., ::step, ::step], tree)
        for (oy, ox), q in zip(_refined(step), subbands[level]):
            out[..., oy::step, ox::step] = (pred + q.to(_I32)) & 255
        out[..., ho:, :] = 0
        out[..., :, wo:] = 0
    return out[..., :ho, :wo].to(torch.uint8)


def decode_subbands(
    anchors: torch.Tensor,
    subbands,
    shape: Tuple[int, int],
    levels: int,
    predictor: str = "crossed",
) -> torch.Tensor:
    """Decode a subband layout to the uint8 image of ``shape``: the
    preview carried through every level."""
    return decode_preview(anchors, subbands, shape, levels, levels, predictor)


def assemble_grid(anchors: torch.Tensor, subbands, shape: Tuple[int, int]) -> torch.Tensor:
    """Interleave the subband layout into the row-major grid, cropped to
    ``shape``; the depth is ``len(subbands)``.  Layout only."""
    _check(anchors, "anchors")
    lv = len(subbands)
    step = 1 << lv
    ah, aw = anchors.shape[-2:]
    grid = torch.zeros(
        (*anchors.shape[:-2], ah * step, aw * step), dtype=torch.uint8,
        device=anchors.device,
    )
    grid[..., ::step, ::step] = anchors
    for level, quads in enumerate(subbands):
        st = 1 << (lv - level)
        for (oy, ox), q in zip(_refined(st), quads):
            grid[..., oy::st, ox::st] = q
    h, w = shape
    return grid[..., :h, :w].contiguous()


def split_grid(grid: torch.Tensor, levels: int):
    """Inverse of :func:`assemble_grid`: the row-major grid to
    ``(anchors, subbands)`` in canvas shapes (the padding reads 0)."""
    _check(grid, "grid")
    lv = effective_levels(levels, *grid.shape[-2:])
    canvas = _pad_canvas(grid, lv)
    anchors = canvas[..., :: 1 << lv, :: 1 << lv].contiguous()
    subbands = []
    for level in range(lv):
        step = 1 << (lv - level)
        subbands.append(
            tuple(canvas[..., oy::step, ox::step].contiguous() for oy, ox in _refined(step))
        )
    return anchors, subbands
