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

All arithmetic runs in int32: the crossed tree sums to 1020, and ``& 255``
reproduces the reference's u8 wrapping (encoder.rs:53,63).  The CPU tests
hold this module against ``rustyhgi_tpu.oracle``, and ``chip_smoke.py``
holds the kernels against it on the card.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..dyadic import effective_levels
from . import predictors

__all__ = ["encode_plane", "decode_plane"]

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
    sub = step >> 1
    return ((0, sub), (sub, 0), (sub, sub))


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
            q = table[diff]
            fix = (p + q > 255) != (p + diff > 255)
            g = torch.where(fix, diff, q)
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
