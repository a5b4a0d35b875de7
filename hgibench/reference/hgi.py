"""The HGI pyramid in plain NumPy: the benchmark's reference codec.

A straightforward restatement of the reference codec (RustyHGI
src/encoder.rs, src/decoder.rs, src/interpolator.rs, src/quantizator.rs),
written level by level on strided views.  For level ``l`` of ``L`` the
cell corners are the ``step = 2**(L-l)`` lattice, zero-padded by one on
the right and bottom (out-of-bounds corners read 0), and the three
refined pixels of a cell, at offsets ``(0, sub)``, ``(sub, 0)`` and
``(sub, sub)``, share the cell's prediction.  Anchors are stored raw.
A lossy level predicts from the reconstruction of the coarser lattice
and keeps the raw residual where quantizing would flip the carry past
255 (encoder.rs:53-60).  All arithmetic is int32; ``& 255`` is the u8
wrap.  Works on ``[H, W]`` or ``[B, H, W]`` uint8 arrays.
"""

from __future__ import annotations

import numpy as np

__all__ = ["ERRORS", "TAGS", "PREDICTOR_TAGS", "effective_levels", "table", "encode", "decode"]

# Preset -> (container tag, max absolute error): quantizator.rs:1-48.
ERRORS = {"lossless": 0, "low": 10, "medium": 20, "high": 30}
TAGS = {"lossless": 0, "low": 1, "medium": 2, "high": 3}
# Interpolation tags of archive.rs (Crossed 0, Line 1, Previous 2); left_top
# archives carry Previous.
PREDICTOR_TAGS = {"crossed": 0, "left_top": 2}


def effective_levels(levels: int, h: int, w: int) -> int:
    """Depths beyond ceil(log2(max(h, w))) touch no pixel: clamp to it."""
    return max(0, min(levels, (max(h, w) - 1).bit_length()))


def table(error: int) -> np.ndarray:
    """The linear quantizer's table of the wrapped residual byte
    (quantizator.rs:50-61): ``((x + e) // (2e + 1)) * (2e + 1)``, as u8."""
    scale = 2 * error + 1
    x = np.arange(256, dtype=np.int64)
    return (((x + error) // scale) * scale & 255).astype(np.int32)


def _avg(a, b):
    return (a + b + 1) >> 1


def _predict(corners: np.ndarray, predictor: str) -> np.ndarray:
    """One prediction per cell of an int32 corner lattice."""
    p = np.zeros(corners.shape[:-2] + (corners.shape[-2] + 1, corners.shape[-1] + 1), np.int32)
    p[..., :-1, :-1] = corners
    tl, tr, bl, br = p[..., :-1, :-1], p[..., :-1, 1:], p[..., 1:, :-1], p[..., 1:, 1:]
    if predictor == "left_top":
        return tl.copy()
    if predictor != "crossed":
        raise ValueError(f"unknown predictor {predictor!r}")
    return (_avg(tl, tr) + _avg(bl, br) + _avg(tl, bl) + _avg(tr, br)) >> 2


def _offsets(step: int):
    sub = step >> 1
    return ((0, sub), (sub, 0), (sub, sub))


def encode(image: np.ndarray, levels: int, error: int, predictor: str = "crossed"):
    """uint8 image -> ``(grid, recon)``, both uint8 of the image's shape."""
    src = np.asarray(image).astype(np.int32)
    h, w = src.shape[-2:]
    lv = effective_levels(levels, h, w)
    grid = src.copy()
    recon = src.copy()
    q = None if error == 0 else table(error)
    for level in range(lv):
        step = 1 << (lv - level)
        pred = _predict(recon[..., ::step, ::step], predictor)
        for oy, ox in _offsets(step):
            fine = src[..., oy::step, ox::step]
            p = pred[..., : fine.shape[-2], : fine.shape[-1]]
            diff = (fine - p) & 255
            if q is not None:
                quant = q[diff]
                diff = np.where((p + quant > 255) != (p + diff > 255), diff, quant)
            grid[..., oy::step, ox::step] = diff
            recon[..., oy::step, ox::step] = (p + diff) & 255
    return grid.astype(np.uint8), recon.astype(np.uint8)


def decode(grid: np.ndarray, levels: int, predictor: str = "crossed", skip_finest: bool = False):
    """uint8 residual grid -> uint8 image (decoder.rs:18-46).

    ``skip_finest`` reads the finest level's residuals as 0: a decode that
    keeps the coarser levels only, the benchmark's control of a read.
    """
    res = np.asarray(grid).astype(np.int32)
    h, w = res.shape[-2:]
    lv = effective_levels(levels, h, w)
    out = res.copy()
    for level in range(lv):
        step = 1 << (lv - level)
        pred = _predict(out[..., ::step, ::step], predictor)
        for oy, ox in _offsets(step):
            g = res[..., oy::step, ox::step]
            if skip_finest and level == lv - 1:
                g = np.zeros_like(g)
            p = pred[..., : g.shape[-2], : g.shape[-1]]
            out[..., oy::step, ox::step] = (p + g) & 255
    return out.astype(np.uint8)
