"""Trusted scalar golden model of the HGI codec.

Counterpart of ``rustyhgi_tpu/oracle.py``, name for name: a tiny,
obviously-correct NumPy implementation of the exact semantics of the
reference encoder/decoder (reference: src/encoder.rs:39-71,
src/decoder.rs:18-46, src/interpolator.rs:57-91, src/quantizator.rs:36-73,
src/utils.rs:12-41).  It imports neither PyTorch nor JAX, so the port's
users hold the CUDA kernels against it with nothing else installed: the
CLI's ``--backend oracle`` and ``chip_probe validate`` read it.

It is deliberately written as per-pixel scalar loops mirroring the spec, not
for speed.  Use the codec (:class:`rustyhgi_tpu_torch.models.codec.HGICodec`)
or the native C++ codec (:mod:`rustyhgi_tpu_torch.ops.native`) for anything
larger than test images.

Semantics captured here (see SURVEY.md §3.5-3.6):

* Anchors: pixels with ``x % 2**L == 0 and y % 2**L == 0`` are stored raw
  (encoder.rs:26-37; decoder.rs:22-28).
* Level traversal: for level ``l`` in ``0..L``: ``e = L - l``,
  ``step = 2**e``, ``substep = 2**(e-1)``; phase A visits rows
  ``y % step == 0`` at columns ``x % step == substep``; phase B visits rows
  ``y % step == substep`` at all columns ``x % substep == 0``
  (utils.rs:12-41).
* Crossed prediction: the 4 corners of the enclosing ``step x step`` cell,
  out-of-bounds corners read as 0; integer rounding tree
  ``avg(a,b) = (a+b+1)>>1`` on the 4 edges then truncating ``>>2``
  (interpolator.rs:41-55,57-91).
* Linear quantizer: ``q(x) = ((x + e) // (2e+1)) * (2e+1)`` as u8, with
  error e in {0,10,20,30} (quantizator.rs:41-63).
* Residual arithmetic is mod-256; overflow fixup stores the raw diff when
  quantization flips the carry past 255 (encoder.rs:53-60).
* In-loop reconstruction: the encoder predicts later levels from
  *reconstructed* pixels (encoder.rs:63-64).
"""

from __future__ import annotations

import numpy as np

from .ops.quantizers import QuantizationLevel, linear_error, linear_table

__all__ = [
    "crossed_prediction",
    "oracle_encode",
    "oracle_decode",
    "traverse_level_coords",
]


def traverse_level_coords(level: int, levels: int, width: int, height: int):
    """Yield (x, y) in the exact order of the reference traversal.

    Mirrors utils.rs:12-41 (x1=0, x2=width, y1=0, y2=height).
    """
    e = levels - level
    step = 1 << e
    substep = 1 << (e - 1)

    line = 0
    while line < height:
        column = substep
        while column < width:  # phase A: horizontal midpoints
            yield column, line
            column += step
        line += substep
        if line >= height:
            break
        column = 0
        while column < width:  # phase B: new rows at fine spacing
            yield column, line
            column += substep
        line += substep


def left_top_prediction(image: np.ndarray, x: int, y: int, step: int) -> int:
    """LeftTop predictor (interpolator.rs:15-28): cell-origin value."""
    mask = step - 1
    return int(image[y & ~mask, x & ~mask])


def crossed_prediction(image: np.ndarray, x: int, y: int, step: int) -> int:
    """Crossed predictor for pixel (x=column, y=line) with cell size ``step``.

    interpolator.rs:57-91: corners of the enclosing cell, OOB -> 0, then the
    rounding tree of interpolator.rs:41-55.
    """
    h, w = image.shape
    mask = step - 1
    x0 = x & ~mask
    y0 = y & ~mask

    def px(xx: int, yy: int) -> int:
        if xx < w and yy < h:
            return int(image[yy, xx])
        return 0

    tl = px(x0, y0)
    tr = px(x0 + step, y0)
    bl = px(x0, y0 + step)
    br = px(x0 + step, y0 + step)

    def avg(a: int, b: int) -> int:
        return (a + b + 1) >> 1

    # The tree is symmetric in the four corners: the four cell-edge midpoint
    # averages (round-half-up), then their truncated mean.
    return (avg(tl, tr) + avg(bl, br) + avg(tl, bl) + avg(tr, br)) >> 2


_PREDICTORS = {
    "crossed": crossed_prediction,
    "left_top": left_top_prediction,
}


def oracle_encode(
    image: np.ndarray,
    levels: int,
    quantization: QuantizationLevel = QuantizationLevel.MEDIUM,
    predictor: str = "crossed",
) -> np.ndarray:
    """Encode a uint8 [H, W] plane -> residual grid uint8 [H, W].

    Mirrors encoder.rs:39-71 exactly (including in-loop reconstruction).
    """
    predict = _PREDICTORS[predictor]
    image = np.array(image, dtype=np.uint8, copy=True)
    h, w = image.shape
    grid = np.zeros((h, w), dtype=np.uint8)
    table = linear_table(quantization)

    # Anchor lattice (encoder.rs:26-37).
    astep = 1 << levels
    grid[0::astep, 0::astep] = image[0::astep, 0::astep]

    for level in range(levels):
        step = 1 << (levels - level)  # interpolate() is called with level+1
        for x, y in traverse_level_coords(level, levels, w, h):
            pred = predict(image, x, y, step)
            actual = int(image[y, x])
            diff = (actual - pred) & 0xFF
            qdiff = int(table[diff])
            overflow = pred + qdiff > 255
            overflow_expected = pred + diff > 255
            if overflow != overflow_expected:  # encoder.rs:56-60
                qdiff = diff
            grid[y, x] = qdiff
            image[y, x] = (pred + qdiff) & 0xFF  # in-loop reconstruction
    return grid


def oracle_decode(
    grid: np.ndarray, levels: int, predictor: str = "crossed"
) -> np.ndarray:
    """Decode a residual grid uint8 [H, W] -> image uint8 [H, W].

    Mirrors decoder.rs:18-46.
    """
    predict = _PREDICTORS[predictor]
    grid = np.asarray(grid, dtype=np.uint8)
    h, w = grid.shape
    image = np.zeros((h, w), dtype=np.uint8)

    astep = 1 << levels
    image[0::astep, 0::astep] = grid[0::astep, 0::astep]

    for level in range(levels):
        step = 1 << (levels - level)
        for x, y in traverse_level_coords(level, levels, w, h):
            pred = predict(image, x, y, step)
            image[y, x] = (pred + int(grid[y, x])) & 0xFF
    return image


def oracle_max_error(quantization: QuantizationLevel) -> int:
    """The per-pixel max abs error guarantee (quantizator.rs:43-48)."""
    return linear_error(quantization)
