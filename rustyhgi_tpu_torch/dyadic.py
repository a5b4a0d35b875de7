"""Shared dyadic-geometry helpers (no torch dependency).

Counterpart of ``rustyhgi_tpu/dyadic.py``.  The engines, the kernels'
wrapper and the container must agree exactly on these quantities for
encode and decode to interoperate.
"""

from __future__ import annotations

__all__ = ["cdiv", "effective_levels", "canvas_shapes", "subband_shapes"]


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def effective_levels(levels: int, h: int, w: int) -> int:
    """Clamp the pyramid depth to the depths that actually touch pixels.

    Levels whose fine spacing meets or exceeds both image dims visit no
    pixels, so ``levels`` beyond ``ceil(log2(max(h, w)))`` produce the
    identical grid.  Containers still record the caller's nominal
    scale_level; every engine computes with the clamped value, so
    ``levels=16`` on a small plane never builds a ``1 << 16`` lattice.
    """
    cap = (max(h, w) - 1).bit_length()  # ceil(log2(max dim)); 0 for 1x1
    return max(0, min(levels, cap))


def canvas_shapes(height: int, width: int, levels: int):
    """Shapes of the subband layout of depth ``levels``, unclamped.

    ``(anchor_shape, [quad_shape per level])``, coarsest level first: the
    canvas is the plane padded up to multiples of ``2**levels``, the
    anchors its ``2**levels`` lattice and level ``l``'s quads its
    ``2**(levels-l)`` lattice.
    """
    step = 1 << levels
    ah, aw = cdiv(height, step), cdiv(width, step)
    return (ah, aw), [(ah << level, aw << level) for level in range(levels)]


def subband_shapes(height: int, width: int, levels: int):
    """:func:`canvas_shapes` at the effective depth (``levels`` clamped as
    every engine clamps it), so the container's byte stream needs no
    shape framing."""
    return canvas_shapes(height, width, effective_levels(levels, height, width))
