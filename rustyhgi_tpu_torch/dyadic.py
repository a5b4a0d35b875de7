"""Shared dyadic-geometry helpers (no torch dependency).

Counterpart of ``rustyhgi_tpu/dyadic.py``.  The engines, the kernels'
wrapper and the container must agree exactly on these quantities for
encode and decode to interoperate.
"""

from __future__ import annotations

__all__ = ["cdiv", "effective_levels"]


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
