"""Host-side image I/O.

Counterpart of ``rustyhgi_tpu/utils/imageio.py``.  The reference converts
to 8-bit luma with ``to_luma()`` (reference: src/main.rs:42,74); PIL's
'L' mode does the same for 8-bit grayscale inputs.  PIL is imported
inside the functions, as the JAX package does it.
"""

from __future__ import annotations

import numpy as np

__all__ = ["load_luma", "save_gray"]


def load_luma(path: str) -> np.ndarray:
    """Load an image file as a uint8 [H, W] luma plane (PIL 'L' mode)."""
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im.convert("L"), dtype=np.uint8)


def save_gray(path: str, plane: np.ndarray) -> None:
    """Save a uint8 [H, W] plane as a grayscale image (format by extension)."""
    from PIL import Image

    plane = np.ascontiguousarray(plane, dtype=np.uint8)
    Image.fromarray(plane, mode="L").save(path)
