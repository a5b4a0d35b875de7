"""Distortion and size metrics for one roundtrip.

Counterpart of ``codec_metrics`` and ``psnr`` in
``rustyhgi_tpu/utils/profiling.py``.  Tracing and stage timers are not
ported yet (ROADMAP Queue 1 item 12).
"""

from __future__ import annotations

from typing import Dict

import numpy as np

__all__ = ["codec_metrics", "psnr"]


def psnr(original: np.ndarray, decoded: np.ndarray) -> float:
    """Peak signal-to-noise ratio in dB (inf for identical planes)."""
    diff = original.astype(np.float64) - decoded.astype(np.float64)
    mse = float(np.mean(diff * diff))
    if mse == 0:
        return float("inf")
    return 10.0 * np.log10(255.0**2 / mse)


def codec_metrics(
    original: np.ndarray,
    decoded: np.ndarray,
    compressed_bytes: int,
) -> Dict[str, float]:
    """Structured distortion/size metrics for one roundtrip.

    ``sd`` follows the reference's convention (main.rs:105-111): integer
    mean of squared diffs, then sqrt.
    """
    original = np.asarray(original)
    decoded = np.asarray(decoded)
    diff = original.astype(np.int64) - decoded.astype(np.int64)
    n = original.size
    sd_int = int((diff * diff).sum()) // n if n else 0
    return {
        "uncompressed": n,
        "compressed": compressed_bytes,
        "ratio": n / compressed_bytes if compressed_bytes else float("inf"),
        "sd": float(np.sqrt(sd_int)),
        "psnr_db": psnr(original, decoded),
        "max_error": int(np.abs(diff).max()) if n else 0,
    }
