"""Residual quantizers.

Counterpart of ``rustyhgi_tpu/ops/quantizers.py`` (reference:
src/quantizator.rs:1-73).  Every strategy comes down to a 256-entry table
of the wrapped residual byte, and that table is what the engines take:
the plain PyTorch engine indexes it, the CUDA kernels take it by value and
keep it in shared memory.  ``table is None`` means the identity, which the engines
specialise into the lossless path (no quantize, no overflow fixup,
reconstruction equals the source).

Linear quantizer (quantizator.rs:36-73): error ``e`` in
{Lossless: 0, Low: 10, Medium: 20, High: 30}; ``scale = 2e+1``;
``q(x) = ((x + e) // scale) * scale`` in wide ints, then truncated to u8.
"""

from __future__ import annotations

import enum

import numpy as np
import torch

__all__ = [
    "QuantizationLevel",
    "linear_error",
    "linear_table",
    "linear_quantize",
    "quantize_fn",
    "LinearQuantizer",
    "NoOpQuantizer",
    "LUTQuantizer",
]


class QuantizationLevel(enum.IntEnum):
    """Quality presets; integer values are the container enum tags.

    Tag order matches the reference's serde enum order
    (quantizator.rs:1-9): Lossless=0, Low=1, Medium=2, High=3.
    """

    LOSSLESS = 0
    LOW = 1
    MEDIUM = 2
    HIGH = 3

    @classmethod
    def parse(cls, name: str) -> "QuantizationLevel":
        try:
            return cls[name.upper()]
        except KeyError:
            raise ValueError(
                f"unknown quantization level {name!r}; "
                f"expected one of {[m.name.lower() for m in cls]}"
            ) from None


_ERRORS = {
    QuantizationLevel.LOSSLESS: 0,
    QuantizationLevel.LOW: 10,
    QuantizationLevel.MEDIUM: 20,
    QuantizationLevel.HIGH: 30,
}


def linear_error(level: QuantizationLevel) -> int:
    """Max abs reconstruction error for a preset (quantizator.rs:43-48)."""
    return _ERRORS[QuantizationLevel(level)]


def _table(error: int) -> np.ndarray:
    scale = 2 * error + 1
    x = np.arange(256, dtype=np.int64)
    return ((x + error) // scale) * scale & 255  # `as u8` truncation


def linear_table(level: QuantizationLevel) -> np.ndarray:
    """The 256-entry LUT of quantizator.rs:50-61 as uint8[256]."""
    return _table(linear_error(level)).astype(np.uint8)


def linear_quantize(diff: torch.Tensor, error: int) -> torch.Tensor:
    """Closed-form linear quantizer on int32 residual bytes in [0, 255].

    The ``& 255`` reproduces the reference's ``as u8`` truncation
    (quantizator.rs:54).
    """
    scale = 2 * error + 1
    return torch.div(diff + error, scale, rounding_mode="floor") * scale & 255


class LinearQuantizer:
    """Closed-form linear quantizer on int32 residual-byte tensors."""

    def __init__(self, error: int):
        self.error = int(error)
        self.table = torch.from_numpy(_table(self.error).astype(np.int32))

    @property
    def identity(self) -> bool:
        return self.error == 0

    def __call__(self, diff: torch.Tensor) -> torch.Tensor:
        return linear_quantize(diff, self.error)

    def __repr__(self) -> str:
        return f"LinearQuantizer(error={self.error})"


class NoOpQuantizer:
    """NoOp strategy (quantizator.rs:17-34): identity, error 0."""

    error = 0
    identity = True
    table = torch.arange(256, dtype=torch.int32)

    def __call__(self, diff: torch.Tensor) -> torch.Tensor:
        return diff

    def __repr__(self) -> str:
        return "NoOpQuantizer()"


class LUTQuantizer:
    """Table-driven linear quantizer: a real 256-entry gather per residual.

    Bit-identical to :class:`LinearQuantizer`.  Like the JAX package's,
    it reports ``identity = False`` even at error 0; the values are the
    same either way.
    """

    identity = False

    def __init__(self, error: int):
        self.error = int(error)
        self.table = torch.from_numpy(_table(self.error).astype(np.int32))

    def __call__(self, diff: torch.Tensor) -> torch.Tensor:
        return self.table.to(diff.device)[diff & 255]

    def __repr__(self) -> str:
        return f"LUTQuantizer(error={self.error})"


_STRATEGIES = ("linear", "noop", "lut")


def quantize_fn(level: QuantizationLevel, strategy: str = "linear"):
    """Return the quantizer of a preset under a strategy.

    The result is callable on int32 tensors and carries ``error``,
    ``identity`` and its 256-entry int32 ``table``.
    """
    if strategy == "linear":
        return LinearQuantizer(linear_error(level))
    if strategy == "noop":
        return NoOpQuantizer()
    if strategy == "lut":
        return LUTQuantizer(linear_error(level))
    raise ValueError(
        f"unknown quantizer strategy {strategy!r}; expected one of {_STRATEGIES}"
    )
