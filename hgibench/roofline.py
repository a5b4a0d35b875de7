"""The card's peaks and the work of each coded function, for rooflines.

A function's least time on the card is the larger of its bytes over the
memory rate and its operations over the issue rate.  The bytes count
each input byte read once and each output byte written once, whatever a
kernel reads again; the work is the function's, whatever kernel runs it.

Peaks of one NVIDIA H100 SXM (80 GB HBM3) at its 700 W limit:

* memory: 3.35 TB/s, the data sheet's HBM3 rate;
* operations: 33.454 T warp-lane instructions/s, each SM's four
  schedulers issuing one 32-lane instruction a clock: 132 SMs x 128
  lanes x 1980 MHz.  It is the data sheet's 67 TFLOP/s of FP32 with an
  FMA counted as two; chains of integer adds, logic ops, compares or
  FP32 adds reach it on this card, shifts half of it.
"""

from __future__ import annotations

from .reference import rans

__all__ = ["PEAK_BYTES_PER_S", "PEAK_OPS_PER_S", "X1_OPS_PER_SYMBOL", "least_seconds",
           "k1_work", "k2_work", "x1_work", "share"]

PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 132 * 128 * 1980e6

# X1, the device rANS encode, a symbol: the histogram's increment (1); the
# encode step's comparison for renormalization (1), the choice of the
# state to keep (1), the word it emits (1), the quotient by the symbol's
# frequency as the high half of a product with its reciprocal (2: two
# 32-bit multiplies, their sum folded into one of them), and the new
# state from quotient, remainder term and cumulative frequency (2).  The
# symbol's load and its table entry are memory, counted as bytes.  Eight
# operations is a floor: the card's kernel issues more.
X1_OPS_PER_SYMBOL = 8


def least_seconds(nbytes: float, ops: float = 0.0) -> float:
    return max(nbytes / PEAK_BYTES_PER_S, ops / PEAK_OPS_PER_S)


def k1_work(planes: int, pixels: int, lossy: bool) -> float:
    """K1, a plane to its residual grid: the plane read, the grid written,
    and for a lossy preset the reconstruction written too.  Least seconds."""
    return least_seconds(planes * pixels * (3 if lossy else 2))


def k2_work(planes: int, pixels: int) -> float:
    """K2, a residual grid to its plane: the grid read, the plane written."""
    return least_seconds(planes * pixels * 2)


def x1_work(planes: int, symbols: int, words: int) -> float:
    """X1 on ``planes`` streams of ``symbols`` bytes that came to ``words``
    coded 16-bit words in all: the symbols read; the tables (256 int32),
    word counts and final states (an int32 a lane each) and the words
    written; ``X1_OPS_PER_SYMBOL`` operations a symbol of the stream
    padded to whole rows of lanes, as the format codes it (the lane rule
    is the reference coder's)."""
    lanes = rans.lanes_for(symbols)
    cells = planes * lanes * -(-symbols // lanes)
    nbytes = planes * symbols + planes * 4 * (256 + 2 * lanes) + 2 * words
    return least_seconds(nbytes, X1_OPS_PER_SYMBOL * cells)


def share(bound_s: float, device_s: float):
    """Percent of the roofline: least seconds over device seconds, or None
    without device time."""
    if device_s <= 0:
        return None
    return 100.0 * bound_s / device_s
