"""ctypes binding to the native host library, ``native/librustyhgi.so``.

Counterpart of ``rustyhgi_tpu/ops/native.py``.  The port loads the
repository's native library as it is, built with ``make -C native`` on
first use; it holds the rANS coder and the context-adaptive coder of the
``.thgi`` container, and the scalar C++ encode and decode
(:func:`native_encode`, :func:`native_decode`), a single-threaded
stand-in for the reference binary that the bench times as its baseline.
Every entry point is declared with pointer-sized argument types, so
ctypes never cuts a pointer to 32 bits.

Without the library (no compiler, or the build fails) :func:`available`
is False and each ``native_*`` function raises RuntimeError; the callers
in :mod:`.entropy` and :mod:`.ctxcoder` then take their pure-Python
coders, which write the same bytes.  The device rANS payload (codec 7)
is decoded by :func:`native_rans_tpu_decode` here, or by the NumPy mirror
in :mod:`.tpurans`.
"""

from __future__ import annotations

import ctypes
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

from ..dyadic import effective_levels
from .quantizers import QuantizationLevel, linear_error

__all__ = [
    "available",
    "native_encode",
    "native_decode",
    "native_rans_compress",
    "native_rans_decompress",
    "native_ctx_compress",
    "native_ctx_decompress",
    "native_rans_tpu_decode",
]

NATIVE_DIR = Path(__file__).resolve().parents[2] / "native"
LIB_PATH = NATIVE_DIR / "librustyhgi.so"

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_load_failed = False


def _declare(lib: ctypes.CDLL) -> None:
    u8p = ctypes.POINTER(ctypes.c_uint8)
    u16p = ctypes.POINTER(ctypes.c_uint16)
    u32p = ctypes.POINTER(ctypes.c_uint32)
    u64p = ctypes.POINTER(ctypes.c_uint64)
    u32, u64 = ctypes.c_uint32, ctypes.c_uint64
    lib.hgi_encode_plane.argtypes = [u8p, u8p, u32, u32, u32, u32]
    lib.hgi_encode_plane.restype = None
    lib.hgi_decode_plane.argtypes = [u8p, u8p, u32, u32, u32]
    lib.hgi_decode_plane.restype = None
    lib.rans_compress.argtypes = [u8p, u64, u8p, u64, u16p]
    lib.rans_compress.restype = u64
    lib.rans_worst_size.argtypes = [u64]
    lib.rans_worst_size.restype = u64
    lib.rans_decompress.argtypes = [u8p, u64, u8p, u64]
    lib.rans_decompress.restype = ctypes.c_int
    lib.rans_histogram.argtypes = [u8p, u64, u64p]
    lib.rans_histogram.restype = None
    lib.ctx_worst_size.argtypes = [u64]
    lib.ctx_worst_size.restype = u64
    lib.ctx_compress.argtypes = [u8p, u64, u32p, u8p, u64, u32]
    lib.ctx_compress.restype = u64
    lib.ctx_decompress.argtypes = [u8p, u64, u64, u32p, u8p, u32]
    lib.ctx_decompress.restype = ctypes.c_int
    lib.rans_tpu_decode.argtypes = [u8p, u64, u8p, u64]
    lib.rans_tpu_decode.restype = ctypes.c_int


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _load_failed
    with _lock:
        if _lib is not None or _load_failed:
            return _lib
        if not LIB_PATH.exists():
            try:
                subprocess.run(
                    ["make", "-C", str(NATIVE_DIR), "-s"],
                    check=True, capture_output=True, timeout=120,
                )
            except (OSError, subprocess.SubprocessError):
                _load_failed = True
                return None
        try:
            lib = ctypes.CDLL(str(LIB_PATH))
        except OSError:
            _load_failed = True
            return None
        _declare(lib)
        _lib = lib
        return _lib


def available() -> bool:
    """Whether the native library is loaded (building it if need be)."""
    return _load() is not None


def _require() -> ctypes.CDLL:
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native library unavailable (make -C {NATIVE_DIR} failed)")
    return lib


def _u8ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def native_encode(image: np.ndarray, levels: int, quantization) -> np.ndarray:
    """Scalar C++ encode of a uint8 [H, W] plane -> residual grid."""
    lib = _require()
    work = np.array(image, dtype=np.uint8, copy=True, order="C")
    h, w = work.shape
    grid = np.zeros((h, w), dtype=np.uint8)
    err = linear_error(QuantizationLevel(quantization))
    lib.hgi_encode_plane(_u8ptr(work), _u8ptr(grid), w, h, effective_levels(levels, h, w), err)
    return grid


def native_decode(grid: np.ndarray, levels: int) -> np.ndarray:
    """Scalar C++ decode of a uint8 [H, W] residual grid -> image."""
    lib = _require()
    grid = np.ascontiguousarray(grid, dtype=np.uint8)
    h, w = grid.shape
    image = np.zeros((h, w), dtype=np.uint8)
    lib.hgi_decode_plane(_u8ptr(grid), _u8ptr(image), w, h, effective_levels(levels, h, w))
    return image


_scratch = threading.local()


def _out_buffer(cap: int) -> np.ndarray:
    # A growing per-thread output buffer: fresh multi-MB allocations are
    # page-fault-bound and would cost more than the coder itself.
    buf = getattr(_scratch, "buf", None)
    if buf is None or buf.size < cap:
        buf = np.empty(max(cap, 1 << 20), dtype=np.uint8)
        _scratch.buf = buf
    return buf


def native_rans_compress(data: bytes, freqs: Optional[np.ndarray] = None) -> bytes:
    """rANS-compress bytes, optionally against a shared u16[256] table."""
    lib = _require()
    src = np.frombuffer(data, dtype=np.uint8)
    cap = int(lib.rans_worst_size(src.size))
    out = _out_buffer(cap)
    fp = None
    if freqs is not None:
        freqs = np.ascontiguousarray(freqs, dtype=np.uint16)
        if freqs.shape != (256,) or int(freqs.sum()) != 1 << 14:
            raise ValueError("freq table must be u16[256] summing to 2**14")
        fp = freqs.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16))
    n = int(lib.rans_compress(_u8ptr(src), src.size, _u8ptr(out), cap, fp))
    if n == 0:
        raise RuntimeError("rans_compress: insufficient output capacity")
    return out[:n].tobytes()


def native_rans_decompress(data: bytes, raw_size: int) -> bytes:
    lib = _require()
    src = np.frombuffer(data, dtype=np.uint8)
    out = np.zeros(raw_size, dtype=np.uint8)
    rc = int(lib.rans_decompress(_u8ptr(src), src.size, _u8ptr(out), raw_size))
    if rc != 0:
        raise ValueError(f"rans_decompress: malformed stream (code {rc})")
    return out.tobytes()


def _piece_array(pieces) -> np.ndarray:
    arr = np.ascontiguousarray(pieces, dtype=np.uint32)
    if arr.ndim != 2 or arr.shape[1] != 3:
        raise ValueError("piece table must be (h, w, group) triples")
    return arr


def _u32ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32))


def native_ctx_compress(payload: bytes, pieces, adapt_shift: int = 5) -> bytes:
    """Context-adaptive coder encode (:mod:`.ctxcoder` is its spec)."""
    lib = _require()
    src = np.frombuffer(payload, dtype=np.uint8)
    tab = _piece_array(pieces)
    cap = int(lib.ctx_worst_size(src.size))
    out = _out_buffer(cap)
    n = int(lib.ctx_compress(
        _u8ptr(src), tab.shape[0], _u32ptr(tab), _u8ptr(out), cap, int(adapt_shift),
    ))
    if n == 0:
        raise RuntimeError("ctx_compress: insufficient output capacity")
    return out[:n].tobytes()


def native_ctx_decompress(data: bytes, pieces, adapt_shift: int = 5) -> bytes:
    lib = _require()
    src = np.frombuffer(data, dtype=np.uint8)
    tab = _piece_array(pieces)
    total = int((tab[:, 0].astype(np.uint64) * tab[:, 1]).sum())
    out = np.zeros(total, dtype=np.uint8)
    rc = int(lib.ctx_decompress(
        _u8ptr(src), src.size, tab.shape[0], _u32ptr(tab), _u8ptr(out), int(adapt_shift),
    ))
    if rc != 0:
        raise ValueError(f"ctx_decompress: malformed stream (code {rc})")
    return out.tobytes()


_RANS_TPU_ERRORS = {
    -1: "truncated rans_tpu stream",
    -2: "rans_tpu stream size does not match declared size",
    -3: "invalid rans_tpu lane count",
    -4: "invalid rans_tpu frequency table",
    -5: "rans_tpu lane count exceeds symbol rows",
    -6: "rans_tpu stream underrun",
    -7: "rans_tpu stream underrun or trailing words",
    -8: "rans_tpu state mismatch (corrupt stream)",
}


def native_rans_tpu_decode(data: bytes, n: int) -> np.ndarray:
    """Decode a device rANS payload (:mod:`.tpurans` format) to uint8 [n].

    ``n`` is the header-derived size (the bomb guard); accepts and rejects
    as the NumPy mirror does.
    """
    lib = _require()
    src = np.frombuffer(data, dtype=np.uint8)
    out = np.zeros(max(int(n), 1), dtype=np.uint8)
    rc = int(lib.rans_tpu_decode(_u8ptr(src), src.size, _u8ptr(out), int(n)))
    if rc != 0:
        raise ValueError(_RANS_TPU_ERRORS.get(rc, f"rans_tpu: malformed stream ({rc})"))
    return out[: int(n)]
