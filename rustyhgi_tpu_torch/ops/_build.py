"""Build and load the CUDA kernels of ``csrc/`` at first use.

The sources are compiled with ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface, which is loaded with ``ctypes``; no
PyTorch header is compiled, so a build takes seconds.  The library's
name carries a hash of the sources and flags, so an edited source
rebuilds and an unchanged one is reused.  Without ``nvcc``, or when the
compiler fails, :func:`load` raises with the compiler's output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional

__all__ = ["BUILD_DIR", "SOURCES", "build", "find_nvcc", "load"]

_PKG = Path(__file__).resolve().parent.parent
SOURCES = (_PKG / "csrc" / "hgi_codec.cu",)
BUILD_DIR = _PKG.parent / "build" / "rustyhgi_tpu_torch"

_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers, shared memory and spills, kept in the log
)

_lib: Optional[ctypes.CDLL] = None


def find_nvcc() -> Optional[str]:
    """``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH, else the default
    toolkit location; None when there is none."""
    home = os.environ.get("CUDA_HOME")
    for cand in (
        home and os.path.join(home, "bin", "nvcc"),
        shutil.which("nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.isfile(cand) and os.access(cand, os.X_OK):
            return cand
    return None


def _digest() -> str:
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    for src in SOURCES:
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def build(nvcc: Optional[str] = None, build_dir: Path = BUILD_DIR) -> Path:
    """Compile ``SOURCES`` unless a library of the same hash exists.

    Returns the library's path; the compiler's output is kept beside it
    as ``.log``.  Raises RuntimeError when no compiler is found or it
    fails.
    """
    nvcc = nvcc or find_nvcc()
    if nvcc is None:
        raise RuntimeError(
            "cannot build the CUDA kernels: no nvcc in $CUDA_HOME/bin, on "
            "PATH or in /usr/local/cuda/bin"
        )
    out = Path(build_dir) / f"libhgi_codec_{_digest()}.so"
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    cmd = [nvcc, *_FLAGS, "-o", str(tmp), *map(str, SOURCES)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:
        raise RuntimeError(f"cannot run {nvcc}: {e}") from e
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed with exit code {proc.returncode}:\n"
            f"{' '.join(cmd)}\n{log}"
        )
    out.with_suffix(".log").write_text(log)
    os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    return out


def load() -> ctypes.CDLL:
    """The kernels' library, built on first use and then cached."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.hgi_encode.argtypes = [ptr, ptr, ptr, ptr, i32, i32, i32, i32, i32, ptr]
        lib.hgi_encode.restype = i32
        lib.hgi_decode.argtypes = [ptr, ptr, i32, i32, i32, i32, i32, ptr]
        lib.hgi_decode.restype = i32
        ptrs = ctypes.POINTER(ctypes.c_void_p)  # a host array of device pointers
        lib.hgi_encode_subbands.argtypes = [
            ptr, ptr, ptrs, ptr, ptr, i32, i32, i32, i32, i32, ptr,
        ]
        lib.hgi_encode_subbands.restype = i32
        lib.hgi_assemble_grid.argtypes = [ptr, ptrs, ptr, i32, i32, i32, i32, ptr]
        lib.hgi_assemble_grid.restype = i32
        lib.hgi_decode_subbands.argtypes = [
            ptr, ptrs, ptr, i32, i32, i32, i32, i32, i32, ptr,
        ]
        lib.hgi_decode_subbands.restype = i32
        lib.hgi_error_string.argtypes = [i32]
        lib.hgi_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib
