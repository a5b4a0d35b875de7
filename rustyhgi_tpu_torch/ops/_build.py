"""Build and load the CUDA kernels of ``csrc/`` at first use.

Each source is compiled with its own ``nvcc`` for ``sm_90a``, all
started together so that the build takes as long as its slowest source,
and the objects are linked into one shared library with a plain C
interface, which is loaded with ``ctypes``; no PyTorch header is
compiled, so a build takes seconds.  The log beside the library gives
each command's wall time.  The library's name carries a hash
of the sources and flags, so an edited source rebuilds and an unchanged
one is reused.  Without ``nvcc``, or when the compiler fails, :func:`load`
raises with the compiler's output.  Every launch wrapper enters
:func:`_on` around its call and hands its return code to
:func:`raise_on`.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Optional

import torch

__all__ = ["BUILD_DIR", "SOURCES", "QTable", "build", "find_nvcc", "load", "raise_on"]

_PKG = Path(__file__).resolve().parent.parent
SOURCES = tuple(_PKG / "csrc" / name for name in ("hgi_codec.cu", "hgi_entropy.cu", "hgi_probe.cu"))
BUILD_DIR = _PKG.parent / "build" / "rustyhgi_tpu_torch"

_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers, shared memory and spills, kept in the log
)

_lib: Optional[ctypes.CDLL] = None


class QTable(ctypes.Structure):
    """A quantizer table as the kernels take it: 256 bytes, by value."""

    _fields_ = [("v", ctypes.c_uint8 * 256)]


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
    digest = _digest()
    out = Path(build_dir) / f"libhgi_codec_{digest}.so"
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    objs = [out.with_name(f"{src.stem}_{digest}.{os.getpid()}.o") for src in SOURCES]
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    compiles = [[nvcc, *_FLAGS, "-c", "-o", str(obj), str(src)]
                for src, obj in zip(SOURCES, objs)]
    try:
        log = _run_all(compiles)  # one nvcc per source, started together
        log += _run_all([[nvcc, *_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)]])
    except RuntimeError:
        tmp.unlink(missing_ok=True)
        raise
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    out.with_suffix(".log").write_text(log)
    os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    return out


def _run_all(cmds) -> str:
    """Run the commands at once (one thread waits on each); their output,
    each with its own wall time, or RuntimeError naming the first that
    failed."""
    def run(cmd):
        t0 = time.perf_counter()
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True)
        except OSError as e:
            raise RuntimeError(f"cannot run {cmd[0]}: {e}") from e
        return proc, time.perf_counter() - t0

    with ThreadPoolExecutor(len(cmds)) as pool:
        runs = list(pool.map(run, cmds))
    for cmd, (proc, _) in zip(cmds, runs):
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed with exit code {proc.returncode}:\n"
                f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
            )
    return "".join(f"$ {' '.join(cmd)}  [{secs:.2f} s]\n{p.stdout}{p.stderr}"
                   for cmd, (p, secs) in zip(cmds, runs))


def load() -> ctypes.CDLL:
    """The kernels' library, built on first use and then cached."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.hgi_encode.argtypes = [ptr, ptr, ptr, QTable] + [i32] * 9 + [ptr]
        lib.hgi_encode.restype = i32
        lib.hgi_decode.argtypes = [ptr, ptr] + [i32] * 8 + [ptr]
        lib.hgi_decode.restype = i32
        ptrs = ctypes.POINTER(ctypes.c_void_p)  # a host array of device pointers
        lib.hgi_encode_subbands.argtypes = [ptr, ptr, ptrs, ptr, QTable] + [i32] * 9 + [ptr]
        lib.hgi_encode_subbands.restype = i32
        lib.hgi_assemble_grid.argtypes = [ptr, ptrs, ptr, i32, i32, i32, i32, ptr]
        lib.hgi_assemble_grid.restype = i32
        lib.hgi_decode_subbands.argtypes = [ptr, ptrs, ptr] + [i32] * 9 + [ptr]
        lib.hgi_decode_subbands.restype = i32
        lib.rans_tpu_encode.argtypes = [ptr] * 8 + [i32] * 5 + [ptr]
        lib.rans_tpu_encode.restype = i32
        i64 = ctypes.c_longlong
        lib.bitpack_pack.argtypes = [ptr, ptr, ptr, i64, i64, i32, ptr]
        lib.bitpack_pack.restype = i32
        lib.bitpack_unpack.argtypes = [ptr, ptr, i64, i32, ptr]
        lib.bitpack_unpack.restype = i32
        lib.bitpack_pack_compact.argtypes = [ptr, ptr, i64, ptr, i64, i32, ptr]
        lib.bitpack_pack_compact.restype = i32
        lib.bitpack_unpack_compact.argtypes = [ptr, ptr, i64, i64, i32, ptr]
        lib.bitpack_unpack_compact.restype = i32
        lib.hgi_vpucal.argtypes = [ptr, ptr, i32, i32, i32, i32, i32, ptr]
        lib.hgi_vpucal.restype = i32
        lib.hgi_error_string.argtypes = [i32]
        lib.hgi_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def raise_on(rc: int, entry: str) -> None:
    """RuntimeError naming ``entry`` and the CUDA error unless ``rc`` is 0."""
    if rc != 0:
        msg = load().hgi_error_string(rc).decode()
        raise RuntimeError(f"{entry} failed: CUDA error {rc} ({msg})")


def _on(device: torch.device):
    """``torch.cuda.device(device)``, or nothing when it is current already."""
    if device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(device)
