"""The op-rate probe (K8): ``k`` rounds of a 3-op chain on every pixel.

Counterpart of the kernel of ``tools/chip_probe.py`` ``cmd_vpucal``
(``build_mosaic.run``), which the JAX package used to calibrate its
rooflines: with ``i`` the round index, each round of a chain is

=========  =========================================  =======
kind       round                                      type
=========  =========================================  =======
``mix3``   ``p = ((p + (i + 1)) >> 1) ^ p``           int32
``add``    ``p = ((p + (i | 1)) + p) + i``            int32
``shift``  ``p = ((p >> 1) ^ p) >> 1``                int32
``csel``   ``p = p + 1 if p > (i | 1) else p``        int32
``f32add`` ``p = (p + 1.5) * 0.5 + 0.25``             float32
=========  =========================================  =======

and the output byte is the chain's result (truncated to int32 for
``f32add``) ``& 255``.  int32 wraps and ``>>`` is arithmetic, as in JAX.

Two versions compute the same bytes:

* :func:`vpucal_plain`, plain PyTorch: each op of each round is one
  elementwise op on the whole batch (the probe's ``torch`` row times it on
  the card, where it stands for JAX's ``xla`` row);
* the CUDA kernel ``hgi_vpucal`` of ``csrc/hgi_probe.cu``, which
  :func:`vpucal_chain` launches for a CUDA tensor (``vpucal_launches``
  counts its calls); for a CPU tensor, and only then, it takes the plain
  version.
"""

from __future__ import annotations

import torch

from . import _build
from ._build import _on, raise_on

__all__ = ["KINDS", "vpucal_chain", "vpucal_plain", "vpucal_launches"]

KINDS = ("mix3", "add", "shift", "csel", "f32add")  # the kernel's kind codes 0..4

vpucal_launches = 0


def _round(kind: str, i: int, p: torch.Tensor) -> torch.Tensor:
    if kind == "mix3":
        return ((p + (i + 1)) >> 1) ^ p
    if kind == "add":
        return ((p + (i | 1)) + p) + i
    if kind == "shift":
        return ((p >> 1) ^ p) >> 1
    if kind == "csel":
        return torch.where(p > (i | 1), p + 1, p)
    return (p + 1.5) * 0.5 + 0.25  # f32add


def _check(image: torch.Tensor, kind: str, k: int) -> None:
    if kind not in KINDS:
        raise ValueError(f"kind must be one of {KINDS}, got {kind!r}")
    if int(k) < 0:
        raise ValueError(f"k must be >= 0, got {k}")
    if image.dtype != torch.uint8 or image.dim() != 3:
        raise ValueError(f"image must be uint8 [B, H, W], got {image.dtype} {tuple(image.shape)}")


def vpucal_plain(image: torch.Tensor, kind: str, k: int) -> torch.Tensor:
    """The plain version: uint8 ``[B, H, W]`` -> uint8 ``[B, H, W]``."""
    _check(image, kind, k)
    p = image.to(torch.float32 if kind == "f32add" else torch.int32)
    for i in range(int(k)):
        p = _round(kind, i, p)
    return (p.to(torch.int32) & 255).to(torch.uint8)


def vpucal_chain(image: torch.Tensor, kind: str, k: int) -> torch.Tensor:
    """K8: uint8 ``[B, H, W]`` -> uint8 ``[B, H, W]``, ``k`` rounds of
    ``kind``'s chain per pixel.  The kernel on a CUDA tensor, the plain
    version on a CPU tensor."""
    global vpucal_launches
    _check(image, kind, k)
    if image.device.type == "cpu":
        return vpucal_plain(image, kind, k)
    if image.device.type != "cuda":
        raise ValueError(f"image must be a CPU or CUDA tensor, got {image.device}")
    if not image.is_contiguous():
        raise ValueError("image must be contiguous")
    b, h, w = image.shape
    if max(h, w) > 1 << 30 or b >= 1 << 31 or int(k) >= 1 << 31:
        raise ValueError(f"shape {tuple(image.shape)} or k={k} is beyond the kernel's range")
    out = torch.empty_like(image)
    if image.numel() == 0:
        return out
    lib = _build.load()
    with _on(image.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.hgi_vpucal(image.data_ptr(), out.data_ptr(), b, h, w,
                            KINDS.index(kind), int(k), stream)
    vpucal_launches += 1
    raise_on(rc, "hgi_vpucal")
    return out
