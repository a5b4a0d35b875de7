"""K1 and K2 as PyTorch operators: ``torch.ops.rustyhgi.encode_plane``
and ``torch.ops.rustyhgi.decode_plane``.

Registered with ``torch.library.custom_op`` so that ``torch.export``
keeps each call as one node of the exported graph (what
:meth:`..models.codec.HGICodec.export_encoder` ships) instead of tracing
the plain version's arithmetic.  Dispatch is by the tensor's device: on
``cuda`` the kernel's launcher (:mod:`.cuda_codec`, which raises when its
kernel does not build or launch), on ``cpu`` the plain version
(:mod:`.pyramid`).  The fake implementations give the output shapes.

The quantizer table travels as a uint8 ``[256]`` tensor and ``lossless``
says whether to ignore it.  An operator may not return its input, so in
lossless mode the reconstruction is a copy of the image, where
``HGICodec.encode_plane`` returns the image itself.
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import cuda_codec, pyramid

__all__ = ["encode_plane", "decode_plane"]


def _encode(engine, image, table, levels, predictor, lossless):
    grid, recon = engine.encode_plane(image, levels, None if lossless else table, predictor)
    return grid, recon.clone() if lossless else recon


@torch.library.custom_op("rustyhgi::encode_plane", mutates_args=(), device_types="cuda")
def encode_plane(
    image: torch.Tensor, table: torch.Tensor, levels: int, predictor: str, lossless: bool
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1: uint8 ``[H, W]``/``[B, H, W]`` -> ``(grid, recon)``."""
    return _encode(cuda_codec, image, table, levels, predictor, lossless)


@encode_plane.register_kernel("cpu")
def _encode_cpu(image, table, levels, predictor, lossless):
    return _encode(pyramid, image, table, levels, predictor, lossless)


@encode_plane.register_fake
def _encode_fake(image, table, levels, predictor, lossless):
    return torch.empty_like(image), torch.empty_like(image)


@torch.library.custom_op("rustyhgi::decode_plane", mutates_args=(), device_types="cuda")
def decode_plane(grid: torch.Tensor, levels: int, predictor: str) -> torch.Tensor:
    """K2: uint8 ``[H, W]``/``[B, H, W]`` residual grid -> image."""
    return cuda_codec.decode_plane(grid, levels, predictor)


@decode_plane.register_kernel("cpu")
def _decode_cpu(grid, levels, predictor):
    return pyramid.decode_plane(grid, levels, predictor)


@decode_plane.register_fake
def _decode_fake(grid, levels, predictor):
    return torch.empty_like(grid)
