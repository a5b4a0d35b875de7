"""A batch of planes split over a mesh of devices, and the tiling of a
large plane into such a batch.

Counterpart of ``rustyhgi_tpu/parallel/sharded.py``, in one process: the
batch axis is cut into one contiguous chunk a device, in the mesh's
row-major device order; each chunk runs on its device through the port's
:class:`HGICodec` (the CUDA kernels on a CUDA device, the
plain version on the CPU, or as ``engine`` says), and the results are
joined in batch order on the mesh's first device.  The planes are
independent, so the bytes do not depend on the mesh.

Tiling, the gigapixel axis: :func:`tile_plane` cuts a plane into
fixed-size zero-padded tiles, each an independent stream, and
:func:`untile_plane` crops them back.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from ..models.codec import HGICodec
from ..ops.quantizers import QuantizationLevel
from .mesh import Mesh, make_mesh

__all__ = [
    "encode_batch_sharded",
    "decode_batch_sharded",
    "encode_subbands_batch_sharded",
    "decode_subbands_batch_sharded",
    "sharded_histogram",
    "tile_plane",
    "untile_plane",
    "pad_batch",
]


def _split(mesh: Optional[Mesh], b: int) -> List[Tuple[torch.device, slice]]:
    """Each device of the mesh with its contiguous slice of a batch of
    ``b``; ``b`` must be a multiple of the mesh's size."""
    if mesh is None:
        mesh = make_mesh()
    n = mesh.size
    if b % n:
        raise ValueError(
            f"batch of {b} planes is not divisible by the mesh's {n} devices; "
            "pad it with pad_batch"
        )
    per = b // n
    return [(dev, slice(i * per, (i + 1) * per)) for i, dev in enumerate(mesh.devices.flat)]


def _codec(dev, levels, quantization=QuantizationLevel.MEDIUM, predictor="crossed",
           engine="auto"):
    return HGICodec(levels, quantization, predictor=predictor, backend=engine, device=dev)


def _join(parts: List[torch.Tensor]) -> torch.Tensor:
    """The chunks in batch order, on the first chunk's device."""
    dev = parts[0].device
    return torch.cat([p.to(dev) for p in parts])


def _histogram(parts: List[torch.Tensor]) -> torch.Tensor:
    """int32[256] count of the bytes of every chunk: a ``torch.bincount``
    a chunk on its device, summed on the first chunk's."""
    dev = parts[0].device
    total = torch.zeros(256, dtype=torch.int64, device=dev)
    for p in parts:
        total += torch.bincount(p.reshape(-1), minlength=256).to(dev)
    return total.to(torch.int32)


def encode_batch_sharded(
    images,
    levels: int,
    quantization: QuantizationLevel,
    mesh: Optional[Mesh] = None,
    with_histogram: bool = False,
    predictor: str = "crossed",
    engine: str = "auto",
):
    """Encode a [B, H, W] uint8 batch split over the mesh.

    Returns ``(grids, recons, histogram)``: [B, H, W] uint8 tensors in
    batch order on the mesh's first device, and with
    ``with_histogram=True`` the int32[256] count of the residual bytes of
    the whole batch (the input of a shared coder table,
    ``normalized_freqs(histogram)``), else None.  The counts are int32, so
    a call takes fewer than 2**31 pixels when the histogram is wanted.

    B must be a multiple of the mesh's size: :func:`pad_batch` pads it.
    """
    if with_histogram and int(np.prod(images.shape)) >= 1 << 31:
        raise ValueError("histogram counts are int32: chunk batches below 2**31 pixels")
    grids, recons = [], []
    for dev, part in _split(mesh, images.shape[0]):
        g, r = _codec(dev, levels, quantization, predictor, engine).encode_plane(images[part])
        grids.append(g)
        recons.append(r)
    hist = _histogram(grids) if with_histogram else None
    return _join(grids), _join(recons), hist


def decode_batch_sharded(
    grids,
    levels: int,
    mesh: Optional[Mesh] = None,
    predictor: str = "crossed",
    engine: str = "auto",
) -> torch.Tensor:
    """Decode a [B, H, W] uint8 residual-grid batch split over the mesh."""
    return _join([
        _codec(dev, levels, predictor=predictor, engine=engine).decode_plane(grids[part])
        for dev, part in _split(mesh, grids.shape[0])
    ])


def encode_subbands_batch_sharded(
    images,
    levels: int,
    quantization: QuantizationLevel,
    mesh: Optional[Mesh] = None,
    predictor: str = "crossed",
    engine: str = "auto",
):
    """Subband-layout encode of a [B, H, W] batch split over the mesh.

    Returns ``(anchors, subbands)``, each array with its leading batch
    dimension: the ``.thgi`` subband payload of every plane, padding
    residuals included, as ``HGICodec.encode_subbands`` gives it.
    """
    outs = [
        _codec(dev, levels, quantization, predictor, engine).encode_subbands(images[part])
        for dev, part in _split(mesh, images.shape[0])
    ]
    anchors = _join([a for a, _, _ in outs])
    subbands = [
        tuple(_join([s[level][k] for _, s, _ in outs]) for k in range(3))
        for level in range(len(outs[0][1]))
    ]
    return anchors, subbands


def decode_subbands_batch_sharded(
    anchors,
    subbands,
    shape: Tuple[int, int],
    levels: int,
    mesh: Optional[Mesh] = None,
    predictor: str = "crossed",
    engine: str = "auto",
) -> torch.Tensor:
    """Subband-direct decode of a batch split over the mesh -> [B, H, W]."""
    return _join([
        _codec(dev, levels, predictor=predictor, engine=engine).decode_subbands(
            anchors[part], [tuple(q[part] for q in quads) for quads in subbands], shape
        )
        for dev, part in _split(mesh, anchors.shape[0])
    ])


def sharded_histogram(grids, mesh: Optional[Mesh] = None) -> torch.Tensor:
    """int32[256] count of the bytes of a [B, ...] uint8 batch split over
    the mesh."""
    parts = []
    for dev, part in _split(mesh, grids.shape[0]):
        chunk = grids[part]
        if not isinstance(chunk, torch.Tensor):
            chunk = torch.from_numpy(np.ascontiguousarray(chunk, np.uint8))
        parts.append(chunk.to(dev))
    return _histogram(parts)


# -- Spatial tiling: a large plane -> independent fixed-size tiles -------------


def tile_plane(plane: np.ndarray, tile: Tuple[int, int]) -> Tuple[np.ndarray, Tuple[int, int]]:
    """Split an [H, W] plane into [nT, th, tw] zero-padded tiles.

    Tiles are row-major over the tile grid, the stream order.  Returns
    ``(tiles, (H, W))`` so that :func:`untile_plane` can crop the padding.
    """
    th, tw = tile
    h, w = plane.shape
    nh, nw = -(-h // th), -(-w // tw)
    padded = np.zeros((nh * th, nw * tw), dtype=np.uint8)
    padded[:h, :w] = plane
    tiles = padded.reshape(nh, th, nw, tw).transpose(0, 2, 1, 3).reshape(-1, th, tw)
    return np.ascontiguousarray(tiles), (h, w)


def untile_plane(tiles: np.ndarray, shape: Tuple[int, int]) -> np.ndarray:
    """Inverse of :func:`tile_plane`."""
    h, w = shape
    n, th, tw = tiles.shape
    nh, nw = -(-h // th), -(-w // tw)
    if n != nh * nw:
        raise ValueError(f"{n} tiles cannot cover {shape} with {th}x{tw}")
    padded = tiles.reshape(nh, nw, th, tw).transpose(0, 2, 1, 3).reshape(nh * th, nw * tw)
    return np.ascontiguousarray(padded[:h, :w])


def pad_batch(batch: np.ndarray, multiple: int) -> Tuple[np.ndarray, int]:
    """Zero-pad the batch axis to a multiple of ``multiple`` (a mesh's
    size); returns ``(batch, pad count)``."""
    b = batch.shape[0]
    target = -(-b // multiple) * multiple
    if target == b:
        return batch, 0
    pad = np.zeros((target - b, *batch.shape[1:]), dtype=batch.dtype)
    return np.concatenate([batch, pad], axis=0), target - b
