"""Device meshes for the batch split.

Counterpart of ``rustyhgi_tpu/parallel/mesh.py``.  A mesh is a ``(data,
tile)`` grid of ``torch.device``s.  Both axes split a batch of
independent planes (the tiles of one large plane are independent
archives, so there is no halo), so :mod:`.sharded` reads a mesh as its
devices in row-major order.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = ["Mesh", "make_mesh", "DATA_AXIS", "TILE_AXIS"]

DATA_AXIS = "data"
TILE_AXIS = "tile"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A ``(data, tile)`` grid of devices: ``devices`` is an object array
    of ``torch.device`` of that shape."""

    devices: np.ndarray
    axis_names: Tuple[str, str] = (DATA_AXIS, TILE_AXIS)

    @property
    def size(self) -> int:
        return self.devices.size


def make_mesh(
    shape: Optional[Tuple[int, int]] = None,
    devices: Optional[Sequence] = None,
) -> Mesh:
    """A ``(data, tile)`` mesh over ``devices`` (default: every CUDA
    device); ``shape=None`` puts them all on the data axis.

    With no CUDA device and no ``devices`` given it raises: the CPU is
    used only when named, e.g. ``devices=[torch.device("cpu")] * 4``.
    """
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device for the mesh; pass devices=[torch.device('cpu'), ...] "
                "to run on the CPU"
            )
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    if shape is None:
        shape = (len(devices), 1)
    if shape[0] * shape[1] != len(devices):
        raise ValueError(f"mesh shape {shape} != {len(devices)} devices")
    grid = np.empty(len(devices), dtype=object)
    grid[:] = devices
    return Mesh(grid.reshape(shape))
