"""Entry points: the codec's forward step, and a dry run of the
sharded codec over n places.

Counterpart of the repository root's ``__graft_entry__.py``.  Both run on
the card unless the caller names the CPU.  The card machine has one GPU,
so :func:`dryrun_multichip` puts its n places on that one card
(``make_mesh(devices=[cuda:0] * n)``): the batch split, the byte
invariance across mesh shapes and the kernels are the same as on n cards.
Unlike the JAX dry run, it never falls back to CPU places when it finds
too few devices.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

__all__ = ["entry", "dryrun_multichip"]


def entry(device="cuda"):
    """(forward fn, example args) for the codec: the L4 medium
    closed-loop encode (predict, quantize, overflow fixup, reconstruct)
    returning the residual grid and the reconstruction, K1 on ``cuda``;
    the example is the 256x256 ``(x*y) & 255`` plane on ``device``."""
    from .models.codec import HGICodec

    forward = HGICodec(4, "medium", device=device).encode_plane
    example = torch.from_numpy(
        ((np.arange(256)[:, None] * np.arange(256)[None, :]) & 0xFF).astype(np.uint8)
    ).to(device)
    return forward, (example,)


def _np(t) -> np.ndarray:
    return t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def dryrun_multichip(n_devices: int, devices: Optional[Sequence] = None) -> None:
    """Run the full sharded codec step once over an n-place mesh.

    ``devices`` defaults to the first CUDA device n times.  The proof, as
    in the JAX dry run:

    * lossless AND medium closed-loop encode -> decode -> verify on a
      ragged 22x37 plane at L3 (no side a multiple of the lattice), a batch
      of 2n, on an (n, 1) and, for even n, an (n/2, 2) mesh: the decode
      equals the encoder's reconstruction, the error keeps the preset's
      bound, the residual histogram sums to the pixel count;
    * grids, histogram and the shared-table ``write_thgi`` bytes do not
      depend on the mesh shape, and the archive reads back;
    * the subband leg (K3, K5): its payload and decode do not depend on
      the mesh shape, and the decode keeps the bound;
    * one ``write_fast`` frame (K1 + X1) read back by ``read_thgi`` with
      the sharded encode's residual bytes.
    """
    from .models.codec import HGICodec
    from .ops.entropy import normalized_freqs
    from .ops.quantizers import QuantizationLevel, linear_error
    from .parallel.mesh import make_mesh
    from .parallel.sharded import (
        decode_batch_sharded,
        decode_subbands_batch_sharded,
        encode_batch_sharded,
        encode_subbands_batch_sharded,
    )
    from .utils.container import Archive, read_thgi, write_thgi

    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device for the dry run; pass devices=[torch.device('cpu')] * n "
                "to run it on the CPU"
            )
        devices = [torch.device("cuda", 0)] * n_devices
    devices = [torch.device(d) for d in devices]
    if len(devices) != n_devices:
        raise ValueError(f"need {n_devices} devices, got {len(devices)}")
    meshes = [make_mesh((n_devices, 1), devices)]
    if n_devices % 2 == 0:
        meshes.append(make_mesh((n_devices // 2, 2), devices))
    home = devices[0]

    levels = 3
    rng = np.random.default_rng(0)
    images = rng.integers(0, 256, size=(2 * n_devices, 22, 37), dtype=np.uint8)

    for preset in (QuantizationLevel.LOSSLESS, QuantizationLevel.MEDIUM):
        bound = linear_error(preset)
        per_mesh = []
        for mesh in meshes:
            grids, recons, hist = encode_batch_sharded(
                images, levels, preset, mesh=mesh, with_histogram=True
            )
            decoded = _np(decode_batch_sharded(grids, levels, mesh=mesh))
            if not np.array_equal(decoded, _np(recons)):
                raise AssertionError(f"{preset.name}: decode != the closed-loop recon")
            err = int(np.abs(decoded.astype(np.int64) - images).max())
            if err > bound:
                raise AssertionError(f"{preset.name}: max |err| {err} > {bound}")
            if int(_np(hist).sum()) != images.size:
                raise AssertionError(f"{preset.name}: histogram does not sum to the pixels")
            per_mesh.append((_np(grids), _np(hist)))
        for grids_np, hist_np in per_mesh[1:]:
            if not (np.array_equal(grids_np, per_mesh[0][0])
                    and np.array_equal(hist_np, per_mesh[0][1])):
                raise AssertionError(f"{preset.name}: grids or histogram depend on the mesh")

        codec = HGICodec(levels, preset, device=home)
        blobs = []
        for grids_np, hist_np in per_mesh:
            freqs = normalized_freqs(hist_np.astype(np.int64))
            blob = write_thgi(Archive(codec.metadata_for(*images.shape[1:]), grids_np[0]),
                              freqs=freqs)
            if not np.array_equal(read_thgi(blob, freqs=freqs, device=home).grid, grids_np[0]):
                raise AssertionError(f"{preset.name}: the shared-table archive reads back wrong")
            blobs.append(blob)
        if any(b != blobs[0] for b in blobs[1:]):
            raise AssertionError(f"{preset.name}: shared-table bytes depend on the mesh")

    preset = QuantizationLevel.MEDIUM
    per_mesh_sb = []
    for mesh in meshes:
        a, s = encode_subbands_batch_sharded(images, levels, preset, mesh=mesh)
        dec = decode_subbands_batch_sharded(a, s, images.shape[1:], levels, mesh=mesh)
        per_mesh_sb.append(([_np(a)] + [_np(q) for quads in s for q in quads], _np(dec)))
    for flat, dec in per_mesh_sb[1:]:
        if not (all(np.array_equal(x, y) for x, y in zip(flat, per_mesh_sb[0][0]))
                and np.array_equal(dec, per_mesh_sb[0][1])):
            raise AssertionError("the subband payload or its decode depends on the mesh")
    err = int(np.abs(per_mesh_sb[0][1].astype(np.int64) - images).max())
    if err > linear_error(preset):
        raise AssertionError(f"subband decode: max |err| {err}")

    blob = HGICodec(levels, preset, device=home).write_fast(images[0])
    grid0, _, _ = encode_batch_sharded(images, levels, preset, mesh=meshes[0])
    if not np.array_equal(read_thgi(blob, device=home).grid, _np(grid0)[0]):
        raise AssertionError("the write_fast frame reads back another grid")
