"""The multi-process tiled tier: a large plane encoded and decoded by
several processes, on ``torch.distributed``.

Counterpart of ``rustyhgi_tpu/parallel/multihost.py``.  Design:

* :func:`initialize` joins the process group once a process; the process
  count below is its world size (1 without a group).
* Tiles are cut in the row-major order of :func:`.sharded.tile_plane` and
  the batch is padded to a multiple of ``world x local devices``; rank
  ``r`` owns the contiguous tiles ``[r * B / W, (r + 1) * B / W)`` and
  encodes them over its own mesh (:func:`.sharded.encode_batch_sharded`:
  K1 on a CUDA device).  That is JAX's batch sharding over its rank-major
  global device list, so each rank codes the tiles a JAX process with as
  many devices would.
* **Entropy coding is local**: every rank brings only its own residual
  tiles to the host and codes them there; the only exchange is an
  all-gather of the *compressed* blocks, each framed with its index,
  length and CRC32, so a rank ships about ``compressed / W`` bytes, never
  the raw plane.  Every rank returns the same ordered block list, and the
  bytes do not depend on the process count: a block depends only on its
  tile and on the shared table.
* ``shared_table=True`` counts the residual bytes of the real tiles (the
  batch padding left out, so that the table does not depend on the
  world size), sums the 256 counts over the ranks and derives one rANS
  table on every rank (``ops.entropy.normalized_freqs``); the blocks are
  then coded table-stripped and :func:`write_thgit_multihost` stores the
  table once.
* Faults: a tile's host coding retries once (idempotent work); every
  block's CRC is checked after the gather; missing, corrupt and
  duplicated tiles raise :class:`TileCodingError` naming them.  In the
  decode every rank learns every rank's bad blocks before it raises, so
  no rank is left waiting in a collective that its peer has deserted.

**Every collective runs on gloo, on the card too.**  What crosses between
ranks is host data: the coded blocks, a 256-bin count and the decoded
plane that the caller receives on the host (JAX gathers on the host too,
through ``multihost_utils.process_allgather``).  NCCL would move device
tensors that then go to the host all the same, and it cannot put two
ranks on one GPU, which is how a one-card machine runs this tier.
"""

from __future__ import annotations

import dataclasses
import struct
import zlib
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..ops.entropy import normalized_freqs
from ..ops.predictors import predictor_name_for_tag, predictor_tag
from ..ops.quantizers import QuantizationLevel
from ..utils.container import (
    Archive,
    Metadata,
    read_archive,
    thgit2_block_frame,
    thgit2_header,
    write_archive,
)
from .mesh import Mesh, make_mesh
from .sharded import decode_batch_sharded, encode_batch_sharded, pad_batch, tile_plane, untile_plane

__all__ = [
    "MultiHostConfig",
    "TiledEncodeResult",
    "TileCodingError",
    "initialize",
    "encode_tiled_multihost",
    "decode_tiled_multihost",
    "write_thgit_multihost",
]

_FRAME = struct.Struct("<IQI")  # tile index, block length, CRC32


@dataclasses.dataclass
class MultiHostConfig:
    """Where the process group meets: ``coordinator_address`` is
    ``host:port`` of rank 0, ``process_id`` this process's rank."""

    coordinator_address: Optional[str] = None
    num_processes: Optional[int] = None
    process_id: Optional[int] = None


def initialize(config: MultiHostConfig = MultiHostConfig()) -> None:
    """Join the gloo process group (no-op for a single-process run)."""
    if config.num_processes is None or config.num_processes <= 1:
        return
    dist.init_process_group(
        "gloo",
        init_method=f"tcp://{config.coordinator_address}",
        world_size=config.num_processes,
        rank=config.process_id,
    )


def _world() -> Tuple[int, int]:
    """(process count, this process's rank)."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


@dataclasses.dataclass
class TiledEncodeResult:
    """Result of a distributed tiled encode (identical on every process).

    ``blocks``: all per-tile archives, row-major tile order.
    ``freqs``: the shared rANS table (None unless shared_table=True).
    ``local_indices``: tiles entropy-coded by THIS process (disjoint
    across processes, union = all tiles).
    ``dcn_payload_bytes``: bytes each process shipped in the block
    gather, its padded row (0 for single-process runs): compressed
    scale, never the raw plane.
    ``shape``: the original (H, W) for ``untile_plane``.
    """

    blocks: List[bytes]
    freqs: Optional[np.ndarray]
    local_indices: List[int]
    dcn_payload_bytes: int
    shape: Tuple[int, int]

    @property
    def compressed_bytes(self) -> int:
        return sum(len(b) for b in self.blocks)


class TileCodingError(RuntimeError):
    """A tile failed to encode/verify; ``indices`` names the tiles."""

    def __init__(self, msg: str, indices: Sequence[int]):
        super().__init__(f"{msg}: tiles {list(indices)[:16]}")
        self.indices = list(indices)


def _share(n_tiles: int, mesh: Mesh) -> Tuple[int, int, int]:
    """(padded batch B, first tile, end tile) of this rank's share."""
    world, rank = _world()
    step = world * mesh.size
    b = -(-n_tiles // step) * step
    per = b // world
    return b, rank * per, (rank + 1) * per


def _all_gather(t: torch.Tensor) -> List[torch.Tensor]:
    out = [torch.empty_like(t) for _ in range(_world()[0])]
    dist.all_gather(out, t)
    return out


def _encode_share(tiles: np.ndarray, levels: int, quantization, mesh: Mesh,
                  predictor: str) -> np.ndarray:
    """K1 over the local mesh on this rank's tiles; the residual grids on
    the host."""
    grids, _, _ = encode_batch_sharded(tiles, levels, quantization, mesh=mesh, predictor=predictor)
    return grids.cpu().numpy()


def _shared_freqs(real_grids: np.ndarray) -> np.ndarray:
    """The rANS table of every rank's real residual bytes."""
    counts = torch.from_numpy(np.bincount(real_grids.reshape(-1), minlength=256).astype(np.int64))
    if _world()[0] > 1:
        dist.all_reduce(counts, op=dist.ReduceOp.SUM)
    return normalized_freqs(counts.numpy())


def _encode_one_block(meta: Metadata, grid: np.ndarray, fmt: str, freqs, retries: int = 1) -> bytes:
    """Entropy-code one tile with retry (idempotent host work)."""
    last = None
    for _ in range(retries + 1):
        try:
            return write_archive(Archive(meta, grid), fmt, freqs=freqs if fmt == "thgi" else None)
        except Exception as e:  # transient coder failure
            last = e
    raise last


def collect_blocks(rows: Sequence[bytes], n_tiles: int) -> List[bytes]:
    """The ordered block list from the gathered rows, one a process, each
    a run of frames ``<IQI`` (tile index, length, CRC32) + block.

    Raises :class:`TileCodingError` for a tile that two processes sent
    (an assignment bug, not corruption), for a block whose length or
    CRC32 does not match (corruption in transit), and for tiles that no
    process sent, in that order.
    """
    got = {}
    corrupt: List[int] = []
    dups: List[Tuple[int, int]] = []  # (process, tile)
    for p, row in enumerate(rows):
        off = 0
        while off + _FRAME.size <= len(row):
            i, blen, crc = _FRAME.unpack_from(row, off)
            off += _FRAME.size
            block = row[off : off + blen]
            off += blen
            if len(block) != blen or zlib.crc32(block) != crc:
                corrupt.append(i)
                continue
            if i in got:
                dups.append((p, i))
                continue
            got[i] = block
    if dups:
        procs = sorted({p for p, _ in dups})
        raise TileCodingError(
            f"duplicate tile assignment (driver bug) from processes {procs}",
            sorted({i for _, i in dups}),
        )
    if corrupt:
        raise TileCodingError("corrupt blocks after DCN gather", corrupt)
    missing = [i for i in range(n_tiles) if i not in got]
    if missing:
        raise TileCodingError("tiles missing after gather", missing)
    return [got[i] for i in range(n_tiles)]


def _gather_blocks(local: List[Tuple[int, bytes]], n_tiles: int) -> Tuple[List[bytes], int]:
    """All-gather the variable-length blocks of every process.

    ``local`` is this process's (tile index, block) list.  The lengths
    cross first, as an int64 each, then every row padded to the longest.
    Returns ``(blocks, dcn_payload_bytes)``: the padded row this process
    shipped, 0 in one process.
    """
    payload = b"".join(_FRAME.pack(i, len(b), zlib.crc32(b)) + b for i, b in local)
    if _world()[0] == 1:
        return collect_blocks([payload], n_tiles), 0
    lens = [int(n) for n in _all_gather(torch.tensor([len(payload)], dtype=torch.int64))]
    maxlen = max(max(lens), 1)
    buf = torch.zeros(maxlen, dtype=torch.uint8)
    if payload:
        buf[: len(payload)] = torch.frombuffer(bytearray(payload), dtype=torch.uint8)
    rows = [r.numpy().tobytes()[:n] for r, n in zip(_all_gather(buf), lens)]
    return collect_blocks(rows, n_tiles), maxlen


def encode_tiled_multihost(
    plane: np.ndarray,
    tile: Tuple[int, int],
    levels: int,
    quantization: QuantizationLevel,
    fmt: str = "thgi",
    mesh_shape: Optional[Tuple[int, int]] = None,
    shared_table: bool = False,
    predictor: str = "crossed",
    devices: Optional[Sequence] = None,
) -> TiledEncodeResult:
    """Encode a large plane as tiled independent streams across processes.

    Every process encodes its share of the tiles on its local mesh
    (``mesh_shape`` over ``devices``, as :func:`.mesh.make_mesh` takes
    them: every CUDA device by default, the CPU only when named) and
    entropy-codes ONLY those tiles on its own host; the compressed blocks
    are all-gathered, so every process returns the identical
    :class:`TiledEncodeResult`, the same for any process count.

    ``shared_table=True`` sums the residual histogram of the real tiles
    over the processes, derives one rANS table on every process and codes
    all blocks against it table-stripped; persist with
    :func:`write_thgit_multihost`, which stores the table once.
    """
    tiles, shape = tile_plane(plane, tile)
    n_tiles = tiles.shape[0]
    mesh = make_mesh(mesh_shape, devices)
    b, lo, hi = _share(n_tiles, mesh)
    padded, _ = pad_batch(tiles, b)
    grids = _encode_share(padded[lo:hi], levels, quantization, mesh, predictor)
    n_real = max(0, min(hi, n_tiles) - lo)  # the rest is batch padding

    freqs = _shared_freqs(grids[:n_real]) if shared_table else None
    th, tw = tile
    meta = Metadata(quantization, predictor_tag(predictor), tw, th, levels)
    local = [(lo + j, _encode_one_block(meta, grids[j], fmt, freqs)) for j in range(n_real)]
    blocks, dcn = _gather_blocks(local, n_tiles)
    return TiledEncodeResult(
        blocks=blocks,
        freqs=freqs,
        local_indices=[i for i, _ in local],
        dcn_payload_bytes=dcn,
        shape=shape,
    )


def _read_share(blocks, lo: int, hi: int, n_tiles: int, tile, freqs, levels: int, interp: int,
                device) -> Tuple[np.ndarray, List[int], List[int]]:
    """This rank's residual tiles from its own blocks, read on the host:
    ``(grids, undecodable tiles, tiles whose metadata disagree)``."""
    th, tw = tile
    chunk = np.zeros((hi - lo, th, tw), np.uint8)
    bad: List[int] = []
    mismatched: List[int] = []
    for j, gi in enumerate(range(lo, min(hi, n_tiles))):
        try:
            archive = read_archive(bytes(blocks[gi]), freqs=freqs, device=device)
        except Exception:
            bad.append(gi)
            continue
        if archive.grid.shape != (th, tw):
            bad.append(gi)
            continue
        if archive.metadata.scale_level != levels or archive.metadata.interpolation != interp:
            mismatched.append(gi)
            continue
        chunk[j] = archive.grid
    return chunk, bad, mismatched


def _agree_faults(n_tiles: int, bad: List[int], mismatched: List[int]):
    """Every rank's bad and mismatched tiles, on every rank."""
    if _world()[0] == 1:
        return bad, mismatched
    marks = torch.zeros(n_tiles, dtype=torch.int64)
    marks[torch.tensor(bad, dtype=torch.long)] = 2
    marks[torch.tensor(mismatched, dtype=torch.long)] = 1
    dist.all_reduce(marks, op=dist.ReduceOp.MAX)
    return ((marks == 2).nonzero().flatten().tolist(),
            (marks == 1).nonzero().flatten().tolist())


def decode_tiled_multihost(
    blocks: Sequence[bytes],
    shape: Tuple[int, int],
    tile: Tuple[int, int],
    freqs: Optional[np.ndarray] = None,
    mesh_shape: Optional[Tuple[int, int]] = None,
    gather: bool = True,
    devices: Optional[Sequence] = None,
) -> Optional[np.ndarray]:
    """Distributed decode of a tiled archive (mirror of the encode).

    Every process entropy-decodes ONLY the blocks of its own share on its
    host and decodes them on its local mesh (K2 on a CUDA device), with
    the predictor that the blocks' tag names.  With ``gather=True`` the
    decoded tiles are all-gathered on the host and every process returns
    the full [H, W] plane; ``gather=False`` returns None.
    """
    th, tw = tile
    h, w = shape
    n_tiles = (-(-h // th)) * (-(-w // tw))
    if len(blocks) != n_tiles:
        raise TileCodingError("block count does not cover the plane", range(len(blocks), n_tiles))
    mesh = make_mesh(mesh_shape, devices)
    _, lo, hi = _share(n_tiles, mesh)
    device = str(mesh.devices.flat[0])
    # (levels, interp) come from block 0, which every process holds, so a
    # process whose share is only batch padding still joins every
    # collective below instead of raising while its peers wait there.
    try:
        head = read_archive(bytes(blocks[0]), freqs=freqs, device=device)
    except Exception:
        raise TileCodingError("undecodable blocks", [0])
    levels = head.metadata.scale_level
    interp = head.metadata.interpolation

    chunk, bad, mismatched = _read_share(blocks, lo, hi, n_tiles, tile, freqs, levels, interp,
                                         device)
    bad, mismatched = _agree_faults(n_tiles, bad, mismatched)
    if bad:
        raise TileCodingError("undecodable blocks", bad)
    if mismatched:
        raise TileCodingError(
            "blocks disagree with block 0's (levels, interpolation) metadata", mismatched
        )
    decoded = decode_batch_sharded(torch.from_numpy(chunk), int(levels), mesh=mesh,
                                   predictor=predictor_name_for_tag(int(interp)))
    if not gather:
        return None
    tiles_host = decoded.cpu()
    if _world()[0] > 1:
        tiles_host = torch.cat(_all_gather(tiles_host))
    return untile_plane(tiles_host.numpy()[:n_tiles], shape)


def write_thgit_multihost(result: TiledEncodeResult, tile: int) -> bytes:
    """Serialize a :class:`TiledEncodeResult` as a .thgit v2 container.

    The shared rANS table (if any) is stored ONCE in the header; every
    block is CRC32-framed.  Identical bytes on every process.
    """
    h, w = result.shape
    out = [thgit2_header(tile, w, h, len(result.blocks), result.freqs)]
    out.extend(thgit2_block_frame(b) for b in result.blocks)
    return b"".join(out)
