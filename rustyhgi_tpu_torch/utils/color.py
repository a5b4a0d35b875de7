"""Color (RGB): the ``.thgic`` container of three planes.

Counterpart of ``rustyhgi_tpu/utils/color.py``, byte for byte.  Each
channel keeps the codec's contract:

* **lossless** presets race two transforms and keep the smaller
  container, green-delta on a tie: green-delta stores ``G, (R-G) & 255,
  (B-G) & 255``, exact since ``R = (dR + G) & 255``; identity stores
  ``R, G, B``;
* **lossy** presets store raw ``R, G, B``, so that the preset's max-error
  bound holds per channel (a delta plane would compound two errors).

Container layout (``.thgic``)::

    u32  magic 0x7C61_A555
    u8   n_planes (3)
    u8   transform (0 = identity/RGB, 1 = green-delta)
    n_planes x { u64 LE length, archive blob (.thgi or .hgi) }

The three planes go to the codec as one ``[3, H, W]`` batch: one K1 call
a transform, one K2 call for the full decode, K5 a plane for a preview.
Each plane decodes with the predictor its archive's tag names.

The encode's stages are spans (:func:`..utils.profiling.span`, off by
default): ``color.encode`` a transform, holding ``color.forward`` (the
transform on the device; the planes' bytes), ``color.grids`` (K1 and the
grids' copy to the host; the bytes fetched) and ``color.plane`` a plane
(``write_archive``, under which the ``.thgi`` race's spans nest; the
blob's bytes).  :data:`TRANSFORM_WINS` counts the transform each lossless
encode keeps.
"""

from __future__ import annotations

import collections
import struct
import threading

import numpy as np
import torch

from ..models.codec import HGICodec
from ..ops.predictors import predictor_name_for_tag
from ..ops.quantizers import linear_error
from .container import Archive, read_archive, read_preview, write_archive
from .profiling import span

__all__ = [
    "THGIC_MAGIC",
    "TRANSFORM_WINS",
    "encode_color",
    "decode_color",
    "decode_color_preview",
    "load_rgb",
    "save_rgb",
]

THGIC_MAGIC = 0x7C61_A555

_T_IDENTITY = 0
_T_GDELTA = 1

_HEAD = struct.Struct("<IBB")  # magic, n_planes, transform

# Lossless encodes by the transform kept, "gdelta" or "identity": one count
# for each encode_color call that races them.  Clear it to start afresh.
TRANSFORM_WINS: collections.Counter = collections.Counter()
_WINS_LOCK = threading.Lock()


def load_rgb(path: str) -> np.ndarray:
    """Load an image file as uint8 [H, W, 3] RGB."""
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"), dtype=np.uint8)


def save_rgb(path: str, rgb: np.ndarray) -> None:
    """Save a uint8 [H, W, 3] image as RGB (format by extension)."""
    from PIL import Image

    Image.fromarray(np.ascontiguousarray(rgb, np.uint8)).save(path)


def _forward(planes: torch.Tensor, transform: int) -> torch.Tensor:
    """``[3, H, W]`` R, G, B -> the stored planes (on their device)."""
    if transform == _T_IDENTITY:
        return planes
    r, g, b = planes.to(torch.int16)
    return torch.stack([g, (r - g) & 255, (b - g) & 255]).to(torch.uint8)


def _inverse(planes: torch.Tensor, transform: int) -> torch.Tensor:
    """The stored planes -> ``[3, h, w]`` R, G, B."""
    if transform == _T_IDENTITY:
        return planes
    g, dr, db = planes.to(torch.int16)
    return torch.stack([(dr + g) & 255, g, (db + g) & 255]).to(torch.uint8)


def _encode_one(codec, planes: torch.Tensor, transform: int, fmt: str) -> bytes:
    """One transform's ``.thgic``: one K1 call on the three planes, one
    copy of the grids to the host, then a host archive a plane."""
    with span("color.encode"):
        with span("color.forward", planes.numel()):
            stored = _forward(planes, transform)
        with span("color.grids") as sp:
            grids = codec.encode_plane(stored)[0].cpu().numpy()
            sp.nbytes = grids.nbytes
        h, w = grids.shape[1:]
        parts = [_HEAD.pack(THGIC_MAGIC, 3, transform)]
        for grid in grids:
            with span("color.plane") as sp:
                blob = write_archive(Archive(codec.metadata_for(h, w), grid), fmt)
                sp.nbytes = len(blob)
            parts.append(struct.pack("<Q", len(blob)))
            parts.append(blob)
        return b"".join(parts)


def encode_color(codec, rgb: np.ndarray, fmt: str = "thgi") -> bytes:
    """Encode a uint8 [H, W, 3] RGB image to a ``.thgic`` container.

    ``codec`` is an :class:`HGICodec`; the image goes to its
    device once.  Lossless presets race green-delta against identity and
    keep the smaller (green-delta on a tie); lossy presets store raw
    channels.  A lossless encode counts the transform it keeps in
    :data:`TRANSFORM_WINS`.
    """
    rgb = np.asarray(rgb, dtype=np.uint8)
    if rgb.ndim != 3 or rgb.shape[2] != 3:
        raise ValueError(f"expected [H, W, 3] RGB, got {rgb.shape}")
    planes = torch.from_numpy(np.ascontiguousarray(np.moveaxis(rgb, 2, 0))).to(codec.device)
    if linear_error(codec.quantization) != 0:
        return _encode_one(codec, planes, _T_IDENTITY, fmt)
    gdelta = _encode_one(codec, planes, _T_GDELTA, fmt)
    identity = _encode_one(codec, planes, _T_IDENTITY, fmt)
    kept = "identity" if len(identity) < len(gdelta) else "gdelta"
    with _WINS_LOCK:
        TRANSFORM_WINS[kept] += 1
    return identity if kept == "identity" else gdelta


def _split_thgic(data: bytes):
    """A ``.thgic`` -> ``(transform, [blob, blob, blob])``, with the JAX
    reader's errors."""
    if len(data) < _HEAD.size:
        raise ValueError("truncated archive")
    magic, n_planes, transform = _HEAD.unpack_from(data, 0)
    if magic != THGIC_MAGIC:
        raise ValueError("incorrect magic number")
    if n_planes != 3 or transform not in (_T_IDENTITY, _T_GDELTA):
        raise ValueError(f"unsupported .thgic: planes={n_planes} transform={transform}")
    off = _HEAD.size
    blobs = []
    for _ in range(n_planes):
        if off + 8 > len(data):
            raise ValueError("truncated archive")
        (blen,) = struct.unpack_from("<Q", data, off)
        off += 8
        if off + blen > len(data):
            raise ValueError("truncated archive")
        blobs.append(data[off : off + blen])
        off += blen
    return transform, blobs


def _codec_for(metas, device, backend):
    """The one codec the planes' metadata names: their depth and the
    predictor of their tag.  Planes that differ in shape, depth or tag are
    refused."""
    if len({(m.height, m.width, m.scale_level, m.interpolation) for m in metas}) != 1:
        raise ValueError(".thgic planes differ in shape, depth or predictor tag")
    meta = metas[0]
    return HGICodec(
        meta.scale_level, predictor=predictor_name_for_tag(meta.interpolation),
        backend=backend, device=device,
    )


def _to_rgb(planes: torch.Tensor, transform: int) -> np.ndarray:
    return np.moveaxis(_inverse(planes, transform).cpu().numpy(), 0, 2)


def decode_color(data: bytes, device="cuda", backend: str = "auto") -> np.ndarray:
    """Decode a ``.thgic`` back to uint8 [H, W, 3] RGB: one K2 call on the
    three grids, on ``device`` (the blobs' fast codecs also read there)."""
    transform, blobs = _split_thgic(data)
    archives = [read_archive(b, device=device) for b in blobs]
    codec = _codec_for([a.metadata for a in archives], device, backend)
    planes = codec.decode_plane(np.stack([a.grid for a in archives]))
    return _to_rgb(planes, transform)


def decode_color_preview(data: bytes, upto: int, device="cuda", backend: str = "auto") -> np.ndarray:
    """Progressive color decode -> uint8 [h, w, 3], each plane's level-
    ``upto`` preview (K5 a plane).

    The transforms are per pixel, so they commute with the preview
    lattice: the result is the full decode sampled on it.
    """
    transform, blobs = _split_thgic(data)
    reads = [read_preview(blob, upto, device=device) for blob in blobs]
    codec = _codec_for([r[0] for r in reads], device, backend)
    planes = [
        codec.decode_preview(anchors, subbands, (meta.height, meta.width), eff)
        for meta, anchors, subbands, eff in reads
    ]
    return _to_rgb(torch.stack(planes), transform)
