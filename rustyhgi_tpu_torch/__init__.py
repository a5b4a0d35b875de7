"""rustyhgi_tpu_torch — the Hierarchical Grid Interpolation codec on PyTorch/CUDA.

The PyTorch port of ``rustyhgi_tpu`` (which stays the JAX reference it is
held against).  The encode and decode kernels, on the row-major grid and
on the subband layout, are hand-written CUDA for Hopper
(``csrc/hgi_codec.cu``), and so are the fast mode's device entropy coders,
the lane-parallel rANS and the bit-plane pack (``csrc/hgi_entropy.cu``),
all built with ``nvcc`` at first use; on the CPU the plain PyTorch
version of the same codec runs.  The ``.thgi`` container's
host coders are the repository's native library (``native/``), with
pure-Python twins.  This package imports neither ``jax`` nor
``rustyhgi_tpu``.

Public API::

    from rustyhgi_tpu_torch import HGICodec, read_archive, write_archive
    codec = HGICodec(levels=4, quantization="medium")   # device="cuda"
    archive = codec.encode(image_u8_hw)                 # kernel encode
    blob = write_archive(archive, "hgi")                # byte-compatible .hgi
    image = codec.decode(read_archive(blob))

    anchors, subbands, recon = codec.encode_subbands(image_u8_hw)  # subband layout
    blob = write_thgi(Archive(codec.metadata_for(h, w),
                              codec.assemble_grid(anchors, subbands, (h, w)).cpu().numpy()))
    meta, anchors, subbands = read_thgi_subbands(blob)
    image = codec.decode_subbands(anchors, subbands, (h, w))

    blob = codec.write_fast(image_u8_hw)          # .thgi coded on the device
    blobs = codec.write_fast_batch(images_u8_bhw)

    blob = encode_color(codec, rgb_u8_hw3, fmt="thgi")  # .thgic, three planes
    rgb = decode_color(blob)

The ``.hgi`` main path, the ``.thgi`` subband path, the fast mode, color
(:mod:`.utils.color`) and the tiled tier in one process
(:mod:`.parallel`, the ``.thgit`` container, the CLI's ``encode-tiled``
and ``decode-tiled``) are ported; ROADMAP.md lists what follows.
"""

from .models.codec import CodecMetrics, HGICodec
from .ops.quantizers import (
    QuantizationLevel,
    linear_error,
    linear_quantize,
    linear_table,
    quantize_fn,
)
from .utils.color import decode_color, encode_color
from .utils.container import (
    Archive,
    Interpolation,
    Metadata,
    read_archive,
    read_hgi,
    read_preview,
    read_thgi,
    read_thgi_preview,
    read_thgi_subbands,
    write_archive,
    write_hgi,
    write_thgi,
)

__version__ = "0.1.0"

__all__ = [
    "HGICodec",
    "CodecMetrics",
    "QuantizationLevel",
    "Interpolation",
    "Archive",
    "Metadata",
    "read_archive",
    "read_hgi",
    "read_preview",
    "read_thgi",
    "read_thgi_preview",
    "read_thgi_subbands",
    "encode_color",
    "decode_color",
    "write_archive",
    "write_hgi",
    "write_thgi",
    "linear_error",
    "linear_quantize",
    "linear_table",
    "quantize_fn",
    "__version__",
]
