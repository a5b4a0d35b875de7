"""rustyhgi_tpu_torch — the Hierarchical Grid Interpolation codec on PyTorch/CUDA.

The PyTorch port of ``rustyhgi_tpu`` (which stays the JAX reference it is
held against).  The encode and decode kernels are hand-written CUDA for
Hopper (``csrc/hgi_codec.cu``, built with ``nvcc`` at first use); on the
CPU the plain PyTorch version of the same codec runs.  This package
imports neither ``jax`` nor ``rustyhgi_tpu``.

Public API::

    from rustyhgi_tpu_torch import HGICodec, read_archive, write_archive
    codec = HGICodec(levels=4, quantization="medium")   # device="cuda"
    archive = codec.encode(image_u8_hw)                 # kernel encode
    blob = write_archive(archive, "hgi")                # byte-compatible .hgi
    image = codec.decode(read_archive(blob))

This slice ports the ``.hgi`` main path; ROADMAP.md lists what follows.
"""

from .models.codec import CodecMetrics, HGICodec
from .ops.quantizers import (
    QuantizationLevel,
    linear_error,
    linear_quantize,
    linear_table,
    quantize_fn,
)
from .utils.container import (
    Archive,
    Interpolation,
    Metadata,
    read_archive,
    read_hgi,
    write_archive,
    write_hgi,
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
    "write_archive",
    "write_hgi",
    "linear_error",
    "linear_quantize",
    "linear_table",
    "quantize_fn",
    "__version__",
]
