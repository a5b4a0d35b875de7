"""Benchmark suite mirroring the reference's criterion benches.

Counterpart of ``rustyhgi_tpu/utils/benchsuite.py``.  One entry per
reference bench (reference: benches/bench.rs:33-159), same synthetic
1920x1080 ``pixel = (x*y) as u8`` image and levels=4 (bench.rs:15-31),
same throughput convention (criterion's bytes/s equals pixels/s there;
reported as MPix/s):

| bench                  | reference (bench.rs) | here                              |
|------------------------|----------------------|-----------------------------------|
| memory                 | :38-52 memcpy ceiling| device plane copy                 |
| left_top_nop_encode    | :54-63               | K1, LeftTop, no table (lossless)  |
| left_top_quanted_encode| :65-74               | K1, LeftTop, Lossless LUT         |
| crossed_nop_encode     | :76-85               | K1, Crossed, no table (lossless)  |
| crossed_quanted_encode | :87-96               | K1, Crossed, Lossless LUT         |
| decode                 | :98-110              | K2, Crossed decode                |
| serialization          | :112-127             | ``write_hgi`` of one plane (host) |
| compression            | :129-151             | encode + ``write_hgi``, one plane |

The *_nop rows use the NoOp strategy (quantizator.rs:17-34): no table at
all, so K1 takes its lossless specialisation.  The *_quanted rows use the
table-driven Lossless LUT (quantizator.rs:36-73), whose ``identity`` is
False: K1 takes its closed-loop tiles with the 256-entry table in
shared memory, quantize, overflow fixup and recon write included.  The
pairs therefore time different code, as the reference's pairs isolate
traversal cost from LUT-lookup cost.

Device rows are timed on the card with CUDA events around each call,
after a warm-up, with the L2 cache flushed before each (a 64 MiB write,
above the H100's 50 MB; :func:`.profiling.device_samples`): ``samples``
timed calls per bench (criterion uses 25, benches/bench.rs:154-157), the
median reported and the (min, max) spread kept in
:func:`run_suite_stats`.  The host rows use the host
clock.  ``device="cpu"`` runs everything on the CPU with the host clock
(the plain PyTorch engine); ``"cuda"`` without a card raises.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .profiling import device_samples, host_samples, require_device

__all__ = [
    "SUITE", "format_suite", "host_samples", "run_suite", "run_suite_stats", "synthetic",
]

W, H, LEVELS = 1920, 1080, 4  # bench.rs:34-36

SUITE = (
    "memory",
    "left_top_nop_encode",
    "left_top_quanted_encode",
    "crossed_nop_encode",
    "crossed_quanted_encode",
    "decode",
    "serialization",
    "compression",
)


def synthetic(w: int, h: int) -> np.ndarray:
    """The reference's criterion fixture, ``pixel = (x*y) as u8``, h x w."""
    x = np.arange(w, dtype=np.int64)
    y = np.arange(h, dtype=np.int64)
    return ((y[:, None] * x[None, :]) & 0xFF).astype(np.uint8)


def _stat(times, npix) -> Dict[str, float]:
    """Throughput stats from per-call time samples (spread = min..max)."""
    times = np.asarray(times, dtype=np.float64)
    times = times[times > 0]  # a zero-length sample gives no rate
    if times.size == 0:
        return {"mpix_s": 0.0, "mpix_s_min": 0.0, "mpix_s_max": 0.0}
    tput = npix / times / 1e6
    return {
        "mpix_s": float(np.median(tput)),
        "mpix_s_min": float(tput.min()),
        "mpix_s_max": float(tput.max()),
    }


def run_suite_stats(
    device="cuda", batch: int = 8, samples: int = 25
) -> Dict[str, Dict[str, float]]:
    """Run the full suite with criterion-grade statistics.

    Returns ``{bench: {mpix_s, mpix_s_min, mpix_s_max}}`` from
    ``samples`` timing samples per bench (criterion's sample_size=25,
    benches/bench.rs:154-157).  Serialization/compression are measured on
    one plane, device benches on a batch of ``batch`` planes.
    """
    from ..models.codec import HGICodec
    from ..ops import cuda_codec
    from ..ops.quantizers import QuantizationLevel, quantize_fn
    from ..utils.container import write_hgi

    dev = require_device(device)
    image = synthetic(W, H)
    planes = torch.from_numpy(np.broadcast_to(image, (batch, H, W)).copy()).to(dev)
    npix = batch * W * H
    results: Dict[str, Dict[str, float]] = {}

    # memory: device plane copy ceiling (bench.rs:38-52 is host memcpy).
    copy = torch.empty_like(planes)
    results["memory"] = _stat(device_samples(lambda: copy.copy_(planes), samples, dev), npix)

    # *_nop: NoOp strategy (no table; lossless path).  *_quanted:
    # table-driven Lossless LUT (identity False: the closed-loop template).
    combos = {
        "left_top_nop_encode": ("left_top", "noop"),
        "left_top_quanted_encode": ("left_top", "lut"),
        "crossed_nop_encode": ("crossed", "noop"),
        "crossed_quanted_encode": ("crossed", "lut"),
    }
    for name, (pred, strategy) in combos.items():
        quant = quantize_fn(QuantizationLevel.LOSSLESS, strategy)
        table = None if quant.identity else quant.table
        ts = device_samples(
            lambda table=table, pred=pred: cuda_codec.encode_plane(planes, LEVELS, table, pred),
            samples, dev,
        )
        results[name] = _stat(ts, npix)

    grid = cuda_codec.encode_plane(planes, LEVELS)[0]
    ts = device_samples(lambda: cuda_codec.decode_plane(grid, LEVELS), samples, dev)
    results["decode"] = _stat(ts, npix)

    # serialization: host container+entropy stage on one encoded plane.
    codec = HGICodec(LEVELS, QuantizationLevel.LOSSLESS, device=dev)
    archive = codec.encode(image)
    write_hgi(archive)  # warm
    ts = host_samples(lambda: write_hgi(archive), samples)
    results["serialization"] = _stat(ts, W * H)

    # compression: end-to-end encode + serialize of one plane (bench.rs:129).
    def e2e():
        write_hgi(codec.encode(image))

    e2e()
    ts = host_samples(e2e, samples)
    results["compression"] = _stat(ts, W * H)
    return results


def run_suite(device="cuda", batch: int = 8) -> Dict[str, float]:
    """Median-only view of :func:`run_suite_stats` ({bench: MPix/s})."""
    return {
        k: v["mpix_s"]
        for k, v in run_suite_stats(device=device, batch=batch).items()
    }


def format_suite(results) -> str:
    width = max(len(k) for k in results)
    lines = []
    for k, v in results.items():
        if isinstance(v, dict):
            lines.append(
                f"{k:<{width}}  {v['mpix_s']:12,.1f} MPix/s  "
                f"[{v['mpix_s_min']:,.1f} .. {v['mpix_s_max']:,.1f}]"
            )
        else:
            lines.append(f"{k:<{width}}  {v:12,.1f} MPix/s")
    return "\n".join(lines)
