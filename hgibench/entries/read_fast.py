"""A client's read: ``HGICodec.decode(read_archive(blob))`` -> the
uint8 plane on the host, from a fast ``.thgi`` (codec 7).

Set-up makes the pool of seeded planes, has the reference writer (not
the program) code them into fast ``.thgi`` archives, in seconds that
``setup_s`` leaves out, builds the codec and reads every archive twice,
which loads the host decoder and the kernels and warms the one shape the
window uses.  The check compares each kept plane with the reference
decoder's plane of the same archive, pixel for pixel, and with its
source plane, within the preset's error.
"""

from __future__ import annotations

import time

import numpy as np

from ..planes import natural_planes
from ..reference import formats, hgi

__all__ = ["setup", "request", "account", "timers", "counters", "finish", "release", "check",
           "work", "control"]


class State:
    pass


def setup(cfg: dict, mix: dict, seed: int, device: str, log=print) -> State:
    import torch
    from rustyhgi_tpu_torch.models.codec import HGICodec
    from rustyhgi_tpu_torch.utils import container

    c = cfg["codec"]
    s = State()
    s.cfg, s.device, s.container = cfg, device, container
    s.shape = (int(c["height"]), int(c["width"]))
    s.pool = natural_planes(seed, int(mix["pool"]), *s.shape, float(cfg["noise"]), device).cpu().numpy()
    t = time.perf_counter()
    s.blobs = formats.write_fast(s.pool, int(c["levels"]), c["preset"], c["predictor"])
    s.reference_s = time.perf_counter() - t  # the benchmark's, not the program's, set-up
    s.codec = HGICodec(int(c["levels"]), c["preset"], predictor=c["predictor"], device=device)
    s.codec.compile(s.shape)
    s.control = None
    for _ in range(2):
        for item in range(len(s.blobs)):
            request(s, item)
    if device != "cpu":
        torch.cuda.synchronize()
    return s


def request(s: State, item: int) -> np.ndarray:
    if s.control is not None:
        return s.control[item]
    return s.codec.decode(s.container.read_archive(s.blobs[item], device=s.device))


def account(s: State, item: int, out) -> tuple:
    """``(archive bytes, source pixels)`` of a served request."""
    return len(s.blobs[item]), s.shape[0] * s.shape[1]


def timers(s: State) -> dict:
    from rustyhgi_tpu_torch.models import codec
    from rustyhgi_tpu_torch.ops import tpurans
    from rustyhgi_tpu_torch.utils import container

    return {
        "read_archive": [(container, "read_archive")],
        "rans_decode": [(tpurans, "decode_bytes")],
        "decode": [(codec.HGICodec, "decode")],
        "h2d": [(codec.HGICodec, "_to_device")],
    }


def counters() -> dict:
    from rustyhgi_tpu_torch.ops import cuda_codec

    return {"K2": (cuda_codec, "decode_launches")}


def finish(s: State, window) -> None:
    pass


def release(s: State) -> None:
    s.codec = None


def control(s: State) -> None:
    """The reference decoder in the program's place, reading the finest
    level's residuals as 0, as a decode of the coarser levels alone would:
    it breaks the stated error bound.  Its planes are made once an
    archive."""
    s.control = formats.read_fast(s.blobs, skip_finest=True)


def check(s: State, window, seed: int, log=print) -> list:
    bound = hgi.ERRORS[s.cfg["codec"]["preset"]]
    ref = formats.read_fast(s.blobs)
    items = {r.index: r.item for r in window.requests}
    differing, worst = [], 0
    for i, plane in window.kept.items():
        plane = np.asarray(plane)
        if plane.shape != s.shape or plane.dtype != np.uint8:
            differing.append(i)
            worst = 256
            continue
        if not np.array_equal(plane, ref[items[i]]):
            differing.append(i)
        err = np.abs(plane.astype(np.int16) - s.pool[items[i]].astype(np.int16)).max()
        worst = max(worst, int(err))
    if differing:
        log(f"check: {len(differing)} of {len(window.kept)} planes differ from the reference's, "
            f"first at request {differing[0]}")
    return [("failed", window.failed, 0), ("planes_differing", len(differing), 0),
            ("max_abs_error", worst, bound)]


def work(s: State, req) -> dict:
    from .. import roofline

    return {"K2": roofline.k2_work(1, s.shape[0] * s.shape[1])}
