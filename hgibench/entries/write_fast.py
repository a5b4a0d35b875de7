"""A client's write: ``HGICodec.write_fast(plane)`` -> the fast
``.thgi`` (codec 7) bytes on the host.

Set-up makes the pool of seeded planes on the card, holds them on the
host, builds the codec, and writes every plane of the pool twice, which
builds and loads the kernels and warms every shape the window uses.  The
check compares each kept archive with the reference writer's archive of
the same plane, byte for byte, and decodes each with the reference
decoder against its source plane, within the preset's error.
"""

from __future__ import annotations

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

    c = cfg["codec"]
    s = State()
    s.cfg, s.device = cfg, device
    s.shape = (int(c["height"]), int(c["width"]))
    s.pool = natural_planes(seed, int(mix["pool"]), *s.shape, float(cfg["noise"]), device).cpu().numpy()
    s.codec = HGICodec(int(c["levels"]), c["preset"], predictor=c["predictor"], device=device)
    s.codec.compile(s.shape)
    s.control = None
    for _ in range(2):
        for item in range(len(s.pool)):
            request(s, item)
    if device != "cpu":
        torch.cuda.synchronize()
    return s


def request(s: State, item: int) -> bytes:
    if s.control is not None:
        return s.control[item]
    return s.codec.write_fast(s.pool[item])


def account(s: State, item: int, out: bytes) -> tuple:
    """``(archive bytes, source pixels)`` of a served request."""
    return len(out), s.shape[0] * s.shape[1]


def timers(s: State) -> dict:
    from rustyhgi_tpu_torch.models import codec
    from rustyhgi_tpu_torch.ops import tpurans

    return {
        "write_fast": [(codec.HGICodec, "write_fast")],
        "h2d": [(codec.HGICodec, "_to_device")],
        "fetch": [(tpurans, "fetch_heads"), (tpurans, "fetch_words")],
        "framing": [(tpurans, "frame_payloads"), (codec, "frame_rans_tpu")],
    }


def counters() -> dict:
    from rustyhgi_tpu_torch.ops import cuda_codec, tpurans

    return {"K1": (cuda_codec, "encode_launches"), "X1": (tpurans, "rans_launches")}


def finish(s: State, window) -> None:
    pass


def release(s: State) -> None:
    s.codec = None


def control(s: State) -> None:
    """The reference writer in the program's place, quantizing with the
    next coarser preset's error (30 for medium, 10 for lossless) under
    the configuration's header: it breaks the stated error bound.  Its
    archives are made once a plane."""
    c = s.cfg["codec"]
    coarser = {0: 10, 10: 20, 20: 30, 30: 40}[hgi.ERRORS[c["preset"]]]
    s.control = formats.write_fast(s.pool, int(c["levels"]), c["preset"], c["predictor"],
                                   error=coarser)


def check(s: State, window, seed: int, log=print) -> list:
    c = s.cfg["codec"]
    bound = hgi.ERRORS[c["preset"]]
    ref = formats.write_fast(s.pool, int(c["levels"]), c["preset"], c["predictor"])
    items = {r.index: r.item for r in window.requests}
    differing = [i for i, blob in window.kept.items() if blob != ref[items[i]]]
    worst = 0
    distinct = {}
    for i, blob in window.kept.items():
        distinct.setdefault(blob, items[i])
    blobs = list(distinct)
    for lo in range(0, len(blobs), 16):
        group = blobs[lo : lo + 16]
        try:
            planes = formats.read_fast(group)
        except Exception as e:  # a malformed archive fails the check, whatever it breaks
            log(f"check: the reference cannot read an archive: {e!r}")
            worst = 256
            continue
        for blob, plane in zip(group, planes):
            err = np.abs(plane.astype(np.int16) - s.pool[distinct[blob]].astype(np.int16)).max()
            worst = max(worst, int(err))
    if differing:
        log(f"check: {len(differing)} of {len(window.kept)} archives differ from the reference's, "
            f"first at request {differing[0]}")
    return [("failed", window.failed, 0), ("archives_differing", len(differing), 0),
            ("max_abs_error", worst, bound)]


def work(s: State, req) -> dict:
    from .. import roofline

    n = s.shape[0] * s.shape[1]
    lossy = s.cfg["codec"]["preset"] != "lossless"
    words = formats.coded_words(req.info["bytes"], n)
    return {"K1": roofline.k1_work(1, n, lossy), "X1": roofline.x1_work(1, n, words)}
