"""A photo archive keeping RGB photographs losslessly: the command users
run, ``encode -i photo.png -o photo.thgic --color --format thgi -q
lossless``, once an image, called in process through
``rustyhgi_tpu_torch.cli.main``.  The command reads the PNG, codes the
image's planes in two transforms (green-delta and identity; one K1 call on
three planes each, the grids fetched), races the host coders of ``.thgi``
on each of the six planes, and writes the smaller container.

One request is one pass over the suite: an encode command an image, in
turn.  A pass the window's close cuts runs to its end and counts whole,
so every pass of a run holds the same images and bytes.  Set-up makes
the seeded suite (:mod:`..photos`) on the card, writes each image once as
a PNG under ``TMPDIR``, and warms up through the same command on the
first image, which loads the kernels, the native coders and the coders'
thread pool.  The outputs go to a FIFO drained by a process of the
harness (``hgibench/drain.py``'s reader), as in the scene cells; the first
output of each of ``sampled_images`` images drawn from the seed is kept
whole there.  The check builds the reference's ``.thgic`` of every image
(``reference/color.py``: the five planes of each image that the two
transforms store, coded in lockstep by chunks of one shape in worker
processes) and compares every output's digest with it; the kept outputs
are decoded by the reference's decoders against the source images in
workers of their own meanwhile.

The program's counts of transforms kept, ``color.TRANSFORM_WINS``, and
of plane races won by (layout, codec), ``container.RACE_WINS``, are read
around each request; a program without one leaves the requests without
it.
"""

from __future__ import annotations

import hashlib
import multiprocessing
import os
import shutil
import tempfile
import time
from concurrent.futures import ProcessPoolExecutor

import numpy as np

from .. import drain
from ..core import rng
from ..reference import color, hgi, race
from . import encode_tiled_fast as fast

__all__ = ["setup", "request", "timers", "counters", "finish", "release", "check", "count",
           "work", "control", "serve"]

CODECS = ("deflate", "rans", "ctx")  # the race's coders, as the program races them
release = fast.release


def serve(fifo: str, conn) -> None:
    """The drain's protocol (:func:`..drain.serve`), but ``("sample",
    None)`` answers the kept outputs whole, ``{index: bytes}``, and forgets
    them."""
    kept = {}
    while True:
        job = conn.recv()
        if job is None:
            return
        if job[0] == "sample":
            conn.send(kept)
            kept = {}
            continue
        index, keep = job
        digest, marks, data = drain._read(fifo, keep)
        if data is not None:
            kept[index] = data
        conn.send((index, digest, marks))


def _counters():
    """The program's counts of transforms kept and of races won, each None
    in a program without it."""
    from rustyhgi_tpu_torch.utils import color as program_color
    from rustyhgi_tpu_torch.utils import container

    return (getattr(program_color, "TRANSFORM_WINS", None),
            getattr(container, "RACE_WINS", None))


def setup(cfg: dict, mix: dict, seed: int, device: str, log=print):
    import torch
    from PIL import Image
    from rustyhgi_tpu_torch import cli

    from ..photos import photo_suite

    c = cfg["codec"]
    s = fast.State()
    s.cfg, s.device, s.cli = cfg, device, cli
    s.tmp = tempfile.mkdtemp(prefix="hgibench-color-")
    suite = photo_suite(seed, cfg["photo"], int(c["height"]), int(c["width"]), device)
    s.images = [im.cpu().numpy() for im in suite]
    s.paths = []
    for j, im in enumerate(s.images):
        s.paths.append(os.path.join(s.tmp, f"photo{j}.png"))
        Image.fromarray(im).save(s.paths[-1])
    pick = rng(seed, 4)
    s.sampled = sorted(pick.choice(len(s.images), int(cfg["sampled_images"]),
                                   replace=False).tolist())
    rc = cli.main(_argv(s, s.paths[0], os.path.join(s.tmp, "warm.thgic")))
    if rc != 0:
        raise RuntimeError(f"the warm-up's encode exited with {rc}")
    if device != "cpu":
        torch.cuda.synchronize()
    s.fifo = os.path.join(s.tmp, "out.thgic")
    os.mkfifo(s.fifo)
    s.outputs, s.items, s.kept, s.passes, s.sent = [], [], {}, [], 0
    s.transforms, s.wins = {}, {}
    s.control = None
    spawn = multiprocessing.get_context("spawn")
    s.conn, child = spawn.Pipe()
    s.drain = spawn.Process(target=serve, args=(s.fifo, child), name="hgibench-drain",
                            daemon=True)
    s.drain.start()
    child.close()
    return s


def _argv(s, path: str, out: str) -> list:
    c = s.cfg["codec"]
    return ["encode", "-i", path, "-o", out, "--color", "--format", c["format"],
            "--level", str(c["levels"]), "--quantizator", c["preset"], "--predictor",
            c["predictor"], "--device", s.device]


def _encode(s, j: int) -> None:
    """Image ``j`` through the command (or the control's bytes) into the
    FIFO, once the drain has taken the last output."""
    fast._wait_outputs(s, s.sent)
    if not s.drain.is_alive():  # no reader would ever open the FIFO
        raise RuntimeError("the FIFO's drain has ended")
    keep = j in s.sampled and j not in s.kept.values()
    if keep:
        s.kept[s.sent] = j
    s.conn.send((s.sent, keep))
    s.items.append(j)
    s.passes[-1].append(s.sent)
    s.sent += 1
    try:
        if s.control is not None:
            with open(s.fifo, "wb") as f:
                f.write(s.control[j])
            return
        rc = s.cli.main(_argv(s, s.paths[j], s.fifo))
    except BaseException:
        fast._poke(s)
        raise
    if rc != 0:  # the command may have failed before it opened the FIFO
        fast._poke(s)
        raise RuntimeError(f"encode --color exited with {rc} on image {j}")


def request(s, item: int) -> int:
    s.passes.append([])
    counts = list(zip(_counters(), (s.transforms, s.wins)))
    for counter, _ in counts:
        if counter is not None:
            counter.clear()
    for j in range(len(s.paths)):
        _encode(s, j)
    for counter, kept in counts:
        if counter is not None:
            kept[len(s.passes) - 1] = dict(counter)
    return item


def timers(s) -> dict:
    from rustyhgi_tpu_torch import cli
    from rustyhgi_tpu_torch.utils import color as program_color

    return {
        "encode": [(cli, "cmd_encode")],
        "encode_color": [(program_color, "encode_color")],
    }


def counters() -> dict:
    from rustyhgi_tpu_torch.ops import cuda_codec

    return {"K1": (cuda_codec, "encode_launches")}


def finish(s, window) -> None:
    """Collect the outputs of every command the window's passes ran."""
    fast._wait_outputs(s, s.sent)


def _workers() -> int:
    return max(2, min(8, os.cpu_count() or 2))


def _race_job(args):
    planes, levels, preset, predictor = args
    grids, _ = hgi.encode(planes, levels, hgi.ERRORS[preset], predictor)
    return race.race(grids, levels, preset, predictor, codecs=CODECS)[0]


def _decode_job(data: bytes):
    return color.decode(data)


def _reference(s, pool, keep=None, decode=()):
    """The reference's ``.thgic`` and transform of every image, by image,
    and the kept outputs decoded (``decode``: ``[(index, data)]``), by
    index.  The decodes are submitted first; the race's planes of every
    image (:func:`..reference.color.race_planes`), grouped by shape, are
    cut into one chunk a worker left, the chunks shared between the shapes
    by their planes."""
    c = s.cfg["codec"]
    decoding = [(index, pool.submit(_decode_job, data)) for index, data in decode]
    shapes = {}
    for j, im in enumerate(s.images):
        shapes.setdefault(im.shape, []).append(j)
    workers = max(1, _workers() - len(decoding))
    share = {k: max(1, workers * len(v) // len(s.images)) for k, v in shapes.items()}
    share[max(shapes, key=lambda k: len(shapes[k]))] += max(0, workers - sum(share.values()))
    jobs, owners = [], []
    for k, images in shapes.items():
        planes = np.concatenate([color.race_planes(s.images[j]) for j in images])
        step = -(-len(planes) // share[k])
        for lo in range(0, len(planes), step):
            jobs.append((planes[lo : lo + step], int(c["levels"]), c["preset"], c["predictor"]))
            owners.append(k)
    coded = {k: [] for k in shapes}
    for k, got in zip(owners, pool.map(_race_job, jobs)):
        coded[k] += got
    lossless = c["preset"] == "lossless"
    expected = {j: color.assemble(coded[k][5 * i : 5 * i + 5], lossless, keep)
                for k, images in shapes.items() for i, j in enumerate(images)}
    decoded = {}
    for index, fut in decoding:
        try:
            decoded[index] = fut.result()
        except Exception as e:  # a malformed output fails the check, whatever it breaks
            decoded[index] = e
    return expected, decoded


def _pool():
    return ProcessPoolExecutor(_workers(), mp_context=multiprocessing.get_context("spawn"))


def control(s) -> None:
    """The reference in the program's place with the configuration's
    archive guarantee broken (``config["control"]``): ``identity`` (the
    default) keeps the identity transform on every image, so the
    containers are no longer the program's bytes wherever green-delta is
    smaller."""
    kind = s.cfg.get("control", "identity")
    if kind != "identity":
        raise ValueError(f"unknown control {kind!r}")
    with _pool() as pool:
        expected, _ = _reference(s, pool, keep="identity")
    s.control = [expected[j][0] for j in range(len(s.images))]


def check(s, window, seed: int, log=print) -> list:
    bound = hgi.ERRORS[s.cfg["codec"]["preset"]]
    t0 = time.perf_counter()
    try:
        s.conn.send(("sample", None))
        whole = s.conn.recv() if s.conn.poll(120) else {}
    except (OSError, EOFError):  # the drain has ended: no kept output to read
        whole = {}
    finally:
        fast._stop_drain(s)
        shutil.rmtree(s.tmp, ignore_errors=True)
    worst = 0
    for index in s.kept:
        if index not in whole:
            log(f"check: the kept output {index} did not come back")
            worst = 256
    with _pool() as pool:
        expected, decoded = _reference(s, pool, decode=sorted(whole.items()))
    for index, got in decoded.items():
        j = s.kept.get(index)
        if isinstance(got, Exception) or j is None or got.shape != s.images[j].shape:
            log(f"check: the reference cannot read output {index}: {got!r:.200}")
            worst = 256
            continue
        worst = max(worst, int(np.abs(got.astype(np.int16) - s.images[j]).max()))
    digests = {j: hashlib.sha256(data).hexdigest() for j, (data, _) in expected.items()}
    missing = max(0, s.sent - len(s.outputs))
    differing = [i for i, o in enumerate(s.outputs) if o.digest != digests[o.item]]
    if differing:
        log(f"check: {len(differing)} of {len(s.outputs)} outputs differ from the reference's, "
            f"first at command {differing[0]} (image {s.outputs[differing[0]].item})")
    kept = [t for _, t in expected.values()]
    log(f"check: the reference keeps green-delta on {kept.count(color.GDELTA)} of {len(kept)} "
        f"images; {time.perf_counter() - t0:.1f} s on {_workers()} workers")
    return [("failed", window.failed + missing, 0), ("outputs_differing", len(differing), 0),
            ("max_abs_error", worst, bound)]


def count(s, window) -> None:
    """Set each served pass's ``pixels`` and ``bytes``, every image of it
    whole, and where the program counts them, its ``transforms``, the
    transforms kept by name, and its ``wins``, the plane races won by
    ``"layout.codec"``."""
    for k, (req, commands) in enumerate(zip(window.requests, s.passes)):
        if not req.ok:
            continue
        outs = [s.outputs[i] for i in commands if i < len(s.outputs)]
        req.info.update(pixels=sum(s.images[o.item].shape[0] * s.images[o.item].shape[1]
                                   for o in outs),
                        bytes=sum(o.marks[-1][1] if o.marks else 0 for o in outs))
        if k in s.transforms:
            req.info["transforms"] = s.transforms[k]
        if k in s.wins:
            req.info["wins"] = {f"{layout}.{codec}": n for (layout, codec), n in s.wins[k].items()}


def work(s, req) -> dict:
    from .. import roofline

    lossless = s.cfg["codec"]["preset"] == "lossless"
    planes = 6 if lossless else 3  # three a transform, two transforms racing where lossless
    return {"K1": sum(roofline.k1_work(planes, im.shape[0] * im.shape[1], not lossless)
                      for im in s.images)}
