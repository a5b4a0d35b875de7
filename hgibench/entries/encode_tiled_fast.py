"""A ground station's scene: the command users run,
``encode-tiled -i scene.tif -o out.thgit --tile T --format thgi --fast``,
called in process through ``rustyhgi_tpu_torch.cli.main``.

Set-up makes the pool's seeded scenes on the card and writes each once as
an uncompressed TIFF under ``TMPDIR``.  The output path is a FIFO there:
a process of the harness (``hgibench/drain.py``) drains it into a SHA-256
and a byte count, with the host time of each read, so the command's own
loop, framing, CRCs and flushes run and no scene reaches the disk.  The
first output of each scene in the window is also kept whole.  Set-up then codes every scene once.  The
check builds the reference's ``.thgit`` of each scene (in worker
processes, by chunks of tiles) and compares every output's digest with
it; it decodes a sample of the kept outputs' tiles, drawn from the seed,
with the reference decoder against the source tiles.
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
from ..planes import natural_planes
from ..reference import formats, hgi

__all__ = ["setup", "request", "timers", "counters", "finish", "release", "check", "count",
           "work", "control"]

CHUNK = 32  # tiles a write_fast_batch call of the command
SAMPLED_TILES = 6  # tiles of each kept output the check decodes
POKE_S = 1.0  # how long a failed request tries to release the drain's open


class State:
    pass


class _Output:
    def __init__(self, item, digest, marks):
        self.item, self.digest, self.marks = item, digest, marks


def setup(cfg: dict, mix: dict, seed: int, device: str, log=print) -> State:
    import torch
    from PIL import Image
    from rustyhgi_tpu_torch import cli

    c = cfg["codec"]
    s = State()
    s.cfg, s.device, s.cli = cfg, device, cli
    s.shape = (int(c["height"]), int(c["width"]))
    s.tile = int(c["tile"])
    s.tmp = tempfile.mkdtemp(prefix="hgibench-scene-")
    s.scenes, s.paths = [], []
    for k in range(int(mix["pool"])):
        scene = natural_planes(seed + k, 1, *s.shape, float(cfg["noise"]), device)[0].cpu().numpy()
        s.scenes.append(scene)
        s.paths.append(os.path.join(s.tmp, f"scene{k}.tif"))
        Image.fromarray(scene).save(s.paths[-1])
    s.fifo = os.path.join(s.tmp, "out.thgit")
    os.mkfifo(s.fifo)
    s.outputs, s.items, s.kept_items, s.kept_index, s.sent = [], [], set(), [], 0
    s.control = None
    spawn = multiprocessing.get_context("spawn")
    s.conn, child = spawn.Pipe()
    s.drain = spawn.Process(target=drain.serve, args=(s.fifo, child), name="hgibench-drain",
                            daemon=True)
    s.drain.start()
    child.close()
    for item in range(len(s.paths)):
        request(s, item)
    if device != "cpu":
        torch.cuda.synchronize()
    _wait_outputs(s, len(s.paths))
    s.conn.send(("sample", []))  # set-up's outputs are not checked
    s.conn.recv()
    s.outputs.clear()
    s.items.clear()
    s.kept_items.clear()
    s.kept_index.clear()
    s.sent = 0
    return s


def _argv(s: State, item: int) -> list:
    c = s.cfg["codec"]
    return ["encode-tiled", "-i", s.paths[item], "-o", s.fifo, "--tile", str(s.tile),
            "--format", "thgi", "--fast", "--level", str(c["levels"]),
            "--quantizator", c["preset"], "--predictor", c["predictor"], "--device", s.device]


def request(s: State, item: int) -> int:
    # The drain must have closed the last output before a writer opens the
    # FIFO again, or the two outputs would run together.
    _wait_outputs(s, s.sent)
    if not s.drain.is_alive():  # no reader would ever open the FIFO
        raise RuntimeError("the FIFO's drain has ended")
    keep = item not in s.kept_items
    s.kept_items.add(item)
    if keep:
        s.kept_index.append(s.sent)
    s.conn.send((s.sent, keep))
    s.items.append(item)
    s.sent += 1
    try:
        if s.control is not None:
            with open(s.fifo, "wb") as f:
                f.write(s.control[item])
            return item
        rc = s.cli.main(_argv(s, item))
    except BaseException:
        _poke(s)
        raise
    if rc != 0:
        raise RuntimeError(f"encode-tiled exited with {rc}")
    return item


def timers(s: State) -> dict:
    from rustyhgi_tpu_torch import cli
    from rustyhgi_tpu_torch.models import codec
    from rustyhgi_tpu_torch.ops import tpurans
    from rustyhgi_tpu_torch.parallel import sharded

    return {
        "encode_tiled": [(cli, "cmd_encode_tiled")],
        "load": [(cli, "load_luma")],
        "tile_plane": [(sharded, "tile_plane")],
        "write_fast_batch": [(codec.HGICodec, "write_fast_batch")],
        "fetch": [(tpurans, "fetch_heads"), (tpurans, "fetch_words")],
        "framing": [(tpurans, "frame_payloads"), (codec, "frame_rans_tpu")],
    }


def counters() -> dict:
    from rustyhgi_tpu_torch.ops import cuda_codec, tpurans

    return {"K1": (cuda_codec, "encode_launches"), "X1": (tpurans, "rans_launches")}


def _wait_outputs(s: State, count: int, timeout: float = 120.0) -> None:
    """Take the drain's answers until ``count`` outputs have ended, or
    ``timeout`` seconds pass with none."""
    try:
        while len(s.outputs) < count and s.conn.poll(timeout):
            index, digest, marks = s.conn.recv()
            s.outputs.append(_Output(s.items[index], digest, marks))
    except (OSError, EOFError):  # the drain has ended: what is missing counts as failed
        pass


def _poke(s: State) -> None:
    """Open and close the FIFO's writing end, so that a drain waiting for
    a writer that never came reads an empty output."""
    end = time.perf_counter() + POKE_S
    while time.perf_counter() < end:
        try:  # meets the drain in its open; ENXIO while it is elsewhere
            os.close(os.open(s.fifo, os.O_WRONLY | os.O_NONBLOCK))
            return
        except OSError:
            time.sleep(0.01)


def _stop_drain(s: State) -> None:
    if s.drain.is_alive():
        try:
            s.conn.send(None)
        except OSError:
            pass
        s.drain.join(10)
    if s.drain.is_alive():
        s.drain.terminate()
        s.drain.join(10)
    s.conn.close()


def finish(s: State, window) -> None:
    """Collect the outputs of the window's requests; the drain keeps those
    kept whole until the check."""
    _wait_outputs(s, len(window.requests))


def release(s: State) -> None:
    s.cli = None


def control(s: State) -> None:
    """The reference writer in the program's place, quantizing with the
    next coarser preset's error under the configuration's header (10 for
    lossless): it breaks the stated error bound."""
    c = s.cfg["codec"]
    coarser = {0: 10, 10: 20, 20: 30, 30: 40}[hgi.ERRORS[c["preset"]]]
    s.control = [_reference(s, k, coarser)[0] for k in range(len(s.scenes))]


def _tiles_job(args):
    tiles, levels, preset, predictor, error = args
    return formats.write_fast(tiles, levels, preset, predictor, error)


def _reference(s: State, k: int, error=None):
    """The reference's ``.thgit`` of scene ``k``, its frames' ends and its
    blocks' lengths, the tiles coded by chunks in worker processes."""
    c = s.cfg["codec"]
    tiles = formats.tile_plane(s.scenes[k], s.tile)
    jobs = [(tiles[lo : lo + CHUNK], int(c["levels"]), c["preset"], c["predictor"], error)
            for lo in range(0, len(tiles), CHUNK)]
    workers = max(1, min(4, (os.cpu_count() or 2) // 2))
    with ProcessPoolExecutor(workers, mp_context=multiprocessing.get_context("spawn")) as pool:
        blocks = [b for chunk in pool.map(_tiles_job, jobs) for b in chunk]
    data, ends = formats.thgit_frame(s.shape, s.tile, blocks)
    return data, ends, [len(b) for b in blocks]


def check(s: State, window, seed: int, log=print) -> list:
    c = s.cfg["codec"]
    bound = hgi.ERRORS[c["preset"]]
    s.expected = {}
    for k in range(len(s.scenes)):
        data, ends, lens = _reference(s, k)
        s.expected[k] = (hashlib.sha256(data).hexdigest(), ends, lens)
    outputs = s.outputs
    missing = max(0, len(window.requests) - len(outputs))
    differing = [i for i, (r, o) in enumerate(zip(window.requests, outputs))
                 if o.item != r.item or o.digest != s.expected[r.item][0]]
    if differing:
        log(f"check: {len(differing)} of {len(outputs)} outputs differ from the reference's, "
            f"first at request {differing[0]}")
    worst = 0
    pick = rng(seed, 4)
    n = len(s.expected[0][2])
    kept = sorted(s.kept_index)
    samples = [sorted(set(pick.choice(n, SAMPLED_TILES - 1, replace=False).tolist()) | {n - 1})
               for _ in kept]
    try:
        s.conn.send(("sample", samples))
        blocks = s.conn.recv() if s.conn.poll(120) else {}
    except (OSError, EOFError):  # the drain has ended: no sampled block to read
        blocks = {}
    finally:
        _stop_drain(s)
        shutil.rmtree(s.tmp, ignore_errors=True)
    for index, sample in zip(kept, samples):
        item = s.outputs[index].item if index < len(s.outputs) else None
        got = blocks.get(index)
        if item is None or not isinstance(got, list):
            log(f"check: the reference cannot read output {index}: {got}")
            worst = 256
            continue
        try:
            tiles = formats.tile_plane(s.scenes[item], s.tile)
            planes = formats.read_fast(got)
            worst = max(worst, int(np.abs(planes.astype(np.int16) - tiles[sample]).max()))
        except Exception as e:  # a malformed output fails the check, whatever it breaks
            log(f"check: the reference cannot read output {index} of scene {item}: {e!r}")
            worst = 256
    return [("failed", window.failed + missing, 0), ("outputs_differing", len(differing), 0),
            ("max_abs_error", worst, bound)]


def _frames_in_window(s: State, req, out: _Output, deadline: float):
    """``(frames, bytes)`` of the output that had reached the drain by the
    deadline (host clock)."""
    got = max([n for t, n in out.marks if t <= deadline], default=0)
    ends = s.expected[req.item][1]
    frames = int(np.searchsorted(np.asarray(ends), got, side="right"))
    head = ends[0] - 12 - s.expected[req.item][2][0]
    return frames, (ends[frames - 1] if frames else (head if got >= head else 0))


def count(s: State, window) -> None:
    """Set each request's ``pixels`` and ``bytes``: the source pixels and
    the archive bytes of its blocks written within the window."""
    deadline = window.t0 + window.seconds
    h, w = s.shape
    nw = -(-w // s.tile)
    for req, out in zip(window.requests, s.outputs):
        frames, nbytes = _frames_in_window(s, req, out, deadline)
        pixels = 0
        for i in range(frames):
            ty, tx = divmod(i, nw)
            pixels += (min(h, (ty + 1) * s.tile) - ty * s.tile) * (min(w, (tx + 1) * s.tile) - tx * s.tile)
        req.info.update(pixels=pixels, bytes=nbytes)


def work(s: State, req) -> dict:
    from .. import roofline

    lens = s.expected[req.item][2]
    n = s.tile * s.tile
    lossy = s.cfg["codec"]["preset"] != "lossless"
    k1 = x1 = 0.0
    for lo in range(0, len(lens), CHUNK):
        chunk = lens[lo : lo + CHUNK]
        k1 += roofline.k1_work(len(chunk), n, lossy)
        x1 += roofline.x1_work(len(chunk), n, sum(formats.coded_words(b, n) for b in chunk))
    return {"K1": k1, "X1": x1}
