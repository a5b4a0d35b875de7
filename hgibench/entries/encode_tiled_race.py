"""A ground station that keeps the smallest lossless archive: the command
users run, ``encode-tiled -i scene.tif -o out.thgit --tile T --format
thgi`` without ``--fast``, called in process through
``rustyhgi_tpu_torch.cli.main``.  The command codes the scene's tiles to
grids in one batch on the card, fetches them, and races the host coders
of ``.thgi`` on each tile.

Set-up makes the pool's seeded scenes (:mod:`..scenes`) on the card and
writes each once as an uncompressed TIFF under ``TMPDIR``, and warms up
through the same command on one small plane of 2 x 2 tiles, which loads
the kernels, the native coders and the coders' thread pools.  The output
goes to a FIFO drained by ``hgibench/drain.py``, as in the fast scene
cell (:mod:`.encode_tiled_fast`, whose helpers this module shares).  The
check builds the reference race's ``.thgit`` of each scene
(``reference/race.py``, the tiles coded in lockstep by chunks in worker
processes) and compares every output's digest with it; a sample of the
kept outputs' tiles, drawn from the seed, is decoded by the reference's
decoders against the source tiles, in a worker of its own meanwhile.

The program's count of races won by each (layout, codec),
``container.RACE_WINS``, is read around each request; a program without
it leaves the requests without wins.
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
from ..reference import formats, hgi, race
from . import encode_tiled_fast as fast

__all__ = ["setup", "request", "timers", "counters", "finish", "release", "check", "count",
           "work", "control"]

SAMPLED_TILES = fast.SAMPLED_TILES  # tiles of each kept output the check decodes
WARM_TILES = 2  # the warm-up plane is WARM_TILES x WARM_TILES tiles
finish, release = fast.finish, fast.release


def _wins():
    """The program's counter of races won, or None in a program without it."""
    from rustyhgi_tpu_torch.utils import container

    return getattr(container, "RACE_WINS", None)


def setup(cfg: dict, mix: dict, seed: int, device: str, log=print):
    import torch
    from PIL import Image
    from rustyhgi_tpu_torch import cli

    from ..scenes import race_scenes

    c, scene = cfg["codec"], cfg["scene"]
    s = fast.State()
    s.cfg, s.device, s.cli = cfg, device, cli
    s.shape = (int(c["height"]), int(c["width"]))
    s.tile = int(c["tile"])
    s.tmp = tempfile.mkdtemp(prefix="hgibench-race-")
    lo, hi = float(scene["sigma_lo"]), float(scene["sigma_hi"])
    s.scenes, s.paths = [], []
    for k in range(int(mix["pool"])):
        plane = race_scenes(seed + k, 1, *s.shape, lo, hi, device)[0].cpu().numpy()
        s.scenes.append(plane)
        s.paths.append(os.path.join(s.tmp, f"scene{k}.tif"))
        Image.fromarray(plane).save(s.paths[-1])
    warm = race_scenes(seed, 1, WARM_TILES * s.tile, WARM_TILES * s.tile, lo, hi, device)[0]
    warm_path = os.path.join(s.tmp, "warm.tif")
    Image.fromarray(warm.cpu().numpy()).save(warm_path)
    rc = cli.main(_argv(s, warm_path, os.path.join(s.tmp, "warm.thgit")))
    if rc != 0:
        raise RuntimeError(f"the warm-up's encode-tiled exited with {rc}")
    if device != "cpu":
        torch.cuda.synchronize()
    s.fifo = os.path.join(s.tmp, "out.thgit")
    os.mkfifo(s.fifo)
    s.outputs, s.items, s.kept_items, s.kept_index, s.sent = [], [], set(), [], 0
    s.control, s.wins = None, {}
    spawn = multiprocessing.get_context("spawn")
    s.conn, child = spawn.Pipe()
    s.drain = spawn.Process(target=drain.serve, args=(s.fifo, child), name="hgibench-drain",
                            daemon=True)
    s.drain.start()
    child.close()
    return s


def _argv(s, path: str, out: str) -> list:
    c = s.cfg["codec"]
    return ["encode-tiled", "-i", path, "-o", out, "--tile", str(s.tile), "--format", "thgi",
            "--level", str(c["levels"]), "--quantizator", c["preset"], "--predictor",
            c["predictor"], "--device", s.device]


def request(s, item: int) -> int:
    # The drain must have closed the last output before a writer opens the
    # FIFO again, or the two outputs would run together.
    fast._wait_outputs(s, s.sent)
    if not s.drain.is_alive():  # no reader would ever open the FIFO
        raise RuntimeError("the FIFO's drain has ended")
    keep = item not in s.kept_items
    s.kept_items.add(item)
    if keep:
        s.kept_index.append(s.sent)
    s.conn.send((s.sent, keep))
    s.items.append(item)
    index = s.sent
    s.sent += 1
    wins = _wins()
    try:
        if s.control is not None:
            with open(s.fifo, "wb") as f:
                f.write(s.control[item])
            return item
        if wins is not None:
            wins.clear()
        rc = s.cli.main(_argv(s, s.paths[item], s.fifo))
    except BaseException:
        fast._poke(s)
        raise
    if rc != 0:
        raise RuntimeError(f"encode-tiled exited with {rc}")
    if wins is not None:
        s.wins[index] = dict(wins)
    return item


def timers(s) -> dict:
    from rustyhgi_tpu_torch import cli
    from rustyhgi_tpu_torch.parallel import sharded

    return {
        "encode_tiled": [(cli, "cmd_encode_tiled")],
        "load": [(cli, "load_luma")],
        "tile_plane": [(sharded, "tile_plane")],
        "encode_batch": [(sharded, "encode_batch_sharded")],
    }


def counters() -> dict:
    from rustyhgi_tpu_torch.ops import cuda_codec

    return {"K1": (cuda_codec, "encode_launches")}


def _workers() -> int:
    return max(2, min(8, os.cpu_count() or 2))


def _race_job(args):
    tiles, levels, preset, predictor, error, tie = args
    return race.race_tiles(tiles, levels, preset, predictor, error, tie)


def _decode_job(blocks):
    return race.decode_tiles(blocks)


def _reference_jobs(s, items, error=None, tie="first"):
    """The reference race's jobs for the pool's scenes ``items``: all their
    tiles cut into one chunk a worker but one, coded in lockstep."""
    c = s.cfg["codec"]
    tiles = np.concatenate([formats.tile_plane(s.scenes[k], s.tile) for k in items])
    chunk = -(-len(tiles) // max(1, _workers() - 1))
    return [(tiles[lo : lo + chunk], int(c["levels"]), c["preset"], c["predictor"], error, tie)
            for lo in range(0, len(tiles), chunk)]


def _frame_scenes(s, items, results):
    """The reference's ``.thgit`` of each scene of ``items``, its frames'
    ends, its blocks' lengths and the wins, by scene, from the chunks'
    results in order."""
    blocks = [b for blobs, _ in results for b in blobs]
    wins = [w for _, ws in results for w in ws]
    n = len(blocks) // len(items)
    out = {}
    for j, k in enumerate(items):
        data, ends = formats.thgit_frame(s.shape, s.tile, blocks[j * n : (j + 1) * n])
        out[k] = (data, ends, [len(b) for b in blocks[j * n : (j + 1) * n]],
                  wins[j * n : (j + 1) * n])
    return out


def _pool():
    return ProcessPoolExecutor(_workers(), mp_context=multiprocessing.get_context("spawn"))


def control(s) -> None:
    """The reference race in the program's place with one of the
    configuration's guarantees broken (``config["control"]``): ``tie``
    (the default) gives a tie to the later candidate, so the archive is
    no longer the program's bytes; ``lossy`` quantizes with the next
    coarser preset's error under the configuration's header (10 for
    lossless), which breaks the stated error bound."""
    kind = s.cfg.get("control", "tie")
    error, tie = None, "first"
    if kind == "tie":
        tie = "last"
    elif kind == "lossy":
        error = {0: 10, 10: 20, 20: 30, 30: 40}[hgi.ERRORS[s.cfg["codec"]["preset"]]]
    else:
        raise ValueError(f"unknown control {kind!r}")
    items = range(len(s.scenes))
    with _pool() as pool:
        scenes = _frame_scenes(s, items,
                               list(pool.map(_race_job, _reference_jobs(s, items, error, tie))))
    s.control = [scenes[k][0] for k in items]


def check(s, window, seed: int, log=print) -> list:
    c = s.cfg["codec"]
    bound = hgi.ERRORS[c["preset"]]
    t0 = time.perf_counter()
    h, w = s.shape
    n = -(-h // s.tile) * -(-w // s.tile)
    pick = rng(seed, 4)
    kept = sorted(s.kept_index)
    served = sorted({r.item for r in window.requests})  # the reference codes only these
    samples = [sorted(set(pick.choice(n, SAMPLED_TILES - 1, replace=False).tolist()) | {n - 1})
               for _ in kept]
    try:
        s.conn.send(("sample", samples))
        blocks = s.conn.recv() if s.conn.poll(120) else {}
    except (OSError, EOFError):  # the drain has ended: no sampled block to read
        blocks = {}
    finally:
        fast._stop_drain(s)
        shutil.rmtree(s.tmp, ignore_errors=True)
    worst = 0
    readable = {}
    for index, sample in zip(kept, samples):
        item = s.outputs[index].item if index < len(s.outputs) else None
        got = blocks.get(index)
        if item is None or not isinstance(got, list):
            log(f"check: the reference cannot read output {index}: {got}")
            worst = 256
            continue
        readable[index] = (item, sample, got)
    with _pool() as pool:
        decoding = (pool.submit(_decode_job, [b for _, _, got in readable.values() for b in got])
                    if readable else None)
        scenes = (_frame_scenes(s, served, list(pool.map(_race_job, _reference_jobs(s, served))))
                  if served else {})
        try:
            planes = decoding.result() if decoding is not None else []
        except Exception as e:  # a malformed output fails the check, whatever it breaks
            log(f"check: the reference cannot read the sampled blocks: {e!r}")
            planes, worst = [], 256
    s.expected = {k: (hashlib.sha256(data).hexdigest(), ends, lens)
                  for k, (data, ends, lens, _) in scenes.items()}
    at = 0
    for item, sample, got in readable.values() if len(planes) else ():
        tiles = formats.tile_plane(s.scenes[item], s.tile)[sample]
        mine = planes[at : at + len(got)].astype(np.int16)
        worst = max(worst, int(np.abs(mine - tiles).max()))
        at += len(got)
    outputs = s.outputs
    missing = max(0, len(window.requests) - len(outputs))
    differing = [i for i, (r, o) in enumerate(zip(window.requests, outputs))
                 if o.item != r.item or o.digest != s.expected[r.item][0]]
    if differing:
        log(f"check: {len(differing)} of {len(outputs)} outputs differ from the reference's, "
            f"first at request {differing[0]}")
    for k, (*_, wins) in scenes.items():
        log(f"check: the reference race's wins in scene {k}: {race.tally(wins)}")
    log(f"check: {time.perf_counter() - t0:.1f} s on {_workers()} workers")
    return [("failed", window.failed + missing, 0), ("outputs_differing", len(differing), 0),
            ("max_abs_error", worst, bound)]


def count(s, window) -> None:
    """Set each request's ``pixels`` and ``bytes``, as in the fast scene
    cell, and where the program counts them, its ``wins``: the races won
    by ``"<layout tag>.<codec tag>"``."""
    fast.count(s, window)
    for req in window.requests:
        got = s.wins.get(req.index)
        if got is not None:
            req.info["wins"] = {f"{layout}.{codec}": k for (layout, codec), k in got.items()}


def work(s, req) -> dict:
    from .. import roofline

    n = len(s.expected[req.item][2])
    return {"K1": roofline.k1_work(n, s.tile * s.tile, s.cfg["codec"]["preset"] != "lossless")}
