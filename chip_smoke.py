#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

Run from the root of a checkout:

    python3 chip_smoke.py

It needs one CUDA card, ``nvcc`` and a C++ compiler for ``native/``; it
imports nothing of JAX.  Phases, each of which fails the run by raising:

1. build the kernels of ``rustyhgi_tpu_torch/csrc/`` with ``nvcc``, one
   compiler per source, all at once;
2. hold each kernel (K1-K5) against its plain PyTorch version on the
   card, bit for bit, over ragged shapes, depths 0-16, every preset, both
   predictors, every preview depth, the real sizes 1080x1920,
   8x1080x1920 and 2614x2368, and shapes of many of lossy K1's and K3's
   tiles with ragged edges (3x300x517, 2614x2368 and 1081x1921 at depths
   1-8, lossless and medium); the subband kernels also against K1, K3
   also with no recon wanted, K4 and K5 also on quads one byte into
   buffers of their own; then the fast
   mode's kernels (X1 device rANS, K6 bit-plane pack, K7 unpack, K6
   and K7 with and without compaction, the compacting ones also one
   byte into a buffer, K7 also on the body placed as codec 2's read
   places it) over stream sizes at the lanes' and blocks' edges,
   degenerate streams, streams whose blocks all keep 8 planes or none
   and whose planes start at an odd offset of the body, a constant
   plane with one odd byte (frequencies 1 and 16383, the reciprocal's
   extremes), the residual grids of 1x and 8x1080x1920,
   2614x2368 and 4096x4096 (the largest plane X1 takes) and a batch of
   32 planes; then K1, K2 and X1 at the color and tiled paths' shapes
   ([3, 1080, 1920], [32, 512, 512], [256, 512, 512]); then the op-rate
   probe's kernel (K8) over its five chains, k of 0 to 200 rounds,
   ragged shapes, an unaligned buffer and 8x1080x1920 at k = 200;
3. reproduce the JAX package's committed bytes with no JAX: the LENA
   plane recovered from its lossless golden, its grids and its ``.hgi``,
   ``.thgi`` and fast ``.thgi`` digests (the ``.thgi`` ones need the
   native coders), the decodes of the committed ``.thgi`` files, and the
   synthetic goldens;
4. drive the ``.hgi`` main path through its entry points (``HGICodec``
   with the container, then the CLI) at 1080x1920, and check that K1 and
   K2 were launched there;
5. drive the ``.thgi`` subband path the same way (``HGICodec``
   ``encode_subbands``, ``assemble_grid``, ``write_thgi``,
   ``read_thgi_subbands``, ``decode_subbands``, ``decode_preview``, then
   the CLI's ``--format thgi``, ``decode`` and ``decode --preview 2``),
   and check that K3, K4 and K5 were launched there;
6. drive the fast path the same way (``HGICodec.write_fast`` and
   ``write_fast_batch`` at 1x and 8x1080x1920, ``read_thgi``, ``decode``,
   ``write_thgi(codecs=["bitpack"], fast=True)``, the CLI's ``encode
   --fast``, and the host rule above 2**24 pixels), and check that each
   of those calls launched its kernels (K1 and X1 for each
   ``write_fast``, ``write_fast_batch`` and ``encode --fast``, K6, K7 and
   K2 for the others); codec 2's copies, printed beside its body's
   length, must be at most the body and 64 bytes to the host on write
   and the body to the card on read; the stages (K1, X1, the two copies to the host
   beside the payload bytes, the framing, and the host race of
   ``write_thgi`` on the same grid) are timed in calls of their own,
   before the counted run;
7. drive color through the CLI at 1080x1920 (a seeded scene in three
   correlated channels): ``encode --color --format thgi`` at lossless
   (two K1 calls, one a transform of the race) and medium (one), then
   ``decode`` (one K2 call for the three planes) and ``decode --preview
   2`` (K5 a plane), exact RGB at lossless and within 20 a channel at
   medium, the preview equal to the full decode sampled every 4; the
   ``.thgic`` bytes of a 256x384 crop equal to ``--device cpu``'s; the
   host-clock stages (load, device encode, the race, decode) printed;
8. drive the tiled tier through the CLI: ``encode-tiled --format thgi
   --fast --tile 512`` then ``decode-tiled`` on an 8192x8192 plane (256
   tiles, 8 calls of K1 and X1 on 32 tiles each, one K2 call on all),
   bit-exact at lossless and within 20 at medium; ``--format hgi`` and
   ``--shared-table`` at lossless on 2048x2048 (one K1 call each), each
   file cut halfway into a block and ``--resume``d back to the same
   bytes; a 1024x1024 plane at ``--tile 256`` with the same bytes on
   ``--device cuda`` and ``cpu``; no leg may print the encoder's retry;
9. drive the multi-process tiled tier with two ranks on the one card
   (``rustyhgi_tpu_torch.tools.multihost_run``: worker processes in a
   gloo group on 127.0.0.1, killed on a timeout), ``--tile 512``,
   ``thgi`` with the shared table, lossless and medium on 4096x4096,
   both planes in one launch: each rank's share, K1 and K2 calls, stage
   times and gathered bytes printed; the shares disjoint and covering,
   the ``.thgit`` the same on both ranks and equal to the one-process
   ``encode-tiled --shared-table`` file (and at lossless to a
   one-process ``encode_tiled_multihost``), the decode within the bound
   on both ranks;
10. export the K1/K2 programs (``export_encoder``/``export_decoder``)
   at 1080x1920 L4, lossless and medium, both predictors, and load them
   in a fresh process (this script with ``--export-worker DIR``), hold
   their outputs bit for bit against ``encode_plane``/``decode_plane``
   and their K1 and K2 calls at one each; that process also times its
   first ``encode_plane`` cold against one after ``compile((1080,
   1920))``;
11. run ``dryrun_multichip(4)`` on four places of the one card, and
   ``entry()``'s forward;
12. run the worked examples (``rustyhgi_tpu_torch.examples.serving``)
   on the card, every section's check true.
   Each of the phases 4-13 runs with the launch counts set to 0 just
   before it and read just after (the worker processes' calls added),
   and fails unless it launched its kernels.  In phases 9-12 every
   launch of K1-K5 and X1 in this process is recorded (the count must
   equal the launch counter's), and after them each distinct launch is
   made again on a copy of its inputs and held bit for bit against the
   plain version; the worker processes launch at phase 2's shapes;
13. hold the CLI's host backends against the kernels and the kernels
   against the oracle: LENA, recovered by ``decode --backend native`` of
   its lossless golden, encoded under ``--backend torch``, ``oracle``
   and ``native`` at lossless and medium to the manifest's ``.hgi``
   digests, the kernels' archive decoded to the manifest's plane under
   each, ``test -q lossless`` printing and writing the same under all
   three; ``test --backend native`` against ``--backend torch`` at
   1080x1920, lossless and medium (``--format thgi``: the same bytes,
   plane and printout, the host seconds of both side by side); then
   ``chip_probe.validate`` on the JAX probe's three small cases (517x1024
   L3 lossless, 300x500 L4 medium, 256x384 L5 high left_top): K1, K2, K3,
   K5, the plain version and the C++ stand-in against the oracle, every
   column OK (the stand-in's n/a for left_top, which it does not code).
   The host backends launch no kernel; the phase must launch K1, K2, K3
   and K5;
14. drive the bench tier through its entry points, each run with the
   launch counts set to 0 just before it and read just after: the probe
   ``python -m rustyhgi_tpu_torch.tools.chip_probe vpucal`` (K8; its
   rates, and the SASS instructions each chain issues a round), the
   CLI's ``bench --batch 8 --samples 3`` (K1, K2) and ``python -m
   rustyhgi_tpu_torch.bench --rounds 1`` (K1, K2, K3, K5, X1), whose rows
   are printed.  The bench runs its host-coder group (DEFLATE-9 included)
   on the whole batch: on an H100 the whole bench takes about 15 s, well
   short of doubling this script's time;
15. count with ``torch.profiler`` the device kernels one call launches
   (copies and memsets not counted): lossless K1 must be one launch at
   depths 4 and 8, lossy K1 one at depth 4, K2 and K5 one at depth 4 and
   for K5's preview at upto 2, and 1 + 8 - DECODE_FINE_LEVELS at depth 8;
   lossless K3 one at depths 4 and 8, lossy K3 one at depth 4 and
   1 + 8 - FINE_LEVELS at depth 8, with or without recon; K4 one; K1 and
   K2 one at the color and tiled paths' shapes, X1 three; and each
   kernel's count at 1x1080x1920 L4 medium, for its record.  Checked
   first of all, while the profiler's traces hold every record.

Nothing here times a kernel: ``python -m rustyhgi_tpu_torch.tools.chip_probe
times`` times each against its plain version and its bound, and
``chip_probe sweep`` times the kernels' tiles.

The last line is ``{"ok": true, "device": {...}}``; the line before it
holds the card's name and power limit, and the one before that the
kernels' JSON record.
"""

from __future__ import annotations

import contextlib
import hashlib
import inspect
import io
import json
import os
import shutil
import struct
import subprocess
import sys
import tempfile
import time
import zlib

import numpy as np
import torch

from rustyhgi_tpu_torch import HGICodec, bench, cli, dryrun
from rustyhgi_tpu_torch.examples import serving
from rustyhgi_tpu_torch.models.codec import load_exported
from rustyhgi_tpu_torch.ops import _build, bitpack, cuda_codec, native, pyramid, tpurans, vpucal
from rustyhgi_tpu_torch.ops.quantizers import (
    QuantizationLevel,
    linear_error,
    quantize_fn,
)
from rustyhgi_tpu_torch.utils import color, container
from rustyhgi_tpu_torch.utils.container import (
    Archive,
    read_archive,
    read_hgi,
    read_thgi,
    read_thgi_preview,
    read_thgi_subbands,
    write_archive,
    write_hgi,
    write_thgi,
)
from rustyhgi_tpu_torch.parallel import multihost
from rustyhgi_tpu_torch.tools import chip_probe, multihost_run
from rustyhgi_tpu_torch.utils import profiling
from rustyhgi_tpu_torch.utils.benchsuite import SUITE
from rustyhgi_tpu_torch.utils.imageio import load_luma, save_gray
from rustyhgi_tpu_torch.utils.profiling import stage_clock

DEVICE = "cuda"
ROOT = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(ROOT, "tests", "golden")
SEED = 20261016
LAYOUT_NAMES = {0: "rowmajor", 1: "subband"}
CODEC_NAMES = {tag: name for name, tag in container._CODEC_NAMES.items()}
LAUNCHES = {  # each kernel's launch counter
    "K1": (cuda_codec, "encode_launches"), "K2": (cuda_codec, "decode_launches"),
    "K3": (cuda_codec, "encode_subbands_launches"), "K4": (cuda_codec, "assemble_launches"),
    "K5": (cuda_codec, "decode_subbands_launches"),
    "K6": (bitpack, "pack_launches"), "K7": (bitpack, "unpack_launches"),
    "K8": (vpucal, "vpucal_launches"), "X1": (tpurans, "rans_launches"),
}
K8_ROUNDS = 200  # K8's largest k in its checks
BLOCK_BYTES = 8 * 128  # a bit-pack block's 8 planes


def _reset_launches() -> None:
    for module, attr in LAUNCHES.values():
        setattr(module, attr, 0)


def _read_launches() -> dict:
    return {k: getattr(module, attr) for k, (module, attr) in LAUNCHES.items()}


def _fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAIL: {msg}")


def _check(cond: bool, msg: str) -> None:
    if not cond:
        _fail(msg)


def _natural_plane(rng, shape) -> np.ndarray:
    """A smooth plane with mild noise, like a photograph more than noise."""
    *lead, h, w = shape
    y = np.linspace(0.0, 6.0, h)[:, None]
    x = np.linspace(0.0, 9.0, w)[None, :]
    base = 128 + 60 * np.sin(y) * np.cos(x) + 30 * np.sin(3 * x + y)
    noise = rng.normal(0.0, 6.0, (*lead, h, w))
    return np.clip(base + noise, 0, 255).astype(np.uint8)


def _table(preset, strategy="linear"):
    q = quantize_fn(preset, strategy)
    return None if q.identity else q.table


def _err(a: torch.Tensor, b: torch.Tensor) -> int:
    """Worst |a - b| of two integer tensors of the same shape, in int64."""
    if a.shape != b.shape:
        _fail(f"shapes differ: {tuple(a.shape)} vs {tuple(b.shape)}")
    return int((a.long() - b.long()).abs().max()) if a.numel() else 0


def _unaligned(t: torch.Tensor) -> torch.Tensor:
    """A copy of ``t`` one byte into a buffer of its own."""
    buf = torch.empty(1 + t.numel(), dtype=torch.uint8, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    return out


def compare_kernels(rng) -> dict:
    """Phase 2: kernel against plain version on the card; returns the
    worst |err| of each kernel."""
    cases = []
    for shape in [(37, 53), (1, 7), (7, 1), (3, 37, 53), (0, 0), (17, 29)]:
        for levels in (0, 1, 2, 4, 8, 16):
            for preset in QuantizationLevel:
                for pred in ("crossed", "left_top"):
                    cases.append((shape, levels, _table(preset), pred, preset))
    # The lossy template with the identity table (lut at lossless).
    cases.append(((37, 53), 4, _table(QuantizationLevel.LOSSLESS, "lut"), "crossed",
                  QuantizationLevel.LOSSLESS))
    for shape in [(1080, 1920), (8, 1080, 1920), (2614, 2368)]:
        for preset in (QuantizationLevel.LOSSLESS, QuantizationLevel.MEDIUM):
            for pred in ("crossed", "left_top"):
                cases.append((shape, 4, _table(preset), pred, preset))
    # Many of lossy K1's and K3's tiles, ragged at the right and bottom,
    # K3's cut on a canvas beyond the plane (1081x1921 pads to 1088x1936 at
    # L4, 1280x2048 at L8), at every split of the depth between coarse
    # launches and the tiled levels.
    for shape in [(3, 300, 517), (2614, 2368), (1081, 1921)]:
        for levels in range(1, 9):
            for preset in (QuantizationLevel.LOSSLESS, QuantizationLevel.MEDIUM):
                for pred in ("crossed", "left_top"):
                    cases.append((shape, levels, _table(preset), pred, preset))
    worst = dict.fromkeys(chip_probe.KERNELS, 0)
    previews = 0
    for shape, levels, table, pred, preset in cases:
        img = torch.from_numpy(rng.integers(0, 256, shape, dtype=np.uint8)).to(DEVICE)
        hw = img.shape[-2:]
        grid_k, recon_k = cuda_codec.encode_plane(img, levels, table, pred)
        grid_p, recon_p = pyramid.encode_plane(img, levels, table, pred)
        dec_k = cuda_codec.decode_plane(grid_k, levels, pred)
        dec_p = pyramid.decode_plane(grid_p, levels, pred)
        anchors, subbands, recon_sk = cuda_codec.encode_subbands(img, levels, table, pred)
        want_a, want_s, recon_sp = pyramid.encode_subbands(img, levels, table, pred)
        grid_sk = cuda_codec.assemble_grid(anchors, subbands, hw)
        grid_sp = pyramid.assemble_grid(anchors, subbands, hw)
        dec_sk = cuda_codec.decode_subbands(anchors, subbands, hw, levels, pred)
        dec_sp = pyramid.decode_subbands(anchors, subbands, hw, levels, pred)
        torch.cuda.synchronize()
        tag = f"shape={shape} levels={levels} preset={preset.name} pred={pred}"
        checks = [("K1", "grid", grid_k, grid_p), ("K1", "recon", recon_k, recon_p),
                  ("K2", "decode", dec_k, dec_p), ("K3", "anchors", anchors, want_a),
                  ("K3", "recon", recon_sk, recon_sp), ("K4", "grid", grid_sk, grid_sp),
                  ("K5", "decode", dec_sk, dec_sp)]
        checks += [("K3", f"level {lv} quad {k}", q, wq)
                   for lv, (qs, wqs) in enumerate(zip(subbands, want_s))
                   for k, (q, wq) in enumerate(zip(qs, wqs))]
        # K3 with no recon wanted, and K4 and K5 fed the quads one byte into
        # buffers of their own.
        nr_a, nr_s, nr_recon = cuda_codec.encode_subbands(img, levels, table, pred, False)
        _check(nr_recon is None, f"K3 returned a recon it was not asked for at {tag}")
        checks.append(("K3", "anchors, no recon", nr_a, want_a))
        checks += [("K3", f"level {lv} quad {k}, no recon", q, wq)
                   for lv, (qs, wqs) in enumerate(zip(nr_s, want_s))
                   for k, (q, wq) in enumerate(zip(qs, wqs))]
        moved_a = _unaligned(anchors)
        moved = [tuple(_unaligned(q) for q in qs) for qs in subbands]
        checks += [("K4", "grid, unaligned quads", cuda_codec.assemble_grid(moved_a, moved, hw),
                    grid_sp),
                   ("K5", "decode, unaligned quads",
                    cuda_codec.decode_subbands(moved_a, moved, hw, levels, pred), dec_sp)]
        for upto in range(len(subbands) + 1):
            prev_k = cuda_codec.decode_preview(anchors, subbands[:upto], hw, levels, upto, pred)
            prev_p = pyramid.decode_preview(anchors, subbands[:upto], hw, levels, upto, pred)
            checks.append(("K5", f"preview upto={upto}", prev_k, prev_p))
            previews += 1
        _check(len(subbands) == len(want_s), f"K3 level count differs at {tag}")
        for kernel, name, a, b in checks:
            err = _err(a, b)
            worst[kernel] = max(worst[kernel], err)
            _check(err == 0, f"{kernel} {name} differs from the plain version at {tag}")
        # The subband path against the grid path.
        _check(torch.equal(grid_sk, grid_k), f"K4(K3) != K1 grid at {tag}")
        _check(torch.equal(dec_sk, recon_k), f"K5(K3) != K1 recon at {tag}")
        _check(torch.equal(recon_sk, recon_k), f"K3 recon != K1 recon at {tag}")
        bound = linear_error(preset) if table is not None else 0
        if img.numel():
            err = int((dec_k.int() - img.int()).abs().max())
            _check(err <= bound, f"roundtrip error {err} > {bound} at {tag}")
            _check(torch.equal(dec_k, recon_k), f"decode != recon at {tag}")
    print(f"phase kernels-vs-plain: {len(cases)} cases ({previews} previews) bit-identical "
          f"(tolerance: exact), max_abs_err {worst}; K4(K3) == K1 grid and "
          f"K5(K3) == K1 recon in every case; K3 without recon, and K4 and K5 on quads "
          f"one byte off, in every case")
    return worst


def _rans_err(got, want) -> int:
    """Worst difference of X1's outputs from the plain version's: freq,
    counts, the states' u32 bits and the stored words' u16 bits."""
    total = int(got[1].sum())
    if int(want[1].sum()) != total:
        return abs(int(want[1].sum()) - total)
    return max(
        _err(got[0], want[0]), _err(got[1], want[1]),
        _err(got[2].long() & 0xFFFFFFFF, want[2].long() & 0xFFFFFFFF),
        _err(got[3][:total].long() & 0xFFFF, want[3][:total].long() & 0xFFFF),
    )


def compare_compacting(flat: torch.Tensor, name: str) -> tuple:
    """Phase 2: the compacting K6 and K7 against their plain versions, bit
    for bit: K6 on the stream and on a copy one byte in (the byte-wise
    loads), K7 on the body as K6 left it, placed as ``unpack_bytes``
    places it, and one byte into a buffer of its own.  Returns the worst
    |err| of K6 and of K7."""
    n = flat.numel()
    want = bitpack.pack_stream_plain(flat)
    err6 = 0
    for label, src in (("", flat), (" unaligned", _unaligned(flat))):
        body = bitpack.pack_stream(src)
        e = _err(body, want)
        err6 = max(err6, e)
        _check(e == 0, f"compacting K6{label} differs from the plain version on {name}")
    err7 = 0
    plain = bitpack.unpack_stream_plain(want, n)
    _check(torch.equal(plain, flat), f"unpack_stream_plain(pack_stream_plain) != input on {name}")
    for label, src in (("", body), (" placed", chip_probe.placed(body, n)),
                       (" unaligned", _unaligned(body))):
        e = _err(bitpack.unpack_stream(src, n), plain)
        err7 = max(err7, e)
        _check(e == 0, f"compacted K7{label} differs from the plain version on {name}")
    return err6, err7


def compare_fast_kernels(rng) -> dict:
    """Phase 2, fast mode: X1, K6 and K7 against their plain versions,
    bit for bit; returns the worst |err| of each."""
    cases = []
    for n in (1, 127, 128, 129, 511, 512, 513, 65536):
        cases.append((f"uniform n={n}", rng.integers(0, 256, (1, n), dtype=np.uint8)))
        cases.append((f"geometric n={n}", (rng.geometric(0.3, (1, n)) % 256).astype(np.uint8)))
    cases += [("zeros", np.zeros((1, 10000), np.uint8)),
              ("one symbol", np.full((1, 3000), 255, np.uint8)),
              ("two symbols", np.tile(np.array([0, 255], np.uint8), (1, 500))),
              ("all 256 symbols", np.tile(np.arange(256, dtype=np.uint8), (1, 4)))]
    # The compacting kernels' edges: every block keeping all 8 planes (128
    # folds to 255), and nb % 4 of 2 (6 blocks), where the body's planes
    # start at an odd offset, as at nb % 4 of 1 (one block, 1080x1920's
    # 2025 and 2614x2368's 6045).
    wide = (rng.geometric(0.3, (1, 9 * 1024 + 77)) % 256).astype(np.uint8)
    wide[0, ::1024] = 128
    cases += [("all 8 planes", wide),
              ("nb % 4 == 2", (rng.geometric(0.3, (1, 6000)) % 256).astype(np.uint8))]
    odd = np.zeros((1, 1080 * 1920), np.uint8)
    odd[0, 123457] = 77  # frequency 1 beside 16383: the reciprocal's extremes
    cases.append(("one odd byte 1080x1920", odd))
    for shape in [(1, 1080, 1920), (8, 1080, 1920), (1, 2614, 2368), (1, 4096, 4096)]:
        img = torch.from_numpy(_natural_plane(rng, shape)).to(DEVICE)
        for preset in (QuantizationLevel.LOSSLESS, QuantizationLevel.MEDIUM):
            grid = cuda_codec.encode_plane(img, 4, _table(preset))[0]
            cases.append((f"grid {'x'.join(map(str, shape))} {preset.name.lower()}",
                          grid.reshape(shape[0], -1)))
    img = torch.from_numpy(_natural_plane(rng, (32, 1080, 1920))).to(DEVICE)
    cases.append(("grid 32x1080x1920 medium",
                  cuda_codec.encode_plane(img, 4, _table(QuantizationLevel.MEDIUM))[0].reshape(32, -1)))
    worst = dict.fromkeys(("X1", "K6", "K7"), 0)
    shapes = {}
    for name, sym in cases:
        sym = torch.as_tensor(sym).to(DEVICE)
        b, n = sym.shape
        got = tpurans.encode_batch(sym)
        err = _rans_err(got, tpurans.encode_plain(sym))
        worst["X1"] = max(worst["X1"], err)
        _check(err == 0, f"X1 differs from the plain version on {name}")
        lanes = got[1].shape[1]
        _check(lanes == tpurans.lanes_for(n), f"X1 lane count {lanes} on {name}")
        shapes[name] = (lanes, -(-n // lanes))
        if name.startswith("one odd byte"):
            freqs = sorted(int(f) for f in got[0][0].cpu() if f)
            _check(freqs == [1, 16383], f"X1 table {freqs} on {name}")
        heads = tpurans.fetch_heads(*got[:3])
        payload = tpurans.frame_payloads(n, *heads, tpurans.fetch_words(got[3], heads[1]))[0]
        _check(np.array_equal(tpurans.decode_bytes(payload, n), sym[0].cpu().numpy()),
               f"X1 payload does not decode to its input on {name}")
        flat = sym.reshape(-1)
        packed, widths, nb = bitpack.pack_blocks(flat)
        want_p, want_w, want_nb = bitpack.pack_plain(flat)
        _check(nb == want_nb, f"K6 block count differs on {name}")
        err = max(_err(packed[:nb], want_p), _err(widths[:nb], want_w))
        worst["K6"] = max(worst["K6"], err)
        _check(err == 0, f"K6 differs from the plain version on {name}")
        expanded = chip_probe.expanded(packed, widths, nb, flat.numel())
        out = bitpack.unpack_blocks(expanded)
        err = _err(out, bitpack.unpack_plain(expanded))
        worst["K7"] = max(worst["K7"], err)
        _check(err == 0, f"K7 differs from the plain version on {name}")
        _check(torch.equal(out[: flat.numel()], flat), f"K7(K6) != input on {name}")
        err = compare_compacting(flat, name)
        worst["K6"], worst["K7"] = max(worst["K6"], err[0]), max(worst["K7"], err[1])
    torch.cuda.synchronize()
    too_big = torch.zeros(1, 4097 * 4096, dtype=torch.uint8, device=DEVICE)
    try:
        tpurans.encode_batch(too_big)
    except ValueError as e:
        _check("exceeds" in str(e), f"X1 above MAX_SYMBOLS raised {e}")
    else:
        _fail("X1 took a plane above MAX_SYMBOLS")
    real = {k: v for k, v in shapes.items() if k.startswith("grid")}
    print(f"phase fast-kernels-vs-plain: {len(cases)} streams, X1, K6 and K7 bit-identical "
          f"(tolerance: exact; K6 and K7 with and without compaction, compacting K6 also "
          f"one byte in, compacted K7 also placed and one byte in), max_abs_err {worst}; "
          f"every payload decodes to its input; "
          f"(lanes L, rows T) {real}; frequencies 1 and 16383 in one table; 4097x4096 "
          f"refused by X1")
    return worst


def compare_path_shapes(rng) -> dict:
    """Phase 2, the color and tiled paths' shapes: K1 and K2 on [3, 1080,
    1920], K1, K2 and X1 on [32, 512, 512] (also a multihost rank's share,
    phase 9) and K2 on [256, 512, 512], both predictors for K1 and K2,
    against their plain versions, bit for bit; returns the worst |err| of
    each."""
    worst = dict.fromkeys(("K1", "K2", "X1"), 0)
    cases = 0
    for shape in [(3, 1080, 1920), (32, 512, 512), (256, 512, 512)]:
        img = torch.from_numpy(_natural_plane(rng, shape)).to(DEVICE)
        for preset in (QuantizationLevel.LOSSLESS, QuantizationLevel.MEDIUM):
            table = _table(preset)
            for pred in ("crossed", "left_top"):
                grid, recon = cuda_codec.encode_plane(img, 4, table, pred)
                want_grid, want_recon = pyramid.encode_plane(img, 4, table, pred)
                err = max(_err(grid, want_grid), _err(recon, want_recon))
                worst["K1"] = max(worst["K1"], err)
                _check(err == 0, f"K1 differs from the plain version on {shape} {pred}")
                err = _err(cuda_codec.decode_plane(grid, 4, pred),
                           pyramid.decode_plane(grid, 4, pred))
                worst["K2"] = max(worst["K2"], err)
                _check(err == 0, f"K2 differs from the plain version on {shape} {pred}")
                cases += 1
            if shape[0] == 32:
                sym = grid.reshape(32, -1)
                err = _rans_err(tpurans.encode_batch(sym), tpurans.encode_plain(sym))
                worst["X1"] = max(worst["X1"], err)
                _check(err == 0, f"X1 differs from the plain version on {shape}")
    print(f"phase path-shapes-vs-plain: K1 and K2 on {cases} cases of [3,1080,1920], "
          f"[32,512,512] and [256,512,512], X1 on [32,512,512] lossless and medium, "
          f"bit-identical (tolerance: exact), max_abs_err {worst}")
    return worst


# The wrapper that launches each kernel of phases 9-12 in this process, once
# a call, with its plain version and the arguments that version takes.
# Every other wrapper of a kernel reaches this one through its module, so
# that replacing the module's name sees each launch.
LAUNCHERS = {
    "K1": (cuda_codec, "encode_plane_tiled", pyramid.encode_plane,
           ("image", "levels", "table", "predictor")),
    "K2": (cuda_codec, "decode_plane_tiled", pyramid.decode_plane,
           ("grid", "levels", "predictor")),
    "K3": (cuda_codec, "encode_subbands_tiled", pyramid.encode_subbands,
           ("image", "levels", "table", "predictor", "want_recon")),
    "K4": (cuda_codec, "assemble_grid", pyramid.assemble_grid, ("anchors", "subbands", "shape")),
    "K5": (cuda_codec, "decode_preview_tiled", pyramid.decode_preview,
           ("anchors", "subbands", "shape", "levels", "upto", "predictor")),
    "X1": (tpurans, "encode_batch", tpurans.encode_plain, ("sym",)),
}


def _call_key(x):
    """What tells two launches' arguments apart: shapes, a quantization
    table by its values, everything else by value."""
    if isinstance(x, torch.Tensor):
        if x.dim() == 1 and x.numel() == 256:
            return ("table", x.cpu().numpy().tobytes())
        return ("tensor", tuple(x.shape), str(x.dtype))
    if isinstance(x, (list, tuple)):
        return tuple(_call_key(y) for y in x)
    return x


def _copied(x):
    if isinstance(x, torch.Tensor):
        return x.clone()
    if isinstance(x, (list, tuple)):
        return type(x)(_copied(y) for y in x)
    return x


def _output_pairs(kernel: str, got, want, tag: str) -> list:
    """(the kernel's tensor, the plain version's) of each output of a
    launch of K1-K5; K3's recon only where the kernel returned one."""
    if kernel == "K1":
        return list(zip(got, want))
    if kernel == "K3":
        _check(len(got[1]) == len(want[1]), f"{tag}: K3 level count differs")
        pairs = [(got[0], want[0])] + [(q, wq) for qs, wqs in zip(got[1], want[1])
                                       for q, wq in zip(qs, wqs)]
        return pairs + ([(got[2], want[2])] if got[2] is not None else [])
    return [(got, want)]


class _Recorder:
    """Within ``with``, every launch of K1-K5 and X1 in this process is
    counted, and the first launch of each distinct set of arguments keeps
    a copy of its inputs, so that :meth:`replay` can hold the kernel
    against its plain version at every shape the phases gave it."""

    def __init__(self):
        self.calls, self.seen, self.active = {}, dict.fromkeys(LAUNCHERS, 0), False
        self.launchers = {k: getattr(module, name) for k, (module, name, _, _) in
                          LAUNCHERS.items()}
        for kernel, (module, name, _, _) in LAUNCHERS.items():
            setattr(module, name, self._wrapped(kernel, self.launchers[kernel]))

    def _wrapped(self, kernel, launcher):
        def launch(*args, **kwargs):
            if not self.active:
                return launcher(*args, **kwargs)
            key = (kernel, _call_key((args, tuple(sorted(kwargs.items())))))
            copy = None if key in self.calls else _copied((args, kwargs))
            before = _read_launches()[kernel]
            out = launcher(*args, **kwargs)
            if _read_launches()[kernel] > before:
                self.seen[kernel] += 1
                if copy is not None:
                    self.calls[key] = copy
            return out
        return launch

    def __enter__(self):
        self.active = True
        return self

    def __exit__(self, *exc):
        self.active = False

    def close(self) -> None:
        for kernel, (module, name, _, _) in LAUNCHERS.items():
            setattr(module, name, self.launchers[kernel])

    def replay(self) -> tuple:
        """Each recorded launch again, against the plain version on the
        same inputs, bit for bit; returns (worst |err| of each kernel,
        {kernel: sorted shapes})."""
        worst = dict.fromkeys(LAUNCHERS, 0)
        shapes = {k: set() for k in LAUNCHERS}
        for (kernel, _), (args, kwargs) in self.calls.items():
            _, _, plain, names = LAUNCHERS[kernel]
            launcher = self.launchers[kernel]
            bound = inspect.signature(launcher).bind(*args, **kwargs)
            bound.apply_defaults()
            a = bound.arguments
            got, want = launcher(*args, **kwargs), plain(*(a[n] for n in names))
            first = a[names[0]]
            tag = " ".join([kernel, str(list(first.shape))] + [
                f"{n}={a[n]}" for n in names[1:] if isinstance(a[n], (int, str))])
            if kernel == "X1":
                err = _rans_err(got, want)
            else:
                err = max(_err(g, w) for g, w in _output_pairs(kernel, got, want, tag))
            worst[kernel] = max(worst[kernel], err)
            _check(err == 0, f"{tag} differs from the plain version")
            shapes[kernel].add(" ".join([str(list(first.shape))] + (
                [f"of {tuple(a['shape'])}"] if "shape" in a else []) + (
                [f"L{a['levels']}"] if "levels" in a else [])))
        torch.cuda.synchronize()
        return worst, {k: sorted(v) for k, v in shapes.items() if v}


def compare_probe(rng) -> int:
    """Phase 2, the probe: K8 against its plain version, bit for bit, over
    the five chains; returns the worst |err|."""
    images = [torch.from_numpy(rng.integers(0, 256, shape, dtype=np.uint8)).to(DEVICE)
              for shape in [(1, 37, 53), (3, 7, 1), (2, 1, 7), (1, 17, 29), (2, 40, 64),
                            (1, 5, 6), (1, 1080, 1920)]]
    cases = [(img, kind, k) for img in images for kind in vpucal.KINDS
             for k in (0, 1, 2, 7, 40, K8_ROUNDS)]
    # W % 4 == 0 on a buffer one byte off its start: the byte-wise path.
    buf = torch.from_numpy(rng.integers(0, 256, 1 + 3 * 16 * 64, dtype=np.uint8)).to(DEVICE)
    cases += [(buf[1:].view(3, 16, 64), kind, k) for kind in vpucal.KINDS for k in (1, 40)]
    big = torch.from_numpy(rng.integers(0, 256, (8, 1080, 1920), dtype=np.uint8)).to(DEVICE)
    cases += [(big, kind, K8_ROUNDS) for kind in vpucal.KINDS]
    worst = 0
    for img, kind, k in cases:
        err = _err(vpucal.vpucal_chain(img, kind, k), vpucal.vpucal_plain(img, kind, k))
        worst = max(worst, err)
        _check(err == 0, f"K8 {kind} k={k} differs from the plain version at "
                         f"{tuple(img.shape)}")
    torch.cuda.synchronize()
    print(f"phase probe-vs-plain: {len(cases)} cases, K8 bit-identical (tolerance: exact), "
          f"max_abs_err {worst}; kinds {list(vpucal.KINDS)}, k 0-{K8_ROUNDS}, ragged and "
          f"unaligned shapes, 8x1080x1920 at k={K8_ROUNDS}")
    return worst


def _sha(b: bytes) -> str:
    return hashlib.sha256(b).hexdigest()


def reproduce_goldens() -> None:
    """Phase 3: the JAX package's committed bytes, with no JAX."""
    with open(os.path.join(GOLDEN, "baseline", "manifest.json")) as f:
        manifest = json.load(f)
    print(f"zlib runtime {zlib.ZLIB_RUNTIME_VERSION}")
    with open(os.path.join(GOLDEN, "baseline", "lena_l4_lossless.hgi"), "rb") as f:
        archive = read_hgi(f.read())
    lena = HGICodec(4, "lossless", device=DEVICE).decode(archive)
    want = manifest["lena_l4_lossless"]["input_sha256"]
    _check(_sha(lena.tobytes()) == want, "recovered LENA plane has the wrong digest")
    for preset in ("lossless", "medium"):
        entry = manifest[f"lena_l4_{preset}"]
        with open(os.path.join(GOLDEN, "baseline", f"lena_l4_{preset}.hgi"), "rb") as f:
            golden = read_hgi(f.read())
        codec = HGICodec(4, preset, device=DEVICE)
        ours = codec.encode(lena)
        _check(np.array_equal(ours.grid, golden.grid),
               f"kernel LENA {preset} grid differs from the golden")
        blob = write_hgi(ours)
        _check(_sha(blob) == entry["hgi_sha256"],
               f"LENA {preset} .hgi digest {_sha(blob)[:8]} != manifest "
               f"{entry['hgi_sha256'][:8]} with the grid equal: zlib "
               f"{zlib.ZLIB_RUNTIME_VERSION} writes other DEFLATE bytes")
        decoded = codec.decode(read_hgi(blob))
        _check(_sha(decoded.tobytes()) == entry["decoded_sha256"],
               f"LENA {preset} decode digest differs from the manifest")
    stem = os.path.join(GOLDEN, "synthetic_16x12_l3_medium")
    want_grid = np.load(stem + "_grid.npy")
    with open(stem + ".hgi", "rb") as f:
        blob = f.read()
    archive = read_hgi(blob)
    _check(np.array_equal(archive.grid, want_grid), "synthetic golden grid differs")
    x = np.arange(16, dtype=np.int64)
    y = np.arange(12, dtype=np.int64)
    synthetic = ((y[:, None] * x[None, :]) & 0xFF).astype(np.uint8)
    ours = HGICodec(3, "medium", device=DEVICE).encode(synthetic)
    _check(np.array_equal(ours.grid, want_grid), "kernel synthetic grid differs")
    _check(write_hgi(archive) == blob, "synthetic .hgi bytes differ")
    with open(stem + ".thgi", "rb") as f:
        _check(np.array_equal(read_archive(f.read()).grid, want_grid),
               "synthetic .thgi golden reads another grid")
    print("phase goldens: LENA plane, grids and .hgi digests (lossless, medium) "
          "and the synthetic golden reproduced")
    reproduce_thgi_goldens(manifest, lena)


def reproduce_thgi_goldens(manifest: dict, lena: np.ndarray) -> None:
    """Phase 3, ``.thgi``: the bytes need the native coders (without them
    the ctx candidate drops out of the race)."""
    _check(native.available(), "the native coders (native/librustyhgi.so) are not available")
    for preset in ("lossless", "medium"):
        entry = manifest[f"lena_l4_{preset}"]
        with open(os.path.join(GOLDEN, "baseline", f"lena_l4_{preset}.thgi"), "rb") as f:
            golden = f.read()
        codec = HGICodec(4, preset, device=DEVICE)
        blob = write_archive(codec.encode(lena), "thgi")
        _check(_sha(blob) == entry["thgi_sha256"],
               f"LENA {preset} .thgi digest {_sha(blob)[:8]} != manifest "
               f"{entry['thgi_sha256'][:8]}")
        anchors, subbands, _ = codec.encode_subbands(lena)
        grid = codec.assemble_grid(anchors, subbands, lena.shape).cpu().numpy()
        _check(write_thgi(Archive(codec.metadata_for(*lena.shape), grid)) == golden,
               f"LENA {preset} .thgi from the subband kernels differs from the golden")
        meta, anchors, subbands = read_thgi_subbands(golden)
        direct = codec.decode_subbands(anchors, subbands, (meta.height, meta.width))
        _check(_sha(direct.cpu().numpy().tobytes()) == entry["decoded_sha256"],
               f"LENA {preset} .thgi subband decode digest differs from the manifest")
        via_grid = codec.decode(read_archive(golden))
        _check(_sha(via_grid.tobytes()) == entry["decoded_sha256"],
               f"LENA {preset} .thgi grid decode digest differs from the manifest")
        print(f"LENA {preset}: .thgi sha256 {_sha(blob)} ({len(blob)} bytes, layout "
              f"{blob[28]} codec {blob[29]}) == manifest; committed .thgi decodes to "
              f"{entry['decoded_sha256'][:8]}... by both paths")
    print("phase thgi-goldens: LENA .thgi digests (lossless, medium) reproduced with no "
          "JAX, committed .thgi files decoded")
    reproduce_fast_goldens(manifest, lena)


def reproduce_fast_goldens(manifest: dict, lena: np.ndarray) -> None:
    """Phase 3, fast mode: the LENA ``write_fast`` digests, K1 + X1."""
    for preset in ("lossless", "medium"):
        entry = manifest[f"lena_l4_{preset}"]
        codec = HGICodec(4, preset, device=DEVICE)
        blob = codec.write_fast(lena)
        _check(_sha(blob) == entry["fast_thgi_sha256"] and len(blob) == entry["fast_thgi_bytes"],
               f"LENA {preset} fast .thgi digest {_sha(blob)[:8]} ({len(blob)} bytes) != "
               f"manifest {entry['fast_thgi_sha256'][:8]} ({entry['fast_thgi_bytes']} bytes)")
        archive = read_thgi(blob, device=DEVICE)
        _check(np.array_equal(archive.grid, codec.encode(lena).grid),
               f"LENA {preset} fast .thgi reads another grid")
        _check(_sha(codec.decode(archive).tobytes()) == entry["decoded_sha256"],
               f"LENA {preset} fast .thgi decode digest differs from the manifest")
        print(f"LENA {preset}: fast .thgi sha256 {_sha(blob)} ({len(blob)} bytes) == manifest")
    print("phase fast-goldens: LENA write_fast digests (lossless, medium) reproduced with no JAX")


def main_path(rng) -> dict:
    """Phase 4: the .hgi main path through its entry points, 1080x1920."""
    image = _natural_plane(rng, (1080, 1920))
    stages = {}
    for preset in ("lossless", "medium"):
        codec = HGICodec(4, preset, device=DEVICE)
        t0 = time.perf_counter()
        archive = codec.encode(image)
        t1 = time.perf_counter()
        blob = write_archive(archive, "hgi")
        t2 = time.perf_counter()
        decoded = codec.decode(read_archive(blob))
        t3 = time.perf_counter()
        err = int(np.abs(decoded.astype(np.int64) - image).max())
        _check(err <= linear_error(codec.quantization),
               f"main path {preset}: max |err| {err}")
        stages[preset] = (t1 - t0, t2 - t1, t3 - t2, len(blob))
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            save_gray("plane.png", image)
            dev = ["--device", DEVICE]
            _check(cli.main(["encode", "-i", "plane.png", "-o", "p.hgi", "-q", "medium", *dev]) == 0,
                   "cli encode failed")
            _check(cli.main(["decode", "-i", "p.hgi", "-o", "p.png", *dev]) == 0,
                   "cli decode failed")
            err = int(np.abs(load_luma("p.png").astype(np.int64) - image).max())
            _check(err <= 20, f"cli roundtrip max |err| {err} > 20")
            out = io.StringIO()
            with contextlib.redirect_stdout(out):
                rc = cli.main(["test", "plane.png", "-l", "4", "-q", "lossless", *dev])
            _check(rc == 0, "cli test failed")
            _check("SD:           0.00" in out.getvalue(), "cli test lossless SD is not 0.00")
            print("cli test printout:\n" + out.getvalue().rstrip())
        finally:
            os.chdir(cwd)
    return stages


def subband_path(rng) -> dict:
    """Phase 5: the .thgi subband path through its entry points, 1080x1920."""
    image = _natural_plane(rng, (1080, 1920))
    hw = image.shape
    stages = {}
    for preset in ("lossless", "medium"):
        codec = HGICodec(4, preset, device=DEVICE)
        ms = {}
        t = [time.perf_counter()]

        def lap(name):
            t.append(time.perf_counter())
            ms[name] = (t[-1] - t[-2]) * 1e3

        anchors, subbands, recon = codec.encode_subbands(image)
        torch.cuda.synchronize()
        lap("encode_subbands (H2D, K3)")
        grid = codec.assemble_grid(anchors, subbands, hw).cpu().numpy()
        lap("assemble_grid (K4, D2H)")
        archive = Archive(codec.metadata_for(*hw), grid)
        blob = write_thgi(archive)
        lap("write_thgi (host race)")
        won = (LAYOUT_NAMES[blob[28]], CODEC_NAMES[blob[29]], len(blob))
        if won[0] != "subband":
            # The race picked the row-major layout, which the subband-direct
            # decode does not read: write the subband layout's winner too.
            blob = write_thgi(archive, layouts=("subband",))
            lap("write_thgi layouts=subband (host race)")
        meta, anchors_r, subbands_r = read_thgi_subbands(blob)
        lap("read_thgi_subbands (host decode)")
        decoded = codec.decode_subbands(anchors_r, subbands_r, (meta.height, meta.width))
        decoded = decoded.cpu().numpy()
        lap("decode_subbands (H2D, K5, D2H)")
        meta, anchors_p, subbands_p, upto = read_thgi_preview(blob, 2)
        preview = codec.decode_preview(anchors_p, subbands_p, hw, upto).cpu().numpy()
        lap("read_thgi_preview + decode_preview upto 2 (K5)")
        _check(np.array_equal(decoded, recon.cpu().numpy()),
               f"subband path {preset}: decode != encoder recon")
        err = int(np.abs(decoded.astype(np.int64) - image).max())
        _check(err <= linear_error(codec.quantization), f"subband path {preset}: max |err| {err}")
        _check(upto == 2 and np.array_equal(preview, decoded[::4, ::4]),
               f"subband path {preset}: preview != full decode sampled every 4")
        stages[preset] = {"ms": ms, "won": won,
                          "subband": (CODEC_NAMES[blob[29]], len(blob))}
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            save_gray("plane.png", image)
            dev = ["--device", DEVICE]
            _check(cli.main(["encode", "-i", "plane.png", "-o", "p.thgi", "-q", "medium",
                             "--format", "thgi", *dev]) == 0, "cli encode --format thgi failed")
            _check(cli.main(["decode", "-i", "p.thgi", "-o", "p.png", *dev]) == 0,
                   "cli decode of the .thgi failed")
            full = load_luma("p.png")
            err = int(np.abs(full.astype(np.int64) - image).max())
            _check(err <= 20, f"cli .thgi roundtrip max |err| {err} > 20")
            _check(cli.main(["decode", "-i", "p.thgi", "-o", "v.png", "--preview", "2",
                             *dev]) == 0, "cli decode --preview 2 failed")
            _check(np.array_equal(load_luma("v.png"), full[::4, ::4]),
                   "cli preview != full decode sampled every 4")
        finally:
            os.chdir(cwd)
    return stages


def _fast_stages(codec: HGICodec, images: np.ndarray) -> tuple:
    """``write_fast_batch`` taken apart stage by stage, each ended by a
    synchronize, on the host clock; returns the blobs, the grids (on the
    device), the stage times (ms) and the bytes each copy to the host
    moved."""
    ms = {}
    t = [time.perf_counter()]

    def lap(name):
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        ms[name] = (t[-1] - t[-2]) * 1e3

    b, h, w = images.shape
    imgs = torch.from_numpy(images).to(DEVICE)
    lap("H2D")
    grid, _ = codec.encode_plane(imgs)
    lap("K1")
    freq, counts, states, stream = tpurans.encode_batch(grid.reshape(b, h * w))
    lap("X1")
    heads = tpurans.fetch_heads(freq, counts, states)
    lap("fetch 1 (freq, counts, states)")
    words = tpurans.fetch_words(stream, heads[1])
    lap("fetch 2 (coded words)")
    blobs = container.frame_rans_tpu(codec.metadata_for(h, w),
                                      tpurans.frame_payloads(h * w, *heads, words))
    lap("framing")
    d2h = (4 * (freq.numel() + counts.numel() + states.numel()), 2 * words.size)
    return blobs, grid, ms, d2h


def fast_stages(rng) -> tuple:
    """Phase 6, first part: the stages of ``write_fast_batch`` at 1x and
    8x1080x1920, lossless and medium, called outside the fast path's
    counted run; returns the planes and each case's stages."""
    batch = _natural_plane(rng, (8, 1080, 1920))
    stages = {}
    for preset in ("lossless", "medium"):
        codec = HGICodec(4, preset, device=DEVICE)
        for b in (1, 8):
            stages[(preset, b)] = _fast_stages(codec, batch[:b])
    return batch, stages


def _rising(label: str, kernels, fn):
    """``fn()``, failing the run unless that one call launched each of
    ``kernels``."""
    before = _read_launches()
    out = fn()
    after = _read_launches()
    for kernel in kernels:
        _check(after[kernel] > before[kernel], f"{label} never launched {kernel}")
    return out


def fast_path(rng, batch: np.ndarray, stages: dict, card: str) -> None:
    """Phase 6: the fast path through its entry points at 1x and
    8x1080x1920, each call checked to launch its kernels; every blob read
    back and decoded, and held against the stages of :func:`fast_stages`."""
    image = batch[0]
    for preset in ("lossless", "medium"):
        codec = HGICodec(4, preset, device=DEVICE)
        for images in (batch[:1], batch):
            b = images.shape[0]
            label = f"{b}x1080x1920 {preset}"
            blobs, grid, ms, (d1, d2) = stages[(preset, b)]
            t0 = time.perf_counter()
            api = _rising(f"write_fast(_batch) {label}", ("K1", "X1"),
                          lambda: [codec.write_fast(images[0])] if b == 1
                          else codec.write_fast_batch(images))
            end_to_end = (time.perf_counter() - t0) * 1e3
            _check(api == blobs, f"fast path {label}: write_fast(_batch) != its stages")
            grids = grid.cpu().numpy()
            recon = codec.encode_plane(images)[1].cpu().numpy()
            payload = sum(len(blob) for blob in blobs)
            for i, blob in enumerate(blobs):
                _check(blob[28] == 0 and CODEC_NAMES[blob[29]] == "rans_tpu",
                       f"fast path {label}: blob {i} is not row-major codec 7")
                archive = read_thgi(blob, device=DEVICE)
                _check(np.array_equal(archive.grid, grids[i]),
                       f"fast path {label}: blob {i} reads another grid")
                decoded = _rising(f"decode of {label} blob {i}", ("K2",),
                                  lambda: codec.decode(read_archive(blob, device=DEVICE)))
                _check(np.array_equal(decoded, recon[i]),
                       f"fast path {label}: blob {i} does not decode to the recon")
                if b > 1:
                    _check(blob == _rising(f"write_fast {label}[{i}]", ("K1", "X1"),
                                           lambda: codec.write_fast(images[i])),
                           f"fast path {label}: write_fast_batch[{i}] != write_fast")
            shown = ", ".join(f"{k} {v:.3f} ms" for k, v in ms.items())
            print(f"fast path {label}: {shown}; write_fast{'' if b == 1 else '_batch'} "
                  f"end to end {end_to_end:.3f} ms (host clock); copies to the host: fetch 1 "
                  f"{d1} B + fetch 2 {d2} B = {d1 + d2} B for {payload} B of payload "
                  f"({b} blob(s)) [{card}]")
        # The host race on the same grid, and codec 2 (K6 on write, K7 on read).
        archive = Archive(codec.metadata_for(*image.shape), grids[0])
        t0 = time.perf_counter()
        raced = write_thgi(archive)
        bitpack.h2d_bytes = bitpack.d2h_bytes = 0
        t1 = time.perf_counter()
        packed = _rising(f"write_thgi(bitpack, fast) {preset}", ("K6",),
                         lambda: write_thgi(archive, codecs=["bitpack"], fast=True, device=DEVICE))
        t2 = time.perf_counter()
        write_link = (bitpack.h2d_bytes, bitpack.d2h_bytes)
        bitpack.h2d_bytes = bitpack.d2h_bytes = 0
        back = _rising(f"read_thgi of codec 2 {preset}", ("K7",),
                       lambda: read_thgi(packed, device=DEVICE))
        t3 = time.perf_counter()
        read_link = (bitpack.h2d_bytes, bitpack.d2h_bytes)
        _check(CODEC_NAMES[packed[29]] == "bitpack" and np.array_equal(back.grid, grids[0]),
               f"fast path {preset}: codec 2 does not round-trip")
        _check(np.array_equal(codec.decode(back), recon[0]),
               f"fast path {preset}: codec 2 does not decode to the recon")
        body = container._parse_thgi_header(packed)[4]
        n, nb = image.size, -(-image.size // bitpack.BLOCK)
        _check(write_link == (n, write_link[1]) and write_link[1] <= len(body) + 64,
               f"fast path {preset}: codec 2's write copied {write_link} B for a body of "
               f"{len(body)} B")
        _check(read_link == (len(body), n),
               f"fast path {preset}: codec 2's read copied {read_link} B for a body of "
               f"{len(body)} B")
        print(f"fast path 1x1080x1920 {preset}: host race write_thgi {(t1 - t0) * 1e3:.3f} ms -> "
              f"layout {LAYOUT_NAMES[raced[28]]} codec {CODEC_NAMES[raced[29]]} {len(raced)} B; "
              f"write_fast {len(blobs[0])} B ({100 * (len(blobs[0]) / len(raced) - 1):+.1f}%); "
              f"codec 2 write_thgi(bitpack, fast) {(t2 - t1) * 1e3:.3f} ms {len(packed)} B, "
              f"read_thgi {(t3 - t2) * 1e3:.3f} ms (host clock); codec 2 body {len(body)} B: "
              f"write H2D {write_link[0]} B, D2H {write_link[1]} B; read H2D {read_link[0]} B, "
              f"D2H {read_link[1]} B (all 8 planes and the widths would be D2H "
              f"{BLOCK_BYTES * nb + 4 * nb} B on write, H2D {BLOCK_BYTES * nb} B on read) [{card}]")
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            save_gray("plane.png", image)
            dev = ["--device", DEVICE]
            for preset in ("lossless", "medium"):
                codec = HGICodec(4, preset, device=DEVICE)
                argv = ["encode", "-i", "plane.png", "-o", "f.thgi", "-q", preset,
                        "--format", "thgi", "--fast", *dev]
                _check(_rising(f"cli encode --fast -q {preset}", ("K1", "X1"),
                               lambda: cli.main(argv)) == 0,
                       f"cli encode --fast -q {preset} failed")
                with open("f.thgi", "rb") as f:
                    _check(f.read() == codec.write_fast(image),
                           f"cli encode --fast -q {preset} != write_fast")
                _check(_rising(f"cli decode of the fast -q {preset} .thgi", ("K2",),
                               lambda: cli.main(["decode", "-i", "f.thgi", "-o", "f.png", *dev]))
                       == 0, "cli decode of the fast .thgi failed")
                _check(np.array_equal(load_luma("f.png"), codec.encode_plane(image)[1].cpu().numpy()),
                       f"cli fast {preset} roundtrip != the encoder's recon")
        finally:
            os.chdir(cwd)
    # Above 2**24 pixels the fast path writes with the host coders.
    big = _natural_plane(rng, (4097, 4096))
    codec = HGICodec(4, "lossless", device=DEVICE)
    t0 = time.perf_counter()
    blob = codec.write_fast(big)
    took = (time.perf_counter() - t0) * 1e3
    _check(blob[28] == 0 and CODEC_NAMES[blob[29]] not in ("rans_tpu", "bitpack"),
           "write_fast above MAX_SYMBOLS did not take the host coders")
    _check(np.array_equal(read_thgi(blob, device=DEVICE).grid, codec.encode(big).grid),
           "write_fast above MAX_SYMBOLS reads another grid")
    print(f"fast path 4097x4096 lossless (above 2**24 pixels): host coders, codec "
          f"{CODEC_NAMES[blob[29]]}, {len(blob)} B in {took:.3f} ms (host clock) [{card}]")


def _cli(argv, want=None) -> tuple:
    """``cli.main(argv)`` with its standard error caught, failing the run
    on a nonzero exit or on the tiled encoder's retry; ``want`` ({kernel:
    n}) are the wrapper calls this one call must make.  Returns (host
    seconds, standard error)."""
    before = _read_launches()
    err = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stderr(err):
        rc = cli.main(argv)
    took = time.perf_counter() - t0
    after = _read_launches()
    label = " ".join(a for a in argv if a not in ("--device", DEVICE))
    _check(rc == 0, f"cli {label} exited {rc}: {err.getvalue().strip()}")
    _check("retrying" not in err.getvalue(), f"cli {label} retried: {err.getvalue().strip()}")
    for kernel, n in (want or {}).items():
        got = after[kernel] - before[kernel]
        _check(got == n, f"cli {label} launched {kernel} {got} times, not {n}")
    return took, err.getvalue()


def _rgb_scene(rng, shape) -> np.ndarray:
    """uint8 [H, W, 3]: one smooth scene in three channels with offsets
    and a little noise each, correlated as a photograph's are."""
    base = _natural_plane(rng, shape).astype(np.int16)
    planes = [base + off + rng.integers(-2, 3, shape) for off in (14, 0, -11)]
    return np.clip(np.stack(planes, 2), 0, 255).astype(np.uint8)


def color_path(rng, card: str) -> None:
    """Phase 7: color through the CLI at 1080x1920: ``encode --color
    --format thgi`` (K1 once a transform: two at lossless, one at medium),
    ``decode`` (K2 once for the three planes), ``decode --preview 2`` (K5 a
    plane); the stages on the host clock; the bytes of a 256x384 crop
    against ``--device cpu``."""
    rgb = _rgb_scene(rng, (1080, 1920))
    dev = ["--device", DEVICE]
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            color.save_rgb("rgb.png", rgb)
            color.save_rgb("crop.png", rgb[:256, :384])
            for preset, transforms in (("lossless", 2), ("medium", 1)):
                enc = ["encode", "-i", "rgb.png", "-o", "c.thgic", "--color", "--format", "thgi",
                       "-q", preset, *dev]
                with stage_clock({"load_rgb": (color, "load_rgb"),
                                   "encode_color": (color, "encode_color"),
                                   "race": (color, "write_archive")}) as enc_s:
                    enc_total, _ = _cli(enc, {"K1": transforms})
                with open("c.thgic", "rb") as f:
                    blob = f.read()
                with stage_clock({"decode_color": (color, "decode_color"),
                                   "read_archive": (color, "read_archive"),
                                   "save_rgb": (color, "save_rgb")}) as dec_s:
                    dec_total, _ = _cli(["decode", "-i", "c.thgic", "-o", "d.png", *dev],
                                        {"K2": 1, "K5": 0})
                with stage_clock({"decode_color_preview": (color, "decode_color_preview"),
                                   "read_preview": (color, "read_preview")}) as pre_s:
                    pre_total, _ = _cli(["decode", "-i", "c.thgic", "-o", "p.png",
                                         "--preview", "2", *dev], {"K2": 0, "K5": 3})
                full = color.load_rgb("d.png")
                err = int(np.abs(full.astype(np.int64) - rgb).max())
                _check(err <= linear_error(QuantizationLevel.parse(preset)),
                       f"color {preset}: max |err| {err} over a channel")
                _check(np.array_equal(color.load_rgb("p.png"), full[::4, ::4]),
                       f"color {preset}: --preview 2 != the full decode sampled every 4")
                cpu_s, _ = _cli(["encode", "-i", "crop.png", "-o", "cpu.thgic", "--color",
                                 "--format", "thgi", "-q", preset, "--device", "cpu"])
                _cli(["encode", "-i", "crop.png", "-o", "gpu.thgic", "--color", "--format", "thgi",
                      "-q", preset, *dev], {"K1": transforms})
                with open("cpu.thgic", "rb") as a, open("gpu.thgic", "rb") as b:
                    _check(a.read() == b.read(),
                           f"color {preset}: 256x384 .thgic bytes differ between cpu and cuda")
                device_part = enc_s["encode_color"] - enc_s["race"]
                print(
                    f"color 1080x1920x3 {preset}: max |err| {err} a channel; transform "
                    f"{'green-delta' if blob[5] else 'identity'}, {len(blob)} B; encode "
                    f"{enc_total:.3f} s = load_rgb {enc_s['load_rgb']:.3f} + encode_color "
                    f"{enc_s['encode_color']:.3f} (H2D, {transforms} K1, D2H {device_part:.3f}; "
                    f"the race, {3 * transforms} write_thgi, {enc_s['race']:.3f}); decode "
                    f"{dec_total:.3f} s = decode_color {dec_s['decode_color']:.3f} (host "
                    f"read_archive {dec_s['read_archive']:.3f}; H2D, K2, D2H "
                    f"{dec_s['decode_color'] - dec_s['read_archive']:.3f}) + save_rgb "
                    f"{dec_s['save_rgb']:.3f}; preview 2 {pre_total:.3f} s = "
                    f"decode_color_preview {pre_s['decode_color_preview']:.3f} (host "
                    f"read_preview {pre_s['read_preview']:.3f}); 256x384 bytes equal to "
                    f"--device cpu's ({cpu_s:.3f} s there) (host clock, s) [{card}]")
        finally:
            os.chdir(cwd)


def tiled_path(rng, card: str) -> None:
    """Phase 8: the tiled tier through the CLI: ``encode-tiled --fast``
    and ``decode-tiled`` on an 8192x8192 plane at ``--tile 512`` (256
    tiles, 8 chunks of 32: K1 and X1 eight times, K2 once), the host
    coders' legs on 2048x2048 (``--format hgi``, ``--shared-table``), a
    ``--resume`` of a file cut mid-block, and the bytes of a 1024x1024
    plane at ``--tile 256`` against ``--device cpu``.  No leg may retry."""
    dev = ["--device", DEVICE]
    big = _natural_plane(rng, (8192, 8192))
    mid = _natural_plane(rng, (2048, 2048))
    small = _natural_plane(rng, (1024, 1024))
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            save_gray("big.tif", big)  # uncompressed: the host's PNG codec stays out
            save_gray("mid.tif", mid)
            save_gray("small.tif", small)
            for preset, bound in (("lossless", 0), ("medium", 20)):
                with stage_clock({"load_luma": (cli, "load_luma"),
                                   "write_fast_batch": (HGICodec, "write_fast_batch")}) as enc_s:
                    enc, _ = _cli(["encode-tiled", "-i", "big.tif", "-o", "big.thgit", "--tile",
                                   "512", "--format", "thgi", "--fast", "-q", preset, *dev],
                                  {"K1": 8, "X1": 8})
                with stage_clock({"parse_thgit": (container, "parse_thgit"),
                                   "read_archive": (cli, "read_archive"),
                                   "decode_plane": (HGICodec, "decode_plane"),
                                   "save_gray": (cli, "save_gray")}) as dec_s:
                    dec, _ = _cli(["decode-tiled", "-i", "big.thgit", "-o", "big_d.tif", *dev],
                                  {"K2": 1})
                err = int(np.abs(load_luma("big_d.tif").astype(np.int64) - big).max())
                _check(err <= bound, f"tiled 8192x8192 --fast {preset}: max |err| {err} > {bound}")
                size = os.path.getsize("big.thgit")
                print(f"tiled 8192x8192 --tile 512 --fast {preset}: max |err| {err}, {size} B; "
                      f"encode-tiled {enc:.3f} s (load_luma {enc_s['load_luma']:.3f}, 8 "
                      f"write_fast_batch of 32 tiles {enc_s['write_fast_batch']:.3f}); "
                      f"decode-tiled {dec:.3f} s (parse_thgit {dec_s['parse_thgit']:.3f}, 256 "
                      f"read_archive {dec_s['read_archive']:.3f}, decode_plane (H2D, K2) "
                      f"{dec_s['decode_plane']:.3f}, save_gray {dec_s['save_gray']:.3f}) "
                      f"(host clock, s) [{card}]")
            legs = {"hgi": ["--format", "hgi"], "shared": ["--format", "thgi", "--shared-table"]}
            for leg, flags in legs.items():
                argv = ["encode-tiled", "-i", "mid.tif", "-o", f"{leg}.thgit", "--tile", "512",
                        "-q", "lossless", *flags, *dev]
                enc, _ = _cli(argv, {"K1": 1})
                dec, _ = _cli(["decode-tiled", "-i", f"{leg}.thgit", "-o", f"{leg}.tif", *dev],
                              {"K2": 1})
                _check(np.array_equal(load_luma(f"{leg}.tif"), mid),
                       f"tiled 2048x2048 {leg} lossless is not bit-exact")
                with open(f"{leg}.thgit", "rb") as f:
                    whole = f.read()
                # Cut the file halfway into block 7 of 16, then resume it.
                off = 21 + (512 if whole[20] & 1 else 0)
                for _ in range(7):
                    off += 12 + struct.unpack_from("<Q", whole, off)[0]
                with open("cut.thgit", "wb") as f:
                    f.write(whole[:off + 12 + struct.unpack_from("<Q", whole, off)[0] // 2])
                res, err_text = _cli([*argv[:4], "cut.thgit", *argv[5:], "--resume"], {"K1": 1})
                _check("resuming at block 7/16" in err_text, f"tiled {leg}: no resume: {err_text}")
                with open("cut.thgit", "rb") as f:
                    _check(f.read() == whole, f"tiled {leg}: the resumed file != the whole one")
                print(f"tiled 2048x2048 --tile 512 {leg} lossless: bit-exact, {len(whole)} B; "
                      f"encode-tiled {enc:.3f} s, decode-tiled {dec:.3f} s, --resume from block "
                      f"7/16 {res:.3f} s, equal to the uninterrupted file (host clock) [{card}]")
            argv = ["encode-tiled", "-i", "small.tif", "--tile", "256", "--format", "thgi",
                    "-q", "medium"]
            gpu, _ = _cli([*argv, "-o", "gpu.thgit", *dev], {"K1": 1})
            cpu, _ = _cli([*argv, "-o", "cpu.thgit", "--device", "cpu"], {"K1": 0})
            with open("gpu.thgit", "rb") as a, open("cpu.thgit", "rb") as b:
                _check(a.read() == b.read(), "tiled 1024x1024: .thgit bytes differ between "
                       "cuda and cpu")
            print(f"tiled 1024x1024 --tile 256 thgi medium: bytes equal on cuda ({gpu:.3f} s) "
                  f"and cpu ({cpu:.3f} s) (host clock) [{card}]")
        finally:
            os.chdir(cwd)


# The multihost phase's legs: (preset, side of the plane, error bound).
MULTIHOST_LEGS = (("lossless", 4096, 0), ("medium", 4096, 20))
MULTIHOST_TILE = 512
EXPORT_SHAPE = (1080, 1920)


def multihost_path(rng, card: str) -> dict:
    """Phase 9: the multi-process tiled tier, two ranks on the one card
    (``tools.multihost_run``: gloo on 127.0.0.1, a free port, a timeout on
    the ranks), ``--tile 512``, ``fmt="thgi"``, ``shared_table=True``, at
    lossless and medium on 4096x4096 (64 tiles, a rank's share [32, 512,
    512], held against the plain version in phase 2), both planes in one
    launch.  Each rank's share, K1 and K2 calls, stage times and gathered
    bytes are printed; the shares must be disjoint and cover every tile,
    both ranks must write the same ``.thgit``, equal to the one-process
    ``encode-tiled --shared-table`` file (and, at lossless, to a
    one-process ``encode_tiled_multihost``), and both must decode the
    plane within the bound.  Returns the ranks' K1 and K2 calls."""
    rank_launches = {"K1": 0, "K2": 0}
    flags = ["--tile", str(MULTIHOST_TILE), "-l", "4", "--format", "thgi", "--shared-table"]
    with tempfile.TemporaryDirectory() as tmp:
        planes, argv = [], []
        for preset, side, _ in MULTIHOST_LEGS:
            planes.append(_natural_plane(rng, (side, side)))
            src = os.path.join(tmp, f"{preset}.tif")
            save_gray(src, planes[-1])
            argv += ["-i", src, "-q", preset, "-o", os.path.join(tmp, f"{preset}.thgit")]
        t0 = time.perf_counter()
        records = multihost_run.rank_records(multihost_run.run_ranks(
            [*argv, *flags, "--device", DEVICE], 2, timeout=300))
        took = time.perf_counter() - t0
        _check(len(records) == 2 * len(MULTIHOST_LEGS), "multihost: records missing")
        print(f"multihost: two ranks coded {len(MULTIHOST_LEGS)} planes in {took:.3f} s (host "
              f"clock, the processes' start included) [{card}]")
        for leg, ((preset, side, bound), plane) in enumerate(zip(MULTIHOST_LEGS, planes)):
            pair = [r for r in records if r["leg"] == leg]
            n_tiles = (side // MULTIHOST_TILE) ** 2
            _check([r["rank"] for r in pair] == [0, 1], f"multihost {preset}: ranks missing")
            shares = [set(r["local_indices"]) for r in pair]
            _check(not shares[0] & shares[1] and shares[0] | shares[1] == set(range(n_tiles)),
                   f"multihost {preset}: shares overlap or miss tiles")
            digest = pair[0]["thgit_sha256"]
            _check(pair[1]["thgit_sha256"] == digest, f"multihost {preset}: ranks differ")
            for r in pair:
                _check(r["max_abs_err"] <= bound,
                       f"multihost {preset}: rank {r['rank']} max |err| {r['max_abs_err']}")
                for kernel in ("K1", "K2"):
                    _check(r["launches"][kernel] >= 1,
                           f"multihost {preset}: rank {r['rank']} never launched {kernel}")
                    rank_launches[kernel] += r["launches"][kernel]
                s = r["seconds"]
                share = sorted(r["local_indices"])
                print(f"multihost {side}x{side} {preset} rank {r['rank']}/2: tiles "
                      f"{share[0]}-{share[-1]} ({len(share)}); K1 {r['launches']['K1']}, K2 "
                      f"{r['launches']['K2']}; device encode {s['device_encode']:.3f} s, host "
                      f"coding {s['host_coding']:.3f} s, gather {s['gather']:.3f} s (encode "
                      f"{s['encode']:.3f} s), decode {s['decode']:.3f} s (host clock); gathered "
                      f"{r['dcn_payload_bytes']} B a rank for {r['compressed_bytes']} B coded "
                      f"of {r['raw_bytes']} B raw; max |err| {r['max_abs_err']} [{card}]")
            src, out = os.path.join(tmp, f"{preset}.tif"), os.path.join(tmp, f"{preset}.thgit")
            with open(out, "rb") as f:
                _check(_sha(f.read()) == digest, f"multihost {preset}: rank 0's file")
            one = os.path.join(tmp, "one.thgit")
            cli_s, _ = _cli(["encode-tiled", "-i", src, "-o", one, "-q", preset, *flags,
                             "--device", DEVICE], {"K1": 1})
            with open(one, "rb") as f:
                _check(_sha(f.read()) == digest,
                       f"multihost {preset}: != the one-process encode-tiled file")
            line = (f"multihost {side}x{side} {preset}: .thgit {digest[:16]} on both ranks, "
                    f"equal to one-process encode-tiled --shared-table ({cli_s:.3f} s)")
            if preset == "lossless":
                t0 = time.perf_counter()
                res = multihost.encode_tiled_multihost(
                    plane, (MULTIHOST_TILE,) * 2, 4, QuantizationLevel.parse(preset),
                    shared_table=True, devices=[torch.device(DEVICE)])
                blob = multihost.write_thgit_multihost(res, MULTIHOST_TILE)
                _check(_sha(blob) == digest and res.dcn_payload_bytes == 0,
                       f"multihost {preset}: the one-process run differs")
                line += (f" and to a one-process encode_tiled_multihost "
                         f"({time.perf_counter() - t0:.3f} s)")
            print(f"{line} (host clock) [{card}]")
    return rank_launches


def _export_worker(folder: str) -> int:
    """The export phase's fresh process: the first call of a cold process
    against one after ``compile``, then each exported program loaded and
    held bit for bit against ``HGICodec``; prints one JSON line."""
    entered = time.perf_counter()
    img = torch.from_numpy(np.load(os.path.join(folder, "image.npy"))).to(DEVICE)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    HGICodec(4, "medium", device=DEVICE).encode_plane(img)
    torch.cuda.synchronize()
    cold = time.perf_counter() - t0
    codec = HGICodec(4, "medium", device=DEVICE)
    t0 = time.perf_counter()
    codec.compile(EXPORT_SHAPE)
    compile_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    codec.encode_plane(img)
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    rows = {}
    loads = runs = 0.0
    for name in sorted(os.listdir(folder)):
        if not name.startswith("enc_"):
            continue
        _, preset, pred = name[:-4].split("_", 2)
        t0 = time.perf_counter()
        with open(os.path.join(folder, name), "rb") as f:
            enc = load_exported(f.read())
        with open(os.path.join(folder, f"dec_{preset}_{pred}.pt2"), "rb") as f:
            dec = load_exported(f.read())
        loads += time.perf_counter() - t0
        _reset_launches()
        t0 = time.perf_counter()
        grid, recon = enc(img)
        out = dec(grid)
        torch.cuda.synchronize()
        runs += time.perf_counter() - t0
        launches = _read_launches()
        ref = HGICodec(4, preset, predictor=pred, device=DEVICE)
        want_grid, want_recon = ref.encode_plane(img)
        rows[f"{preset} {pred}"] = {
            "equal": bool(torch.equal(grid, want_grid) and torch.equal(recon, want_recon)
                          and torch.equal(out, ref.decode_plane(want_grid))),
            "K1": launches["K1"], "K2": launches["K2"],
        }
    print(json.dumps({"cold_first_s": cold, "compile_s": compile_s, "after_compile_first_s": warm,
                      "loads_s": loads, "runs_s": runs,
                      "worker_s": time.perf_counter() - entered, "programs": rows}))
    return 0


def export_path(rng, card: str) -> dict:
    """Phase 10: ``export_encoder``/``export_decoder`` at 1080x1920 L4,
    lossless and medium, both predictors, on the card, to files; a fresh
    process (this script with ``--export-worker DIR``) loads them and
    holds their outputs bit for bit against ``encode_plane`` /
    ``decode_plane``, each launching K1 and K2 once, and times a cold
    first call against one after ``compile``.  Returns its K1 and K2
    calls."""
    folder = tempfile.mkdtemp()
    try:
        np.save(os.path.join(folder, "image.npy"), _natural_plane(rng, EXPORT_SHAPE))
        t0 = time.perf_counter()
        sizes = []
        for preset in ("lossless", "medium"):
            for pred in ("crossed", "left_top"):
                codec = HGICodec(4, preset, predictor=pred, device=DEVICE)
                for stage, blob in (("enc", codec.export_encoder(EXPORT_SHAPE)),
                                    ("dec", codec.export_decoder(EXPORT_SHAPE))):
                    with open(os.path.join(folder, f"{stage}_{preset}_{pred}.pt2"), "wb") as f:
                        f.write(blob)
                    sizes.append(len(blob))
        export_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--export-worker",
                               folder], cwd=ROOT, capture_output=True, text=True, timeout=300)
        load_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(folder, ignore_errors=True)
    _check(proc.returncode == 0, f"the export worker failed:\n{proc.stderr[-4000:]}")
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    launches = {"K1": 0, "K2": 0}
    for label, row in result["programs"].items():
        _check(row["equal"], f"export {label}: the loaded programs differ from HGICodec")
        for kernel in launches:
            _check(row[kernel] == 1, f"export {label}: {kernel} launched {row[kernel]} times")
            launches[kernel] += row[kernel]
    _check(len(result["programs"]) == 4, "export: not every program was loaded")
    print(f"export {EXPORT_SHAPE[0]}x{EXPORT_SHAPE[1]} L4 lossless/medium x crossed/left_top: 8 "
          f"programs of {min(sizes)}-{max(sizes)} B in {export_s:.3f} s; loaded and run in a "
          f"fresh process ({load_s:.3f} s: {load_s - result['worker_s']:.3f} s its start and "
          f"imports, 8 loads {result['loads_s']:.3f} s, 4 encode+decode runs "
          f"{result['runs_s']:.3f} s), bit-identical, K1 and K2 once each; first encode_plane "
          f"of a cold process {result['cold_first_s'] * 1e3:.3f} ms, after "
          f"compile({EXPORT_SHAPE}) ({result['compile_s'] * 1e3:.3f} ms) "
          f"{result['after_compile_first_s'] * 1e3:.3f} ms (host clock) [{card}]")
    return launches


def dryrun_path(card: str) -> None:
    """Phase 11: ``dryrun_multichip(4)``: four places on the one card."""
    t0 = time.perf_counter()
    dryrun.dryrun_multichip(4, [torch.device(DEVICE)] * 4)
    forward, (example,) = dryrun.entry(DEVICE)
    grid, _ = forward(example)
    _check(grid.device.type == DEVICE, "entry()'s forward left the card")
    print(f"dryrun_multichip(4) on 4 places of {DEVICE} and entry(): passed in "
          f"{time.perf_counter() - t0:.3f} s (host clock) [{card}]")


def serving_path(card: str) -> None:
    """Phase 12: ``python -m rustyhgi_tpu_torch.examples.serving`` on the
    card, its seven sections, every check printing True."""
    t0 = time.perf_counter()
    rc, text = _captured(lambda: serving.main(["--device", DEVICE]))
    took = time.perf_counter() - t0
    print(text.rstrip())
    sections = [line for line in text.splitlines() if line.startswith("=== ")]
    _check(rc == 0 and len(sections) == 7 and "False" not in text and text.count("True") == 5
           and "max err 20 (bound 20)" in text, "the serving example failed a section")
    print(f"serving example: 7 sections in {took:.3f} s (host clock) [{card}]")


# The backends phase's full-width legs write .thgi: a .hgi's DEFLATE-9 of
# a 1080x1920 medium grid takes about 10 s on the host (PERF.md section 5).
BACKENDS_SHAPE = (1080, 1920)
BACKENDS_FORMAT = "thgi"


def _read(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def backends_path(rng, card: str) -> None:
    """Phase 13: the CLI's ``--backend oracle|native`` against the kernels
    (``--backend torch``), then ``chip_probe validate`` on its three small
    cases in this process.  LENA, recovered by ``decode --backend native``
    of its committed lossless golden: at lossless and medium, ``encode``
    under each backend writes the manifest's ``.hgi`` bytes, ``decode``
    of the kernels' archive under each backend the same plane, and ``test
    -q lossless`` prints the same four lines and writes the same archive
    under all three.  At 1080x1920 on the seeded smooth plane, ``test
    --backend native`` and ``--backend torch`` at lossless and medium
    write the same archive, PNG and printout, and their host seconds are
    printed side by side: the archive write, the PNG load and save, and
    the rest, which holds the coding (the copies and K1 and K2, or the
    C++ stand-in, timed apart).  The host backends launch no kernel."""
    t0 = time.perf_counter()
    none = {k: 0 for k in chip_probe.KERNELS}
    dev = ["--device", DEVICE]
    with open(os.path.join(GOLDEN, "baseline", "manifest.json")) as f:
        manifest = json.load(f)
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            _cli(["decode", "-i", os.path.join(GOLDEN, "baseline", "lena_l4_lossless.hgi"),
                  "-o", "lena.png", "--backend", "native"], none)
            lena = load_luma("lena.png")
            _check(_sha(lena.tobytes()) == manifest["lena_l4_lossless"]["input_sha256"],
                   "decode --backend native of the LENA golden gave another plane")
            for preset in ("lossless", "medium"):
                entry = manifest[f"lena_l4_{preset}"]
                for backend in ("torch", "oracle", "native"):
                    extra, want = (dev, {"K1": 1}) if backend == "torch" else ([], none)
                    _cli(["encode", "-i", "lena.png", "-o", f"{backend}.hgi", "-q", preset,
                          "--backend", backend, *extra], want)
                    blob = _read(f"{backend}.hgi")
                    _check(_sha(blob) == entry["hgi_sha256"],
                           f"LENA {preset} encode --backend {backend}: .hgi digest "
                           f"{_sha(blob)[:8]} != manifest {entry['hgi_sha256'][:8]}")
                    extra, want = (dev, {"K2": 1}) if backend == "torch" else ([], none)
                    _cli(["decode", "-i", "torch.hgi", "-o", f"{backend}.png",
                          "--backend", backend, *extra], want)
                    _check(_sha(load_luma(f"{backend}.png").tobytes()) == entry["decoded_sha256"],
                           f"LENA {preset} decode --backend {backend} differs from the manifest")
            shown = {}
            for backend in ("torch", "oracle", "native"):
                extra, want = (dev, {"K1": 1, "K2": 1}) if backend == "torch" else ([], none)
                _, shown[backend] = _captured(lambda: _cli(
                    ["test", "lena.png", "-q", "lossless", "-s", f"_{backend}",
                     "--backend", backend, *extra], want))
                _check(shown[backend] == shown["torch"]
                       and _read(f"lena_{backend}.hgi") == _read("lena_torch.hgi"),
                       f"LENA test --backend {backend} printed or wrote other than torch")
            print(f"backends LENA: encode under torch, oracle and native == the manifest's "
                  f".hgi digests (lossless, medium); decode of the kernels' archive the same "
                  f"plane under each; test -q lossless printed {shown['torch'].splitlines()} "
                  f"under all three")

            save_gray("full.png", _natural_plane(rng, BACKENDS_SHAPE))
            for preset in ("lossless", "medium"):
                runs = {}
                for backend in ("torch", "native"):
                    extra, want = (dev, {"K1": 1, "K2": 1}) if backend == "torch" else ([], none)
                    with stage_clock({"load": (cli, "load_luma"),
                                      "native_encode": (cli, "native_encode"),
                                      "native_decode": (cli, "native_decode"),
                                      "write_archive": (cli, "write_archive"),
                                      "save": (cli, "save_gray")}) as st:
                        (took, _), text = _captured(lambda: _cli(
                            ["test", "full.png", "-q", preset, "--format", BACKENDS_FORMAT,
                             "-s", f"_{backend}", "--backend", backend, *extra], want))
                    runs[backend] = (took, text, dict(st))
                _check(runs["native"][1] == runs["torch"][1],
                       f"{preset} test --backend native printed other than torch")
                blob = _read(f"full_torch.{BACKENDS_FORMAT}")
                _check(_read(f"full_native.{BACKENDS_FORMAT}") == blob,
                       f"1080x1920 {preset} test --backend native wrote other bytes than torch")
                _check(np.array_equal(load_luma("full_native.png"), load_luma("full_torch.png")),
                       f"1080x1920 {preset} test --backend native decoded another plane")
                parts = []
                for backend, what in (("torch", "H2D, K1, K2, D2H"),
                                      ("native", "the stand-in's encode {native_encode:.4f} + "
                                                 "decode {native_decode:.4f}")):
                    took, _, st = runs[backend]
                    rest = took - st["write_archive"] - st["load"] - st["save"]
                    parts.append(
                        f"{backend} {took:.3f} s = write_archive {st['write_archive']:.3f} + PNG "
                        f"load {st['load']:.3f} + save {st['save']:.3f} + the rest {rest:.4f} "
                        f"({what.format(**st)}, the SD)")
                print(f"backends {'x'.join(map(str, BACKENDS_SHAPE))} {preset} test --format "
                      f"{BACKENDS_FORMAT}: same bytes ({len(blob)} B) and printout; "
                      f"{' | '.join(parts)} (host clock) [{card}]")
        finally:
            os.chdir(cwd)
    cli_s = time.perf_counter() - t0

    t1 = time.perf_counter()
    result = chip_probe.validate(chip_probe.VALIDATE_CASES[2:])
    for case, row in result["validate"].items():
        for column, ok in row.items():
            _check(ok or (ok is None and column == "native" and case.endswith("left_top")),
                   f"chip_probe validate {case}: {column} is not OK")
    for kernel in ("K1", "K2", "K3", "K5"):
        _check(result["launches"][kernel] > 0, f"chip_probe validate never launched {kernel}")
    print(f"backends: CLI legs {cli_s:.1f} s, validate {time.perf_counter() - t1:.1f} s "
          f"(host clock) [{card}]")


def _captured(fn):
    """``fn()`` with its standard output caught; returns (result, text)."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = fn()
    return rc, out.getvalue()


def bench_tier(card: str) -> dict:
    """Phase 14: the probe, the CLI's bench and the bench through their
    entry points, each with the launch counts set to 0 just before it and
    read just after; returns each path's launches."""
    paths = {}
    _reset_launches()
    rc, text = _captured(lambda: chip_probe.main(["vpucal"]))
    paths["vpucal"] = _read_launches()
    print(text.rstrip())
    _check(rc == 0, "chip_probe vpucal failed")
    rates = json.loads(text.strip().splitlines()[-1])["vpucal"]
    _check(set(rates) == set(chip_probe.ROWS) and all(r["ops_per_s"] > 0 for r in rates.values()),
           "chip_probe vpucal did not measure every row")

    _reset_launches()
    t0 = time.perf_counter()
    rc, text = _captured(lambda: cli.main(["bench", "--batch", "8", "--samples", "3",
                                          "--device", DEVICE]))
    took = time.perf_counter() - t0
    paths["cli bench"] = _read_launches()
    print(f"cli bench --batch 8 --samples 3 ({took:.1f} s):\n{text.rstrip()} [{card}]")
    _check(rc == 0 and [line.split()[0] for line in text.splitlines()] == list(SUITE),
           "cli bench did not print the 8 criterion rows")

    _reset_launches()
    with tempfile.TemporaryDirectory() as tmp:
        details_path = os.path.join(tmp, "details.json")
        t0 = time.perf_counter()
        rc, text = _captured(lambda: bench.main(["--rounds", "1", "--details", details_path]))
        took = time.perf_counter() - t0
        paths["bench"] = _read_launches()
        with open(details_path) as f:
            details = json.load(f)
    last = json.loads(text.strip().splitlines()[-1])
    _check(rc == 0 and set(last) == {"metric", "value", "unit", "vs_baseline"}
           and last["value"] > 0 and last["vs_baseline"] > 0,
           "rustyhgi_tpu_torch.bench printed no headline or no baseline ratio")
    print(f"bench --rounds 1 ({took:.1f} s): {json.dumps(last)} [{card}]")
    print(f"bench details: {json.dumps(details)}")
    for label, kernels in (("vpucal", ("K8",)), ("cli bench", ("K1", "K2")),
                           ("bench", ("K1", "K2", "K3", "K5", "X1"))):
        print(f"phase bench-tier {label}: launches {paths[label]}")
        for kernel in kernels:
            _check(paths[label][kernel] > 0, f"the bench tier's {label} never launched {kernel}")
    return paths


def _launched(fn):
    """The device kernels one call of ``fn`` launches (torch.profiler, copies
    and memsets not counted); None when the traces dropped records."""
    return profiling.kernel_launches(profiling.device_trace(fn))


def kernel_launches() -> dict:
    """Phase 15, first: the device kernels one call of each kernel launches
    at 1x1080x1920 L4 medium, on the calls ``chip_probe times`` times
    (``chip_probe.kernel_rows``, a seed of their own), for the kernels'
    record; None where the traces dropped records."""
    img = torch.from_numpy(_natural_plane(np.random.default_rng([SEED, 9]),
                                          (1, 1080, 1920))).to(DEVICE)
    return {row: _launched(kern) for row, kern, *_ in
            chip_probe.kernel_rows(img, _table(QuantizationLevel.MEDIUM))}


def decode_launches(rng, card: str) -> None:
    """Phase 15, K2's and K5's device launches a call at 1080x1920: one at
    L4 and for K5's preview at upto 2, 1 + 8 - DECODE_FINE_LEVELS at L8."""
    img = torch.from_numpy(_natural_plane(rng, (1080, 1920))).to(DEVICE)
    fine = cuda_codec.DECODE_FINE_LEVELS
    shown = []
    for preset in (QuantizationLevel.LOSSLESS, QuantizationLevel.MEDIUM):
        for levels in (4, 8):
            grid = cuda_codec.encode_plane(img, levels, _table(preset))[0]
            anchors, subbands, _ = cuda_codec.encode_subbands(img, levels, _table(preset))
            calls = [("K2", lambda: cuda_codec.decode_plane(grid, levels), levels),
                     ("K5", lambda: cuda_codec.decode_subbands(anchors, subbands, img.shape,
                                                               levels), levels),
                     ("K5 preview 2", lambda: cuda_codec.decode_preview(
                         anchors, subbands[:2], img.shape, levels, 2), 2)]
            for name, fn, upto in calls:
                n = _launched(fn)
                want = 1 + max(upto - fine, 0)
                _check(n == want, f"{name} {preset.name.lower()} L{levels}: {n} device "
                                  f"launches, {want} expected")
                shown.append(f"{name} {preset.name.lower()} L{levels} {n:g}")
    print(f"K2/K5 device launches a call at 1080x1920 (torch.profiler): {', '.join(shown)} "
          f"[{card}]")


def k1_launches(rng, card: str) -> None:
    """Phase 15, K1's device launches a call at 1080x1920: one for lossless
    at any depth, one for lossy up to FINE_LEVELS, one more per coarser
    level."""
    img = torch.from_numpy(_natural_plane(rng, (1080, 1920))).to(DEVICE)
    fine = cuda_codec.FINE_LEVELS
    shown = []
    for preset in (QuantizationLevel.LOSSLESS, QuantizationLevel.MEDIUM):
        for levels in (4, 8):
            n = _launched(lambda: cuda_codec.encode_plane(img, levels, _table(preset)))
            want = 1 if preset == QuantizationLevel.LOSSLESS else 1 + max(levels - fine, 0)
            _check(n == want, f"K1 {preset.name.lower()} L{levels}: {n} device launches, "
                              f"{want} expected")
            shown.append(f"{preset.name.lower()} L{levels} {n:g}")
    print(f"K1 device launches a call at 1080x1920 (torch.profiler): {', '.join(shown)} "
          f"[{card}]")


def subband_launches(rng, card: str) -> None:
    """Phase 15, K3's and K4's device launches a call at 1080x1920: K3 one
    when lossless at any depth, one when lossy up to FINE_LEVELS and one
    more per coarser level, with or without recon; K4 one."""
    img = torch.from_numpy(_natural_plane(rng, (1080, 1920))).to(DEVICE)
    fine = cuda_codec.FINE_LEVELS
    shown = []
    for preset in (QuantizationLevel.LOSSLESS, QuantizationLevel.MEDIUM):
        table = _table(preset)
        for levels in (4, 8):
            anchors, subbands, _ = cuda_codec.encode_subbands(img, levels, table)
            k3 = 1 if table is None else 1 + max(levels - fine, 0)
            for name, fn, want in (
                    ("K3", lambda: cuda_codec.encode_subbands(img, levels, table), k3),
                    ("K3 no recon", lambda: cuda_codec.encode_subbands(img, levels, table,
                                                                       want_recon=False), k3),
                    ("K4", lambda: cuda_codec.assemble_grid(anchors, subbands, img.shape), 1)):
                n = _launched(fn)
                _check(n == want, f"{name} {preset.name.lower()} L{levels}: {n} device "
                                  f"launches, {want} expected")
                shown.append(f"{name} {preset.name.lower()} L{levels} {n:g}")
    print(f"K3/K4 device launches a call at 1080x1920 (torch.profiler): {', '.join(shown)} "
          f"[{card}]")


def new_path_shapes(rng, card: str) -> None:
    """Phase 15, the shapes the color and tiled paths give the kernels:
    device launches a call (torch.profiler) of K1 and K2 at [3, 1080,
    1920] (color's three planes), K1, X1 and K2 at [32, 512, 512] (a chunk
    of ``encode-tiled --fast``) and K2 at [256, 512, 512] (``decode-tiled``
    of 8192x8192); K1 and K2 must be one launch at L4, X1 three kernels."""
    shown = []
    for shape in [(3, 1080, 1920), (32, 512, 512), (256, 512, 512)]:
        img = torch.from_numpy(_natural_plane(rng, shape)).to(DEVICE)
        for preset in (QuantizationLevel.LOSSLESS, QuantizationLevel.MEDIUM):
            table = _table(preset)
            grid = cuda_codec.encode_plane(img, 4, table)[0]
            calls = [("K2", lambda: cuda_codec.decode_plane(grid, 4), 1)]
            if shape[0] != 256:
                calls[:0] = [("K1", lambda: cuda_codec.encode_plane(img, 4, table), 1)]
            if shape[0] == 32:
                calls.append(("X1", lambda: tpurans.encode_batch(grid.reshape(32, -1)), 3))
            for name, fn, want in calls:
                n = _launched(fn)
                _check(n in (None, want), f"{name} {preset.name.lower()} {list(shape)}: {n} "
                                          f"device launches, {want} expected")
                shown.append(f"{name} {preset.name.lower()} {list(shape)} " + (
                    "not measured" if n is None else f"{n:g}"))
    print(f"color and tiled shapes, device launches a call (torch.profiler): "
          f"{'; '.join(shown)} [{card}]")


def main() -> int:
    if sys.argv[1:2] == ["--export-worker"]:
        return _export_worker(sys.argv[2])
    started = time.perf_counter()
    if not torch.cuda.is_available():
        _fail("torch.cuda.is_available() is false: this smoke test needs a CUDA card")
    card = chip_probe.card()
    print(f"card: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")

    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.load()
    print(f"phase build: {os.path.relpath(lib_path, ROOT)} in "
          f"{time.perf_counter() - t0:.1f} s")
    log = lib_path.with_suffix(".log")
    if log.exists():
        print(log.read_text().rstrip())
        for name, info in chip_probe.ptxas_summary(
                log.read_text(), ("encode_lossless", "encode_tiles", "encode_level",
                                  "decode_tiles", "encode_sub_level", "encode_sub_lossless",
                                  "assemble_rows", "rans_histogram", "rans_normalize",
                                  "rans_encode_lanes", "bitpack_pack_warps",
                                  "bitpack_unpack_warps")).items():
            print(f"ptxas {name}: {info}")
    t0 = time.perf_counter()
    _check(native.available(), "the native coders (make -C native) did not build or load")
    print(f"phase native: {os.path.relpath(native.LIB_PATH, ROOT)} ready in "
          f"{time.perf_counter() - t0:.1f} s")

    # Early, while the profiler holds few records: late in a process its
    # traces drop some (PERF.md section 6).
    k1_launches(np.random.default_rng([SEED, 1]), card)
    decode_launches(np.random.default_rng([SEED, 2]), card)
    subband_launches(np.random.default_rng([SEED, 3]), card)
    new_path_shapes(np.random.default_rng([SEED, 12]), card)
    device_launches = kernel_launches()
    rng = np.random.default_rng(SEED)
    worst = compare_kernels(rng)
    worst.update(compare_fast_kernels(rng))
    worst["K8"] = compare_probe(np.random.default_rng([SEED, 8]))  # leaves rng as it was
    for kernel, err in compare_path_shapes(np.random.default_rng([SEED, 13])).items():
        worst[kernel] = max(worst[kernel], err)
    reproduce_goldens()

    _reset_launches()
    stages = main_path(rng)
    launches = _read_launches()
    print(f"phase main-path: launches {launches}")
    for kernel in ("K1", "K2"):
        _check(launches[kernel] > 0, f"the main path never launched {kernel}")
    for preset, (enc, wr, dec, size) in stages.items():
        print(f"main path 1080x1920 {preset}: encode {enc * 1e3:.3f} ms, "
              f"write_hgi {wr * 1e3:.3f} ms, read+decode {dec * 1e3:.3f} ms "
              f"(host clock), {size} bytes [{card}]")

    _reset_launches()
    sb_stages = subband_path(rng)
    sb_launches = _read_launches()
    print(f"phase subband-path: launches {sb_launches}")
    for kernel in ("K3", "K4", "K5"):
        _check(sb_launches[kernel] > 0, f"the subband path never launched {kernel}")
        launches[kernel] = sb_launches[kernel]
    for preset, st in sb_stages.items():
        ms = ", ".join(f"{name} {v:.3f} ms" for name, v in st["ms"].items())
        print(f"subband path 1080x1920 {preset}: {ms} (host clock); the race was won by "
              f"layout {st['won'][0]} codec {st['won'][1]} at {st['won'][2]} bytes, the "
              f"subband layout by codec {st['subband'][0]} at {st['subband'][1]} bytes [{card}]")

    batch, fast_stage = fast_stages(rng)  # launches X1 and K1 outside the count
    _reset_launches()
    fast_path(rng, batch, fast_stage, card)
    fast_launches = _read_launches()
    print(f"phase fast-path: launches {fast_launches}")
    for kernel in ("K1", "X1", "K6", "K7", "K2"):
        _check(fast_launches[kernel] > 0, f"the fast path never launched {kernel}")
    for kernel in ("K6", "K7", "X1"):
        launches[kernel] = fast_launches[kernel]

    # Seeds of their own, so that the phases after these draw what they drew.
    t0 = time.perf_counter()
    _reset_launches()
    color_path(np.random.default_rng([SEED, 10]), card)
    color_launches = _read_launches()
    print(f"phase color: launches {color_launches} in {time.perf_counter() - t0:.1f} s")
    for kernel in ("K1", "K2", "K5"):
        _check(color_launches[kernel] > 0, f"the color path never launched {kernel}")
    t0 = time.perf_counter()
    _reset_launches()
    tiled_path(np.random.default_rng([SEED, 11]), card)
    tiled_launches = _read_launches()
    print(f"phase tiled: launches {tiled_launches} in {time.perf_counter() - t0:.1f} s")
    for kernel in ("K1", "X1", "K2"):
        _check(tiled_launches[kernel] > 0, f"the tiled path never launched {kernel}")

    # Every launch of these phases in this process is recorded, and held
    # against the plain version after them; the worker processes' shapes
    # are phase 2's ([32, 512, 512] a rank, 1080x1920 an exported program).
    new_launches = {}
    recorder = _Recorder()
    try:
        for phase, run, kernels in (
                ("multihost", lambda: multihost_path(np.random.default_rng([SEED, 14]), card),
                 ("K1", "K2")),
                ("export", lambda: export_path(np.random.default_rng([SEED, 15]), card),
                 ("K1", "K2")),
                ("dryrun", lambda: dryrun_path(card), ("K1", "K2", "K3", "K5", "X1")),
                ("serving", lambda: serving_path(card), ("K1", "K2", "K3", "K5", "X1"))):
            t0 = time.perf_counter()
            seen = dict(recorder.seen)
            _reset_launches()
            with recorder:
                elsewhere = run() or {}  # the calls its worker processes made
            here = _read_launches()
            got = {k: here[k] + elsewhere.get(k, 0) for k in chip_probe.KERNELS}
            new_launches[phase] = got
            print(f"phase {phase}: launches {got} (in worker processes {elsewhere}) in "
                  f"{time.perf_counter() - t0:.1f} s")
            for kernel in kernels:
                _check(got[kernel] > 0, f"the {phase} path never launched {kernel}")
            for kernel in LAUNCHERS:
                _check(recorder.seen[kernel] - seen[kernel] == here[kernel],
                       f"the {phase} path launched {kernel} past the recorder")
        new_worst, shapes = recorder.replay()
    finally:
        recorder.close()
    for kernel, err in new_worst.items():
        worst[kernel] = max(worst[kernel], err)
    print(f"phase new-paths-vs-plain: the {len(recorder.calls)} distinct launches of phases 9-12 "
          f"in this process replayed, bit-identical (tolerance: exact), max_abs_err "
          f"{new_worst}; shapes {shapes}")

    t0 = time.perf_counter()
    _reset_launches()
    backends_path(np.random.default_rng([SEED, 16]), card)
    backends_launches = _read_launches()
    print(f"phase backends: launches {backends_launches} in {time.perf_counter() - t0:.1f} s")
    for kernel in ("K1", "K2", "K3", "K5"):
        _check(backends_launches[kernel] > 0, f"the backends phase never launched {kernel}")

    bench_paths = bench_tier(card)
    launches["K8"] = bench_paths["vpucal"]["K8"]
    _check("jax" not in sys.modules, "JAX was imported")
    print(f"chip_smoke: all phases passed in {time.perf_counter() - started:.1f} s")

    kernels = []
    for kernel in chip_probe.KERNELS:
        entry, replaces, src = chip_probe.REPLACES[kernel]
        record = {
            "name": f"{kernel} {entry}", "route": "cuda", "source": src, "replaces": replaces,
            "launches": launches[kernel], "max_abs_err": worst[kernel],
            "device_launches": device_launches[kernel],
        }
        if kernel in ("K6", "K7"):
            record["eight_plane"] = {"name": chip_probe.REPLACES[f"{kernel} 8-plane"][0],
                                     "device_launches": device_launches[f"{kernel} 8-plane"]}
        record["launches_color"] = color_launches[kernel]
        record["launches_tiled"] = tiled_launches[kernel]
        for phase, got in new_launches.items():
            record[f"launches_{phase}"] = got[kernel]
        record["launches_backends"] = backends_launches[kernel]
        kernels.append(record)
    print(json.dumps({"kernels": kernels}))
    print(chip_probe.card())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
