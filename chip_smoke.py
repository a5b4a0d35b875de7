#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

Run from the root of a checkout:

    python3 chip_smoke.py

It needs one CUDA card, ``nvcc`` and a C++ compiler for ``native/``; it
imports nothing of JAX.  Phases, each of which fails the run by raising:

1. build the kernels of ``rustyhgi_tpu_torch/csrc/`` with ``nvcc``;
2. hold each kernel (K1-K5) against its plain PyTorch version on the
   card, bit for bit, over ragged shapes, depths 0-16, every preset, both
   predictors, every preview depth, and the real sizes 1080x1920,
   8x1080x1920 and 2614x2368; the subband kernels also against K1;
3. reproduce the JAX package's committed bytes with no JAX: the LENA
   plane recovered from its lossless golden, its grids and its ``.hgi``
   and ``.thgi`` digests (the latter need the native coders), the
   decodes of the committed ``.thgi`` files, and the synthetic goldens;
4. drive the ``.hgi`` main path through its entry points (``HGICodec``
   with the container, then the CLI) at 1080x1920, and check that K1 and
   K2 were launched there;
5. drive the ``.thgi`` subband path the same way (``HGICodec``
   ``encode_subbands``, ``assemble_grid``, ``write_thgi``,
   ``read_thgi_subbands``, ``decode_subbands``, ``decode_preview``, then
   the CLI's ``--format thgi``, ``decode`` and ``decode --preview 2``),
   and check that K3, K4 and K5 were launched there;
6. time each kernel and its plain version with CUDA events, and read
   their device time alone with ``torch.profiler``.

The last line is ``{"ok": true, "device": {...}}``; the line before it
holds the card's name and power limit, and the one before that the
kernels' JSON record.
"""

from __future__ import annotations

import contextlib
import hashlib
import io
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
import zlib

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from rustyhgi_tpu_torch import HGICodec, cli
from rustyhgi_tpu_torch.ops import _build, cuda_codec, native, pyramid
from rustyhgi_tpu_torch.ops.quantizers import (
    QuantizationLevel,
    linear_error,
    quantize_fn,
)
from rustyhgi_tpu_torch.utils import container
from rustyhgi_tpu_torch.utils.container import (
    Archive,
    read_archive,
    read_hgi,
    read_thgi_preview,
    read_thgi_subbands,
    write_archive,
    write_hgi,
    write_thgi,
)
from rustyhgi_tpu_torch.utils.imageio import load_luma, save_gray

DEVICE = "cuda"
ROOT = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(ROOT, "tests", "golden")
SEED = 20261016
REPEATS = 7  # timed runs per measurement, after one warm-up
KERNELS = ("K1", "K2", "K3", "K4", "K5")
REPLACES = {  # the Pallas kernel each replaces, rustyhgi_tpu/ops/pallas_codec.py
    "K1": ("hgi_encode", 778), "K2": ("hgi_decode", 1037),
    "K3": ("hgi_encode_subbands", 913), "K4": ("hgi_assemble_grid", 1249),
    "K5": ("hgi_decode_subbands", 1321),
}
LAYOUT_NAMES = {0: "rowmajor", 1: "subband"}
CODEC_NAMES = {tag: name for name, tag in container._CODEC_NAMES.items()}
LAUNCHES = {  # each kernel's launch counter in cuda_codec
    "K1": "encode_launches", "K2": "decode_launches",
    "K3": "encode_subbands_launches", "K4": "assemble_launches",
    "K5": "decode_subbands_launches",
}


def _reset_launches() -> None:
    for attr in LAUNCHES.values():
        setattr(cuda_codec, attr, 0)


def _read_launches() -> dict:
    return {k: getattr(cuda_codec, attr) for k, attr in LAUNCHES.items()}


def _fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAIL: {msg}")


def _check(cond: bool, msg: str) -> None:
    if not cond:
        _fail(msg)


def _smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


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
    if a.shape != b.shape:
        _fail(f"shapes differ: {tuple(a.shape)} vs {tuple(b.shape)}")
    return int((a.int() - b.int()).abs().max()) if a.numel() else 0


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
    worst = dict.fromkeys(KERNELS, 0)
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
          f"K5(K3) == K1 recon in every case")
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


def _time(fn, flush: torch.Tensor) -> list:
    """ms of REPEATS CUDA-event-timed runs after a warm-up; L2 flushed."""
    fn()
    times = []
    for _ in range(REPEATS):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return times


def _device_ms(fn):
    """Device time of one call in ms: the time of its CUDA kernels and
    copies, summed by torch.profiler over REPEATS calls after a warm-up;
    None when the trace holds no device time."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(REPEATS):
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages())
    return us / REPEATS / 1e3 if us > 0 else None


def timings(rng, card: str) -> dict:
    """Phase 6: kernel and plain version, same inputs, same call."""
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=DEVICE)  # > 50 MB L2
    rows = {}
    for shape in [(1, 1080, 1920), (8, 1080, 1920)]:
        img = torch.from_numpy(_natural_plane(rng, shape)).to(DEVICE)
        hw = img.shape[-2:]
        for preset in (QuantizationLevel.LOSSLESS, QuantizationLevel.MEDIUM):
            table = _table(preset)
            grid = cuda_codec.encode_plane(img, 4, table)[0]
            anchors, subbands, _ = cuda_codec.encode_subbands(img, 4, table)
            for kernel, kern, plain in (
                ("K1", lambda: cuda_codec.encode_plane(img, 4, table),
                 lambda: pyramid.encode_plane(img, 4, table)),
                ("K2", lambda: cuda_codec.decode_plane(grid, 4),
                 lambda: pyramid.decode_plane(grid, 4)),
                ("K3", lambda: cuda_codec.encode_subbands(img, 4, table),
                 lambda: pyramid.encode_subbands(img, 4, table)),
                ("K4", lambda: cuda_codec.assemble_grid(anchors, subbands, hw),
                 lambda: pyramid.assemble_grid(anchors, subbands, hw)),
                ("K5", lambda: cuda_codec.decode_subbands(anchors, subbands, hw, 4),
                 lambda: pyramid.decode_subbands(anchors, subbands, hw, 4)),
            ):
                # Plain, kernel, kernel, plain: compare within one call.
                p1, k1 = _time(plain, flush), _time(kern, flush)
                k2, p2 = _time(kern, flush), _time(plain, flush)
                key = (kernel, "x".join(map(str, shape)), preset.name.lower())
                k, p = statistics.median(k1 + k2), statistics.median(p1 + p2)
                rows[key] = (k, p)
                print(f"time {kernel} {REPLACES[kernel][0]} {key[1]} L4 {key[2]}: kernel "
                      f"median {k:.4f} ms [{min(k1 + k2):.4f}..{max(k1 + k2):.4f}], plain "
                      f"median {p:.4f} ms [{min(p1 + p2):.4f}..{max(p1 + p2):.4f}], "
                      f"{2 * REPEATS} runs each, L2 flushed [{card}]")
                # The event window above includes the wrapper's host time
                # whenever the card finishes first; the profiler's device
                # time does not.
                dk, dp = _device_ms(kern), _device_ms(plain)
                shown = ("not measured (no device time in the trace)" if d is None
                         else f"{d:.4f} ms ({100 * (1 - d / e):.1f}% idle in the event "
                         f"window)" for d, e in ((dk, k), (dp, p)))
                print(f"device {kernel} {key[1]} L4 {key[2]}: kernel {next(shown)}, plain "
                      f"{next(shown)}, torch.profiler mean of {REPEATS} calls [{card}]")
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        _fail("torch.cuda.is_available() is false: this smoke test needs a CUDA card")
    card = _smi()
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
    t0 = time.perf_counter()
    _check(native.available(), "the native coders (make -C native) did not build or load")
    print(f"phase native: {os.path.relpath(native.LIB_PATH, ROOT)} ready in "
          f"{time.perf_counter() - t0:.1f} s")

    rng = np.random.default_rng(SEED)
    worst = compare_kernels(rng)
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

    rows = timings(rng, card)
    _check("jax" not in sys.modules, "JAX was imported")

    src = "rustyhgi_tpu_torch/csrc/hgi_codec.cu"
    kernels = []
    for kernel in KERNELS:
        entry, line = REPLACES[kernel]
        ms, plain_ms = rows[(kernel, "1x1080x1920", "medium")]
        kernels.append({
            "name": f"{kernel} {entry}", "route": "cuda", "source": src,
            "replaces": f"rustyhgi_tpu/ops/pallas_codec.py:{line}",
            "launches": launches[kernel], "max_abs_err": worst[kernel],
            "ms": ms, "plain_ms": plain_ms,
        })
    print(json.dumps({"kernels": kernels}))
    print(_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
