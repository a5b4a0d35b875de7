#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

Run from the root of a checkout:

    python3 chip_smoke.py

It needs one CUDA card and ``nvcc``; it imports nothing of JAX.  Phases,
each of which fails the run by raising:

1. build the kernels of ``rustyhgi_tpu_torch/csrc/`` with ``nvcc``;
2. hold each kernel against its plain PyTorch version on the card, bit
   for bit, over ragged shapes, depths 0-16, every preset, both
   predictors, and the real sizes 1080x1920, 8x1080x1920 and 2614x2368;
3. reproduce the JAX package's committed bytes with no JAX: the LENA
   plane recovered from its lossless golden, its grids and its ``.hgi``
   digests, and the synthetic golden;
4. drive the main path through its entry points (``HGICodec`` with the
   container, then the CLI) at 1080x1920, and check that both kernels
   were launched there;
5. time each kernel and its plain version with CUDA events.

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

from rustyhgi_tpu_torch import HGICodec, cli
from rustyhgi_tpu_torch.ops import _build, cuda_codec, pyramid
from rustyhgi_tpu_torch.ops.quantizers import (
    QuantizationLevel,
    linear_error,
    quantize_fn,
)
from rustyhgi_tpu_torch.utils.container import (
    read_archive,
    read_hgi,
    write_archive,
    write_hgi,
)
from rustyhgi_tpu_torch.utils.imageio import load_luma, save_gray

DEVICE = "cuda"
ROOT = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(ROOT, "tests", "golden")
SEED = 20261016
REPEATS = 7  # timed runs per measurement, after one warm-up


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


def compare_kernels(rng) -> int:
    """Phase 2: kernel against plain version on the card; returns cases."""
    cases = []
    for shape in [(37, 53), (1, 7), (7, 1), (3, 37, 53), (0, 0)]:
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
    worst = 0
    for shape, levels, table, pred, preset in cases:
        img = torch.from_numpy(rng.integers(0, 256, shape, dtype=np.uint8)).to(DEVICE)
        grid_k, recon_k = cuda_codec.encode_plane(img, levels, table, pred)
        grid_p, recon_p = pyramid.encode_plane(img, levels, table, pred)
        dec_k = cuda_codec.decode_plane(grid_k, levels, pred)
        dec_p = pyramid.decode_plane(grid_p, levels, pred)
        torch.cuda.synchronize()
        tag = f"shape={shape} levels={levels} preset={preset.name} pred={pred}"
        for name, a, b in (("grid", grid_k, grid_p), ("recon", recon_k, recon_p),
                           ("decode", dec_k, dec_p)):
            err = int((a.int() - b.int()).abs().max()) if a.numel() else 0
            worst = max(worst, err)
            _check(err == 0, f"kernel {name} differs from the plain version at {tag}")
        bound = linear_error(preset) if table is not None else 0
        if img.numel():
            err = int((dec_k.int() - img.int()).abs().max())
            _check(err <= bound, f"roundtrip error {err} > {bound} at {tag}")
            _check(torch.equal(dec_k, recon_k), f"decode != recon at {tag}")
    print(f"phase kernels-vs-plain: {len(cases)} cases bit-identical "
          f"(tolerance: exact), max_abs_err={worst}")
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
    print("phase goldens: LENA plane, grids and .hgi digests (lossless, medium) "
          "and the synthetic golden reproduced")


def main_path(rng) -> dict:
    """Phase 4: the entry points a user calls, at 1080x1920."""
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


def timings(rng, card: str) -> dict:
    """Phase 5: kernel and plain version, same inputs, same call."""
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=DEVICE)  # > 50 MB L2
    rows = {}
    for shape in [(1, 1080, 1920), (8, 1080, 1920)]:
        img = torch.from_numpy(_natural_plane(rng, shape)).to(DEVICE)
        for preset in (QuantizationLevel.LOSSLESS, QuantizationLevel.MEDIUM):
            table = _table(preset)
            grid = cuda_codec.encode_plane(img, 4, table)[0]
            for op, kern, plain in (
                ("encode", lambda: cuda_codec.encode_plane(img, 4, table),
                 lambda: pyramid.encode_plane(img, 4, table)),
                ("decode", lambda: cuda_codec.decode_plane(grid, 4),
                 lambda: pyramid.decode_plane(grid, 4)),
            ):
                # Plain, kernel, kernel, plain: compare within one call.
                p1, k1 = _time(plain, flush), _time(kern, flush)
                k2, p2 = _time(kern, flush), _time(plain, flush)
                key = (op, "x".join(map(str, shape)), preset.name.lower())
                k, p = statistics.median(k1 + k2), statistics.median(p1 + p2)
                rows[key] = (k, p)
                print(f"time {op} {key[1]} L4 {key[2]}: kernel median {k:.4f} ms "
                      f"[{min(k1 + k2):.4f}..{max(k1 + k2):.4f}], plain median "
                      f"{p:.4f} ms [{min(p1 + p2):.4f}..{max(p1 + p2):.4f}], "
                      f"{2 * REPEATS} runs each, L2 flushed [{card}]")
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

    rng = np.random.default_rng(SEED)
    worst = compare_kernels(rng)
    reproduce_goldens()

    cuda_codec.encode_launches = cuda_codec.decode_launches = 0
    stages = main_path(rng)
    launches = {"encode": cuda_codec.encode_launches, "decode": cuda_codec.decode_launches}
    print(f"phase main-path: launches {launches}")
    for op, n in launches.items():
        _check(n > 0, f"the main path never launched the {op} kernel")
    for preset, (enc, wr, dec, size) in stages.items():
        print(f"main path 1080x1920 {preset}: encode {enc * 1e3:.3f} ms, "
              f"write_hgi {wr * 1e3:.3f} ms, read+decode {dec * 1e3:.3f} ms "
              f"(host clock), {size} bytes [{card}]")

    rows = timings(rng, card)
    _check("jax" not in sys.modules, "JAX was imported")

    src = "rustyhgi_tpu_torch/csrc/hgi_codec.cu"
    kernels = []
    for op, name, line in (("encode", "K1 hgi_encode", 778), ("decode", "K2 hgi_decode", 1037)):
        ms, plain_ms = rows[(op, "1x1080x1920", "medium")]
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": f"rustyhgi_tpu/ops/pallas_codec.py:{line}",
            "launches": launches[op], "max_abs_err": worst,
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
