"""Benchmark harness of the PyTorch/CUDA port, on one CUDA card.

Counterpart of the JAX repo's root ``bench.py``::

    python -m rustyhgi_tpu_torch.bench [--device cuda|cpu] [--rounds N]
                                       [--details PATH]

Its last line of standard output is one JSON object with the headline,
``{"metric": "encode_throughput_lossless_l4", "value", "unit": "MPix/s",
"vs_baseline"}``: the best complete encode to an archivable layout (the
row-major grid or the subband layout), by median, at 8x1080x1920 L4
lossless, against the single-threaded scalar C++ stand-in for the
reference binary (:func:`..ops.native.native_encode`).  Every row goes to
the JSON file named by ``--details`` (default ``build/bench_details.json``)
and to standard error.

The image is the reference's criterion fixture (benches/bench.rs:15-31):
synthetic 1920x1080 with ``pixel = (x*y) as u8``, at L4.  Row groups:

* engines: the CUDA kernels (K1 grid, K3 subband) and the plain PyTorch
  version, lossless, at 8x1080x1920 (the headline batch) and 1x1080x1920
  (the serving shape); ``--rounds`` interleaved rounds, median, min, max
  and spread kept; each row's device time once, by ``torch.profiler``;
* aux: decode (K2, plain) and the medium encodes (K1, K3, plain), at both
  shapes, the same way;
* subband-direct decode (K5, plain), at both shapes;
* the scalar C++ baseline, encode and decode of one plane;
* container sizes of LENA, decoded from the committed lossless golden;
* host entropy coders in MB/s (rANS, rANS-MT, DEFLATE-9 on the medium
  grid of the batch; ctx and ctx-MT on one plane's subband payload);
* end to end, host clock, interleaved samples: encode + rANS-MT,
  ``write_fast``, ``write_fast_batch``, and the payload ratio of the
  device rANS against the host rANS;
* the decomposition of those paths: device time (profiler), the bytes
  copied to the host (``write_fast``: the tables, counts and states, then
  exactly the coded words), payload bytes, host entropy time;
* the device rANS (X1) alone in MB/s, device time;
* device-to-host and host-to-device copy rates (pageable host memory),
  the slope between 2 and 16 MiB;
* the level sweep L1-L8 on a synthetic 2614x2368 plane (the manifest's
  ikonos size), the engine the codec's ``auto`` picks, 5 rounds.

Timing on the card: :func:`cuda_seconds_per_call` times calls with CUDA
events after a warm-up, the L2 cache flushed before each, and takes the
median.  A time below the bytes floor (the bytes a call must move over
the card's 3.35 TB/s) cannot be real: it is measured again, never
clamped, and after ``RETRIES`` tries the bench fails.  ``--device cpu`` runs the
same rows with the plain PyTorch engine and the host clock, for tests;
its numbers are the CPU's, never the card's.  ``--device cuda`` without a
card raises.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
import zlib

import numpy as np
import torch

from .utils import profiling
from .utils.benchsuite import synthetic
from .utils.profiling import StageTimer, host_samples, require_device

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LENA_GOLDEN = os.path.join(ROOT, "tests", "golden", "baseline", "lena_l4_lossless.hgi")
DETAILS = os.path.join(ROOT, "build", "bench_details.json")

W, H, LEVELS, BATCH = 1920, 1080, 4, 8
SWEEP_H, SWEEP_W = 2614, 2368
SWEEP_LEVELS = range(1, 9)
ENGINE_ROUNDS = 7
SWEEP_ROUNDS = 5
E2E_SAMPLES = 5
REPEATS = 7  # timed or traced calls per sample after a warm-up (chip_probe.py's REPEATS)
ENTROPY_PLANES = BATCH  # planes of the medium grid the host coders code
PEAK_BYTES_PER_S = 3.35e12  # H100 SXM device memory
RETRIES = 3  # takes of a sample below the bytes floor


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def median_time(fn, iters: int = 3) -> float:
    return float(np.median(host_samples(fn, iters)))


def min_time(fn, iters: int = 5) -> float:
    return float(np.min(host_samples(fn, iters)))


def cuda_seconds_per_call(fn, device, floor_bytes: int = 0) -> float:
    """Median seconds of one call of ``fn``: ``REPEATS`` calls timed with
    CUDA events after a warm-up, L2 flushed before each (the host clock on
    the CPU).

    ``floor_bytes`` is the least device-memory traffic of one call; a
    median below it at 3.35 TB/s is measured again, and after ``RETRIES``
    tries the bench raises: a clamped or impossible time is never reported.
    """
    floor = floor_bytes / PEAK_BYTES_PER_S
    for attempt in range(RETRIES):
        t = float(np.median(profiling.device_samples(fn, REPEATS, device)))
        if t >= floor:
            return t
        log(f"WARNING: {t * 1e6:.1f} us below the bytes floor {floor * 1e6:.1f} us; "
            f"retry {attempt + 1}/{RETRIES}")
    raise RuntimeError(f"time below the bytes floor after {RETRIES} tries: "
                       f"{t * 1e6:.1f} us < {floor * 1e6:.1f} us")


def device_seconds(fn, device):
    """Device time of one call (:func:`..utils.profiling.device_trace`, on
    ``cuda``) and its split into kernels, copies and memsets; ``(None,
    {})`` when not measured."""
    parts = {"kernels": 0.0, "copies": 0.0, "memsets": 0.0}
    traced = profiling.device_trace(fn, REPEATS) if torch.device(device).type == "cuda" else {}
    for key, rec in traced.items():
        part = "copies" if "Memcpy" in key else "memsets" if "Memset" in key else "kernels"
        parts[part] += rec.seconds
    total = sum(parts.values())
    return (total, parts) if total > 0 else (None, {})


def _spread(vals) -> dict:
    v = np.asarray(vals, dtype=np.float64)
    med = float(np.median(v))
    return {
        "median_mpix_s": med,
        "min_mpix_s": float(v.min()),
        "max_mpix_s": float(v.max()),
        "spread_pct": float((v.max() - v.min()) / med * 100.0) if med else 0.0,
        "samples": [float(s) for s in vals],
    }


def _interleaved(rows, rounds: int, device) -> dict:
    """``rows`` is ``[(name, fn, npix, floor_bytes)]``; each is sampled
    ``rounds`` times, the rows interleaved in each round.  Returns
    ``{name: spread stats + device_ms}``."""
    samples = {name: [] for name, *_ in rows}
    for rnd in range(rounds):
        for name, fn, npix, floor in rows:
            t = cuda_seconds_per_call(fn, device, floor)
            samples[name].append(npix / t / 1e6)
            log(f"  round {rnd} {name:36s} {npix / t / 1e6:10.1f} MPix/s")
    out = {}
    for name, fn, npix, _ in rows:
        out[name] = _spread(samples[name])
        dev_s, _ = device_seconds(fn, device)
        out[name]["device_ms"] = None if dev_s is None else dev_s * 1e3
        out[name]["device_mpix_s"] = None if dev_s is None else npix / dev_s / 1e6
        log(f"{name:36s} median {out[name]['median_mpix_s']:10.1f} MPix/s, spread "
            f"{out[name]['spread_pct']:5.1f}%, device "
            f"{'not measured' if dev_s is None else f'{dev_s * 1e3:.4f} ms'}")
    return out


def _shapes():
    return {f"{BATCH}x{H}x{W}": BATCH, f"1x{H}x{W}": 1}


def engines_and_aux(dbatch, rounds: int, device) -> dict:
    """The engine rows (lossless encodes), the aux rows (decode, medium
    encodes) and the subband-direct decode rows, at both shapes."""
    from .ops import cuda_codec, pyramid
    from .ops.quantizers import QuantizationLevel, quantize_fn

    medium = quantize_fn(QuantizationLevel.MEDIUM).table
    groups = {"engines": [], "aux": [], "subband_decode": []}
    for label, b in _shapes().items():
        x = dbatch[:b]
        n = x.numel()
        grid = cuda_codec.encode_plane(x, LEVELS)[0]
        anchors, subbands, _ = cuda_codec.encode_subbands(x, LEVELS)
        for engine, mod in (("cuda", cuda_codec), ("torch", pyramid)):
            groups["engines"] += [
                (f"{engine}_grid {label}",
                 lambda x=x, mod=mod: mod.encode_plane(x, LEVELS), n, 2 * n),
                (f"{engine}_subband {label}",
                 lambda x=x, mod=mod: mod.encode_subbands(x, LEVELS, want_recon=False),
                 n, 2 * n),
            ]
            groups["aux"] += [
                (f"{engine}_decode_grid {label}",
                 lambda g=grid, mod=mod: mod.decode_plane(g, LEVELS), n, 2 * n),
                (f"{engine}_encode_grid_medium {label}",
                 lambda x=x, mod=mod: mod.encode_plane(x, LEVELS, medium), n, 2 * n),
            ]
            if engine == "cuda":
                groups["aux"].append(
                    (f"cuda_encode_subband_medium {label}",
                     lambda x=x: cuda_codec.encode_subbands(x, LEVELS, medium, want_recon=False),
                     n, 2 * n))
            groups["subband_decode"].append(
                (f"{engine}_decode_subband {label}",
                 lambda a=anchors, s=subbands, mod=mod: mod.decode_subbands(a, s, (H, W), LEVELS),
                 n, 2 * n))
    return {name: _interleaved(rows, rounds, device) for name, rows in groups.items()}


def scalar_baseline(image, device) -> dict:
    """The scalar C++ stand-in for the reference binary, one plane, one
    thread.  Without the native library it raises on the card, where the
    headline needs its ratio, and is empty on the CPU."""
    from .ops.native import available, native_decode, native_encode
    from .ops.quantizers import QuantizationLevel

    if not available():
        if torch.device(device).type == "cuda":
            raise RuntimeError("the scalar C++ baseline needs native/librustyhgi.so "
                               "(make -C native), which did not build or load")
        log("native baseline unavailable: make -C native failed")
        return {}
    t = median_time(lambda: native_encode(image, LEVELS, QuantizationLevel.LOSSLESS), iters=5)
    base = {"encode_mpix_s": image.size / t / 1e6}
    grid = native_encode(image, LEVELS, QuantizationLevel.LOSSLESS)
    t = median_time(lambda: native_decode(grid, LEVELS), iters=5)
    base["decode_mpix_s"] = image.size / t / 1e6
    log(f"scalar C++ baseline: encode {base['encode_mpix_s']:.1f} MPix/s, "
        f"decode {base['decode_mpix_s']:.1f} MPix/s")
    return base


def lena_sizes(device) -> dict:
    """``.hgi`` and ``.thgi`` bytes of LENA, decoded from the committed
    lossless golden (its manifest's input digest is its decoded digest)."""
    from .models.codec import HGICodec
    from .utils.container import read_hgi, write_hgi, write_thgi

    with open(LENA_GOLDEN, "rb") as f:
        lena = HGICodec(4, "lossless", device=device).decode(read_hgi(f.read()))
    sizes = {}
    for quant in ("lossless", "medium"):
        archive = HGICodec(4, quant, device=device).encode(lena)
        sizes[quant] = {"hgi": len(write_hgi(archive)), "thgi": len(write_thgi(archive))}
    log(f"LENA container bytes: {sizes}")
    return sizes


def entropy_rows(codec_m, image, batch) -> dict:
    """The host coders' MB/s."""
    from .ops.ctxcoder import ctx_encode, ctx_encode_mt
    from .ops.entropy import rans_encode
    from .utils.container import (
        Archive, _ctx_pieces, _ctx_shift, _rans_mt_encode, _subband_payload,
    )

    speed = {}
    planes = batch[:ENTROPY_PLANES]
    grid_big = codec_m.encode_plane(planes)[0].cpu().numpy().tobytes()
    speed["entropy_input_planes"] = int(planes.shape[0])
    t = median_time(lambda: rans_encode(grid_big), iters=3)
    speed["rans_MBps"] = len(grid_big) / t / 1e6
    t = median_time(lambda: _rans_mt_encode(grid_big), iters=3)
    speed["rans_mt_MBps"] = len(grid_big) / t / 1e6
    t = median_time(lambda: zlib.compressobj(9, zlib.DEFLATED, -15).compress(grid_big), iters=1)
    speed["deflate9_MBps"] = len(grid_big) / t / 1e6
    log(f"entropy on {planes.shape[0]} plane(s): rANS {speed['rans_MBps']:.1f} MB/s (mt "
        f"{speed['rans_mt_MBps']:.1f}), DEFLATE-9 {speed['deflate9_MBps']:.1f} MB/s")
    meta = codec_m.metadata_for(H, W)
    payload = _subband_payload(Archive(meta, codec_m.encode_plane(image)[0].cpu().numpy()))
    pieces, shift = _ctx_pieces(meta), _ctx_shift(meta)
    t = min_time(lambda: ctx_encode(payload, pieces, shift), iters=3)
    speed["ctx_MBps"] = len(payload) / t / 1e6
    ctx_size = len(ctx_encode(payload, pieces, shift))
    t = min_time(lambda: ctx_encode_mt(payload, pieces, shift), iters=3)
    speed["ctx_mt_MBps"] = len(payload) / t / 1e6
    mt_size = len(ctx_encode_mt(payload, pieces, shift))
    speed["ctx_mt_size_overhead_pct"] = 100.0 * (mt_size - ctx_size) / ctx_size
    log(f"ctx coder: serial {speed['ctx_MBps']:.1f} MB/s, chunk-parallel "
        f"{speed['ctx_mt_MBps']:.1f} MB/s (size {speed['ctx_mt_size_overhead_pct']:+.2f}%)")
    return speed


def e2e_rows(codec_m, image, batch, samples: int, device) -> dict:
    """End to end on the host clock, interleaved samples, then each path's
    decomposition and the device rANS alone."""
    from .ops import tpurans
    from .ops.entropy import rans_encode
    from .utils.container import _rans_mt_encode

    n = image.size
    nb = batch.size

    def e2e_rans():
        g, _ = codec_m.encode_plane(image)
        return _rans_mt_encode(g.cpu().numpy().tobytes())

    e2e_rans()
    fast_blob = codec_m.write_fast(image)
    codec_m.write_fast_batch(batch)
    ts_rans, ts_fast, ts_fastb = [], [], []
    for _ in range(samples):
        t0 = time.perf_counter()
        e2e_rans()
        ts_rans.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        codec_m.write_fast(image)
        ts_fast.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        codec_m.write_fast_batch(batch)
        ts_fastb.append(time.perf_counter() - t0)
    grid = codec_m.encode_plane(image)[0]
    grid_bytes = grid.cpu().numpy().tobytes()
    out = {
        "e2e_rans_mpix_s": n / float(np.median(ts_rans)) / 1e6,
        "e2e_fast_mpix_s": n / float(np.median(ts_fast)) / 1e6,
        "e2e_fast_batch_mpix_s": nb / float(np.median(ts_fastb)) / 1e6,
        "rans_tpu_payload_vs_host_rans": len(fast_blob) / len(rans_encode(grid_bytes)),
    }
    log(f"e2e (host clock, median of {samples}): encode + rANS-MT "
        f"{out['e2e_rans_mpix_s']:.1f} MPix/s, write_fast {out['e2e_fast_mpix_s']:.1f}, "
        f"write_fast_batch x{batch.shape[0]} {out['e2e_fast_batch_mpix_s']:.1f}; payload "
        f"{len(fast_blob)} B = {out['rans_tpu_payload_vs_host_rans']:.4f}x host rANS")

    def fetched(images) -> int:
        """The bytes write_fast(_batch) copies to the host: the tables,
        counts and states of every plane, then exactly the coded words."""
        imgs = torch.from_numpy(np.ascontiguousarray(images)).to(device)
        b = imgs.shape[0]
        g = codec_m.encode_plane(imgs)[0]
        freq, counts, states, _ = tpurans.encode_batch(g.reshape(b, -1))
        return 4 * (freq.numel() + counts.numel() + states.numel()) + 2 * int(counts.sum())

    decomp = {}
    for name, fn, walls, images, payload in (
        ("e2e_fast", lambda: codec_m.write_fast(image), ts_fast, image[None], len(fast_blob)),
        ("e2e_fast_batch", lambda: codec_m.write_fast_batch(batch), ts_fastb, batch,
         sum(len(b) for b in codec_m.write_fast_batch(batch))),
    ):
        dev_s, parts = device_seconds(fn, device)
        decomp[name] = {"wall_median_s": float(np.median(walls)), "device_s": dev_s,
                        "device_parts_s": parts, "link_bytes": fetched(images),
                        "payload_bytes": payload}
    dev_s, parts = device_seconds(lambda: codec_m.encode_plane(image), device)
    decomp["e2e_rans"] = {
        "wall_median_s": float(np.median(ts_rans)), "device_s": dev_s,
        "device_parts_s": parts,
        "host_entropy_s": min_time(lambda: _rans_mt_encode(grid_bytes), iters=3),
        "link_bytes": n,  # the uint8 grid crosses to the host
    }
    out["e2e_decomp"] = decomp
    for name, d in decomp.items():
        shown = "not measured" if d["device_s"] is None else f"{d['device_s'] * 1e3:.4f} ms"
        parts = ", ".join(f"{k} {v * 1e3:.4f} ms" for k, v in d["device_parts_s"].items())
        log(f"decomposition {name}: wall {d['wall_median_s'] * 1e3:.3f} ms, device {shown} "
            f"({parts}), to the host {d['link_bytes']} B"
            + (f", payload {d['payload_bytes']} B" if "payload_bytes" in d else "")
            + (f", host entropy {d['host_entropy_s'] * 1e3:.3f} ms"
               if "host_entropy_s" in d else ""))

    # The device rANS (X1) alone, on one plane's medium grid.
    sym = grid.reshape(1, -1)
    dev_s, _ = device_seconds(lambda: tpurans.encode_batch(sym), device)
    if dev_s is None:  # the CPU: its host time, under its own name
        out["rans_tpu_host_MBps"] = n / cuda_seconds_per_call(
            lambda: tpurans.encode_batch(sym), device) / 1e6
        log(f"device rANS stage: device time not measured "
            f"(host {out['rans_tpu_host_MBps']:.1f} MB/s)")
    else:
        out["rans_tpu_device_MBps"] = n / dev_s / 1e6
        log(f"device rANS stage (X1): {out['rans_tpu_device_MBps']:.1f} MB/s device time")
    return out


def link_rows(device) -> dict:
    """D2H and H2D MB/s from pageable host memory, the slope between 2 and
    16 MiB (min of 3 each); empty on the CPU."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return {}
    s1, s2 = 2 << 20, 16 << 20

    def d2h(size):
        x = torch.ones(size, dtype=torch.uint8, device=dev)
        x.cpu()
        return min_time(lambda: x.cpu(), iters=3)

    def h2d(size):
        hbuf = torch.ones(size, dtype=torch.uint8)

        def copy():
            hbuf.to(dev)
            torch.cuda.synchronize()

        copy()
        return min_time(copy, iters=3)

    out = {"d2h_MBps": (s2 - s1) / (d2h(s2) - d2h(s1)) / 1e6,
           "h2d_MBps": (s2 - s1) / (h2d(s2) - h2d(s1)) / 1e6}
    log(f"host<->device: D2H {out['d2h_MBps']:.1f} MB/s, H2D {out['h2d_MBps']:.1f} MB/s")
    return out


def level_sweep(rounds: int, device) -> dict:
    """L1-L8 lossless on one synthetic SWEEP_H x SWEEP_W plane, the engine
    the codec's ``auto`` picks, interleaved rounds."""
    from .models.codec import HGICodec

    plane = synthetic(SWEEP_W, SWEEP_H)
    n = plane.size
    codecs = {lv: HGICodec(lv, "lossless", device=device) for lv in SWEEP_LEVELS}
    x = torch.from_numpy(plane).to(device)
    engine = "cuda" if torch.device(device).type == "cuda" else "torch"
    samples = {lv: [] for lv in codecs}
    for _ in range(rounds):
        for lv, codec in codecs.items():
            t = cuda_seconds_per_call(lambda codec=codec: codec.encode_plane(x), device, 2 * n)
            samples[lv].append(n / t / 1e6)
    out = {}
    for lv, vals in samples.items():
        s = _spread(vals)
        out[str(lv)] = {"mpix_s": s["median_mpix_s"], "engine": engine,
                        "spread_pct": s["spread_pct"], "samples": s["samples"]}
        log(f"level_sweep L{lv} ({engine}): {s['median_mpix_s']:.1f} MPix/s "
            f"(spread {s['spread_pct']:.1f}%)")
    return out


def run(device="cuda", rounds: int = ENGINE_ROUNDS, details_path: str = DETAILS) -> dict:
    """Every row group; writes the details and returns the headline."""
    from .models.codec import HGICodec
    from .tools.chip_probe import card

    dev = require_device(device)
    if dev.type == "cuda":
        name = torch.cuda.get_device_name(0)
    else:
        name = "cpu"
    image = synthetic(W, H)
    batch = np.broadcast_to(image, (BATCH, H, W)).copy()
    log(f"device: {name} | image {W}x{H} x{BATCH} levels={LEVELS} rounds={rounds}")
    dbatch = torch.from_numpy(batch).to(dev)
    timer = StageTimer()
    with timer.stage("engines"):
        groups = engines_and_aux(dbatch, rounds, dev)
    with timer.stage("baseline"):
        base = scalar_baseline(image, dev)
    with timer.stage("lena"):
        sizes = lena_sizes(dev)
    codec_m = HGICodec(LEVELS, "medium", device=dev)
    with timer.stage("entropy"):
        entropy = entropy_rows(codec_m, image, batch)
    with timer.stage("e2e"):
        entropy.update(e2e_rows(codec_m, image, batch, min(E2E_SAMPLES, rounds), dev))
    with timer.stage("link"):
        entropy.update(link_rows(dev))
    with timer.stage("sweep"):
        sweep = level_sweep(min(SWEEP_ROUNDS, rounds), dev)
    log(f"group times:\n{timer}")

    headline_rows = {k: v for k, v in groups["engines"].items()
                     if k.endswith(f" {BATCH}x{H}x{W}")}
    headline_engine = max(headline_rows, key=lambda k: headline_rows[k]["median_mpix_s"])
    headline = headline_rows[headline_engine]
    details = {
        "device": name,
        "card": card() if dev.type == "cuda" else None,
        "config": {
            "w": W, "h": H, "batch": BATCH, "levels": LEVELS, "rounds": rounds,
            "methodology": (f"CUDA events, median of {REPEATS} calls after a warm-up, L2 "
                            f"flushed; rows = median of {rounds} interleaved rounds; device "
                            f"time by torch.profiler" if dev.type == "cuda" else
                            f"host clock (CPU), median of {REPEATS} calls"),
        },
        "headline_engine": headline_engine,
        "headline_mpix_s": headline["median_mpix_s"],
        "headline_spread_pct": headline["spread_pct"],
        **groups,
        "level_sweep": sweep,
        "baseline_scalar_cpp": base,
        "lena_container_bytes": sizes,
        "entropy_MBps": entropy,
        "group_seconds": dict(timer.seconds),
    }
    log(json.dumps(details, indent=2))
    os.makedirs(os.path.dirname(os.path.abspath(details_path)), exist_ok=True)
    with open(details_path, "w") as f:
        json.dump(details, f, indent=2)
    return details


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="python -m rustyhgi_tpu_torch.bench",
                                     description="benchmark of the PyTorch/CUDA port")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    parser.add_argument("--rounds", type=int, default=ENGINE_ROUNDS,
                        help="interleaved rounds of each timed row group")
    parser.add_argument("--details", default=DETAILS, help="JSON file of every row")
    args = parser.parse_args(argv)
    details = run(args.device, max(1, args.rounds), args.details)
    base = details["baseline_scalar_cpp"].get("encode_mpix_s")
    value = details["headline_mpix_s"]
    print(json.dumps({
        "metric": "encode_throughput_lossless_l4",
        "value": round(value, 1),
        "unit": "MPix/s",
        "vs_baseline": round(value / base, 2) if base else 0.0,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
