"""K1-K7 of one checkout, timed on the card in a process of their own.

    python rustyhgi_tpu_torch/tools/decode_times.py [--root DIR] [--json PATH]

``DIR`` (default: the checkout this file lies in) is the checkout whose
``rustyhgi_tpu_torch`` is imported and timed, so that two versions of
the port compare in one call on one card: unpack the other into a
directory and run parent, change, change, parent.  Only entry points that
every version of the port has are called: K1 ``cuda_codec.encode_plane``
(for reference: K3 codes the same residuals), K2 ``decode_plane``, K3
``encode_subbands`` (with recon and without, as the bench calls it), K4
``assemble_grid``, K5 ``decode_subbands`` and K5's preview
``decode_preview`` at ``upto`` 2, on smooth 1080x1920 planes (waves plus
sigma-6 noise from a seeded numpy generator) at L4, one plane and eight,
lossless and medium; each output is checked against the plain version's
or the recon.  On K1's grid as one stream: K6 ``bitpack.pack_blocks``,
K7 ``unpack_blocks``, and codec 2's ``pack_bytes`` and ``unpack_bytes``
(K6 or K7 with the copies and the host framing around them), each
checked against the plain version's bytes or the grid; where the version
has them, the compacting K6 ``pack_compact`` and K7 ``unpack_stream``;
and at one plane ``write_thgi(codecs=["bitpack"], fast=True)`` and
``read_thgi`` of its archive.

For each row: the median and range of ``2 * REPEATS`` CUDA-event-timed
calls with the L2 cache flushed (the wrapper's whole window,
``benchsuite.device_samples``; for a call that ends on the host, its
host time), and from ``torch.profiler`` the device time of one call, its
kernels' and its copies' apart, and the device kernels it launches
(:func:`device_parts`).  A fresh process has traced nothing before, so
its traces hold every record.  Each line ends with the card's name and
power limit; the last line is one JSON object ``{"decode_times": {row:
{...}}, ...}``.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

SEED = 20261016
REPEATS = 7
TRACE_ATTEMPTS = 6
SHAPES = ((1, 1080, 1920), (8, 1080, 1920))
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def device_parts(fn, repeats: int = REPEATS) -> tuple:
    """``fn`` under torch.profiler, ``repeats`` calls after a warm-up: the
    device ms of one call's kernels, of its copies and memsets, and the
    device kernels a call launches.  A trace whose counts are no multiple
    of ``repeats`` dropped records and is taken again; (None, None, None)
    when TRACE_ATTEMPTS did.  Drops come at random even early in a
    process: one trace in a few, a whole trace empty at times."""
    import torch
    from torch.autograd import DeviceType

    from rustyhgi_tpu_torch.utils import profiling

    fn()
    torch.cuda.synchronize()
    for _ in range(TRACE_ATTEMPTS):
        with profiling.trace(None, "cuda") as prof:
            for _ in range(repeats):
                fn()
        # Kernels, copies and memsets: not a span's mark on the card's row,
        # whose self time is the whole range (a ``--root`` version may
        # lack ``profiling.device_averages``).
        events = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
                  and not getattr(e, "is_user_annotation", False)
                  and not e.key.startswith("hgi.")]
        if events and all(e.count % repeats == 0 for e in events):
            copy = [("Memcpy" in e.key or "Memset" in e.key) for e in events]
            ms = [sum(e.self_device_time_total for e, c in zip(events, copy) if c == want)
                  / repeats / 1e3 for want in (False, True)]
            n = sum(e.count for e, c in zip(events, copy) if not c)
            return ms[0], ms[1], n / repeats
    return None, None, None


def device_trace(fn, repeats: int = REPEATS) -> tuple:
    """(device ms of one call, its kernels and copies; the device kernels
    a call launches, copies and memsets not counted), from
    :func:`device_parts`; (None, None) when the traces dropped records."""
    kernels, copies, n = device_parts(fn, repeats)
    return (None, None) if kernels is None else (kernels + copies, n)


def plane(rng, shape):
    """A smooth plane with mild noise (waves plus sigma 6)."""
    import numpy as np

    *lead, h, w = shape
    y = np.linspace(0.0, 6.0, h)[:, None]
    x = np.linspace(0.0, 9.0, w)[None, :]
    base = 128 + 60 * np.sin(y) * np.cos(x) + 30 * np.sin(3 * x + y)
    return np.clip(base + rng.normal(0.0, 6.0, (*lead, h, w)), 0, 255).astype(np.uint8)


def measure() -> dict:
    """The rows, printed one a line; returns ``{row: {...}}``."""
    import numpy as np
    import torch

    from rustyhgi_tpu_torch import HGICodec
    from rustyhgi_tpu_torch.ops import bitpack, cuda_codec, pyramid
    from rustyhgi_tpu_torch.ops.quantizers import QuantizationLevel, quantize_fn
    from rustyhgi_tpu_torch.utils.benchsuite import device_samples
    from rustyhgi_tpu_torch.utils.container import Archive, read_thgi, write_thgi

    if not torch.cuda.is_available():
        raise RuntimeError("decode_times needs a CUDA card: torch.cuda.is_available() is false")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True,
                          timeout=60).stdout.strip().splitlines()[0]
    rng = np.random.default_rng(SEED)
    rows = {}
    for shape in SHAPES:
        img = torch.from_numpy(plane(rng, shape)).to("cuda")
        hw = tuple(img.shape[-2:])
        for preset in (QuantizationLevel.LOSSLESS, QuantizationLevel.MEDIUM):
            q = quantize_fn(preset)
            table = None if q.identity else q.table
            grid, recon = cuda_codec.encode_plane(img, 4, table)
            anchors, subbands, _ = cuda_codec.encode_subbands(img, 4, table)
            layout = pyramid.encode_subbands(img, 4, table)
            flat = [layout[0], *(q for quads in layout[1] for q in quads)]

            def same_layout(got, with_recon):
                parts = [got[0], *(q for quads in got[1] for q in quads)]
                return (len(parts) == len(flat) and all(map(torch.equal, parts, flat))
                        and (torch.equal(got[2], recon) if with_recon else got[2] is None))

            stream = grid.reshape(-1)
            n = stream.numel()
            packed, widths, nb = bitpack.pack_plain(stream)
            blob = bitpack.finalize_packed(packed.cpu().numpy(), widths.cpu().numpy(), nb, n)
            expanded = torch.from_numpy(bitpack.expand_packed(blob, n)[0]).to("cuda")
            grid_bytes = stream.cpu().numpy()
            rows_bitpack = [
                ("K6 pack_blocks", lambda: bitpack.pack_blocks(stream),
                 lambda got: got[2] == nb and torch.equal(got[0], packed)
                 and torch.equal(got[1], widths)),
                ("K7 unpack_blocks", lambda: bitpack.unpack_blocks(expanded),
                 lambda got: torch.equal(got[:n], stream)),
                ("pack_bytes", lambda: bitpack.pack_bytes(grid_bytes, "cuda"),
                 lambda got: got == blob),
                ("unpack_bytes", lambda: bitpack.unpack_bytes(blob, n, "cuda"),
                 lambda got: np.array_equal(got, grid_bytes)),
            ]
            if hasattr(bitpack, "pack_compact"):  # the compacting K6 and K7
                pad = -(8 + (nb + 1) // 2) % 16  # as unpack_bytes places the body
                placed = torch.empty(pad + len(blob), dtype=torch.uint8, device="cuda")
                placed[pad:].copy_(torch.frombuffer(bytearray(blob), dtype=torch.uint8))
                body = placed[pad:]

                def compacted(got):
                    buf, head, start = got
                    total = int(buf[:8].view(torch.int64).item())
                    return torch.equal(buf[head : start + 128 * total], body)

                rows_bitpack += [
                    ("K6 pack_compact", lambda: bitpack.pack_compact(stream), compacted),
                    ("K7 unpack_stream", lambda: bitpack.unpack_stream(body, n),
                     lambda got: torch.equal(got, stream)),
                ]
            if shape[0] == 1:  # codec 2 of a .thgi, host clock
                archive = Archive(HGICodec(4, preset.name.lower()).metadata_for(*hw),
                                  grid_bytes.reshape(hw))
                thgi = write_thgi(archive, codecs=["bitpack"], fast=True, device="cuda")
                rows_bitpack += [
                    ("codec2 write_thgi", lambda: write_thgi(archive, codecs=["bitpack"],
                                                             fast=True, device="cuda"),
                     lambda got: got == thgi),
                    ("codec2 read_thgi", lambda: read_thgi(thgi, device="cuda"),
                     lambda got: np.array_equal(got.grid, archive.grid)),
                ]
            for name, fn, want in (
                ("K1", lambda: cuda_codec.encode_plane(img, 4, table),
                 lambda got: torch.equal(got[0], grid) and torch.equal(got[1], recon)),
                ("K3", lambda: cuda_codec.encode_subbands(img, 4, table),
                 lambda got: same_layout(got, True)),
                ("K3 no recon", lambda: cuda_codec.encode_subbands(img, 4, table, want_recon=False),
                 lambda got: same_layout(got, False)),
                ("K4", lambda: cuda_codec.assemble_grid(anchors, subbands, hw), grid),
                ("K2", lambda: cuda_codec.decode_plane(grid, 4), recon),
                ("K5", lambda: cuda_codec.decode_subbands(anchors, subbands, hw, 4), recon),
                ("K5 preview 2", lambda: cuda_codec.decode_preview(anchors, subbands[:2], hw, 4, 2),
                 recon[..., ::4, ::4]),
                *rows_bitpack,
            ):
                if not (want(fn()) if callable(want) else torch.equal(fn(), want)):
                    raise RuntimeError(f"{name} at {shape} {preset.name} differs from the plain version")
                kern, copies, launches = device_parts(fn)
                ev = [t * 1e3 for t in device_samples(fn, 2 * REPEATS, "cuda")]
                key = f"{name} {'x'.join(map(str, shape))} {preset.name.lower()}"
                dev = None if kern is None else kern + copies
                rows[key] = {"event_ms": statistics.median(ev), "event_min": min(ev),
                             "event_max": max(ev), "device_ms": dev, "kernels_ms": kern,
                             "copies_ms": copies, "device_launches": launches}
                shown = ("not measured" if dev is None else
                         f"{dev:.4f} ms (kernels {kern:.4f}, copies {copies:.4f}), "
                         f"{launches:g} launch(es)")
                print(f"decode-times {key} L4: event median {statistics.median(ev):.4f} ms "
                      f"[{min(ev):.4f}..{max(ev):.4f}], device {shown} [{card}]", flush=True)
    return {"decode_times": rows, "card": card, "device": torch.cuda.get_device_name(0)}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="decode_times", description=__doc__.splitlines()[0])
    parser.add_argument("--root", default=_ROOT, help="the checkout whose port is timed")
    parser.add_argument("--json", default=None, help="also write the result here")
    args = parser.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    result = measure()
    result["root"] = root
    if args.json:
        with open(args.json, "w") as f:
            json.dump(result, f)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
