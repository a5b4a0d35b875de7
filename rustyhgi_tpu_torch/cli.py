"""Command-line interface.

Counterpart of ``rustyhgi_tpu/cli.py`` (reference: src/options.rs:13-65,
src/main.rs:41-128): ``encode``/``decode``/``test`` with the same flags,
defaults (level=4, quantizator=medium, case-insensitive) and printout,
plus ``--format hgi|thgi``, ``decode --preview N``, ``--engine
auto|cuda|torch`` (the codec's backend; the engines are bit-identical)
and ``--device`` (default ``cuda``).

``encode --format thgi --fast`` writes ``HGICodec.write_fast``: the
grid entropy-coded on the device (codec 7), only coded bytes copied to
the host.  As in the JAX CLI, ``--fast`` with ``--format hgi`` writes the
``.hgi``, and ``test --fast`` writes ``write_archive``'s bytes.

``decode`` of a subband-layout ``.thgi`` reads the subbands straight into
the subband decode; any other archive goes through the grid.
``--preview N`` decodes only the coarsest N levels (of a ``.thgi``, only
the payload prefix they need).

``bench`` runs the criterion suite (:mod:`.utils.benchsuite`) on the card
(``--device cpu`` for the plain version on the host) and prints what the
JAX CLI prints.

What the port does not have yet exits with 1 and names the ROADMAP
item that ports it: ``--color``, and the ``encode-tiled`` and
``decode-tiled`` commands.

Usage::

    python -m rustyhgi_tpu_torch encode -i in.png -o out.thgi --format thgi
    python -m rustyhgi_tpu_torch encode -i in.png -o fast.thgi --format thgi --fast
    python -m rustyhgi_tpu_torch decode -i out.thgi -o roundtrip.png
    python -m rustyhgi_tpu_torch decode -i out.thgi -o preview.png --preview 2
    python -m rustyhgi_tpu_torch test img.png -l 4 -q lossless --device cuda
    python -m rustyhgi_tpu_torch bench --batch 8 --samples 25
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from .models.codec import HGICodec
from .ops.predictors import predictor_name_for_tag
from .ops.quantizers import QuantizationLevel
from .utils.container import (
    THGIC_MAGIC,
    Archive,
    _magic,
    is_subband_thgi,
    read_archive,
    read_preview,
    read_thgi_subbands,
    write_archive,
)
from .utils.imageio import load_luma, save_gray

# Flags and commands of the JAX CLI that this port does not have yet, with
# the ROADMAP Queue 1 item that ports each.
_UNPORTED_FLAGS = (("color", "--color", 10),)
_UNPORTED_COMMANDS = {"encode-tiled": 11, "decode-tiled": 11}


def _not_ported(what: str, item: int) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP Queue 1 item {item})"
    )


def _add_device_options(p: argparse.ArgumentParser) -> None:
    p.add_argument(
        "--engine",
        choices=("auto", "cuda", "torch"),
        default="auto",
        help="auto = CUDA kernels on a CUDA device, plain PyTorch on the "
        "CPU; cuda = the kernels only; torch = the plain version "
        "(all bit-identical)",
    )
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")


def _add_encoding_options(p: argparse.ArgumentParser) -> None:
    # Defaults per options.rs:55-64.
    p.add_argument("-l", "--level", type=int, default=4, help="pyramid depth")
    p.add_argument(
        "-q",
        "--quantizator",
        type=str,
        default="medium",
        help="lossless|low|medium|high (case-insensitive)",
    )
    _add_device_options(p)
    p.add_argument(
        "--format",
        choices=("hgi", "thgi"),
        default="hgi",
        help="container format (hgi = reference byte-compatible)",
    )
    p.add_argument(
        "--fast",
        action="store_true",
        help="with --format thgi: entropy-code on the device (throughput over size)",
    )
    p.add_argument(
        "--predictor",
        choices=("crossed", "left_top"),
        default="crossed",
        help="interpolation predictor (tagged in the archive; decode "
        "honors the tag)",
    )
    p.add_argument("--color", action="store_true", help="not ported yet")


def _refuse_unported(args) -> None:
    for attr, flag, item in _UNPORTED_FLAGS:
        if getattr(args, attr, False):
            raise _not_ported(flag, item)


def _codec(args, quant=QuantizationLevel.MEDIUM) -> HGICodec:
    return HGICodec(
        getattr(args, "level", 4), quant, predictor=getattr(args, "predictor", "crossed"),
        backend=args.engine, device=args.device,
    )


def _archive_codec(args, meta) -> HGICodec:
    """The codec an archive's metadata names: its depth and predictor."""
    return HGICodec(
        meta.scale_level, predictor=predictor_name_for_tag(meta.interpolation),
        backend=args.engine, device=args.device,
    )


def cmd_encode(args) -> int:
    _refuse_unported(args)
    quant = QuantizationLevel.parse(args.quantizator)
    codec = _codec(args, quant)
    image = load_luma(args.input)
    if args.format == "thgi" and args.fast:
        blob = codec.write_fast(image)
    else:
        blob = write_archive(codec.encode(image), args.format)
    with open(args.output, "wb") as f:
        f.write(blob)
    return 0


def cmd_decode(args) -> int:
    with open(args.input, "rb") as f:
        data = f.read()
    if _magic(data) == THGIC_MAGIC:
        raise _not_ported(".thgic", 10)
    if args.preview is not None:
        # Only the coarsest N levels: a 2**(levels-N)-downsampled preview.
        meta, anchors, subbands, upto = read_preview(data, args.preview, device=args.device)
        shape = (meta.height, meta.width)
        preview = _archive_codec(args, meta).decode_preview(anchors, subbands, shape, upto)
        save_gray(args.output, preview.cpu().numpy())
        return 0
    if is_subband_thgi(data):
        # A subband-layout .thgi feeds the subband decode directly.
        meta, anchors, subbands = read_thgi_subbands(data, device=args.device)
        shape = (meta.height, meta.width)
        image = _archive_codec(args, meta).decode_subbands(anchors, subbands, shape)
        save_gray(args.output, image.cpu().numpy())
        return 0
    archive = read_archive(data, device=args.device)
    # The archive's scale_level and interpolation tag drive the decode.
    save_gray(args.output, _codec(args).decode(archive))
    return 0


def cmd_test(args) -> int:
    # Mirrors main.rs:73-120: roundtrip, print metrics, write .png + archive.
    _refuse_unported(args)
    quant = QuantizationLevel.parse(args.quantizator)
    image = load_luma(args.input)
    codec = _codec(args, quant)
    grid, _ = codec.encode_plane(image)
    decoded = codec.decode_plane(grid).cpu().numpy()
    archive = Archive(codec.metadata_for(*image.shape), grid.cpu().numpy())
    # --fast is ignored here, as in the JAX CLI: the archive is write_archive's.
    blob = write_archive(archive, args.format)

    diff = image.astype(np.int64) - decoded.astype(np.int64)
    uncompressed = image.size
    sd = int((diff**2).sum()) // uncompressed  # integer mean, main.rs:106
    print(f"Uncompressed: {uncompressed // 1024} kb")
    print(f"Compressed:   {len(blob) // 1024} kb")
    print(f"Ratio:        {uncompressed / len(blob):.2f}")
    print(f"SD:           {float(sd) ** 0.5:.2f}")

    stem = os.path.splitext(os.path.basename(args.input))[0] + args.suffix
    save_gray(stem + ".png", decoded)
    with open(stem + "." + args.format, "wb") as f:
        f.write(blob)
    return 0


def cmd_bench(args) -> int:
    from .utils.benchsuite import format_suite, run_suite_stats

    results = run_suite_stats(device=args.device, batch=args.batch, samples=args.samples)
    print(format_suite(results))
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="rustyhgi_tpu_torch",
        description="hierarchical grid interpolation image codec on PyTorch/CUDA",
    )
    sub = parser.add_subparsers(dest="command", required=True)

    p = sub.add_parser("encode", help="compress an image to an archive")
    p.add_argument("-i", "--input", required=True)
    p.add_argument("-o", "--output", required=True)
    _add_encoding_options(p)
    p.set_defaults(fn=cmd_encode)

    p = sub.add_parser("decode", help="decompress an archive to an image")
    p.add_argument("-i", "--input", required=True)
    p.add_argument("-o", "--output", required=True)
    _add_device_options(p)
    p.add_argument("--preview", type=int, default=None, metavar="N",
                   help="decode only the coarsest N levels (a 2**(levels-N)-"
                   "downsampled preview)")
    p.set_defaults(fn=cmd_decode)

    p = sub.add_parser("test", help="roundtrip + metrics (reference parity)")
    p.add_argument("input")
    p.add_argument("-s", "--suffix", default="")
    _add_encoding_options(p)
    p.set_defaults(fn=cmd_test)

    p = sub.add_parser(
        "bench",
        help="benchmark suite mirroring the reference's criterion benches",
    )
    p.add_argument("--batch", type=int, default=8)
    p.add_argument(
        "--samples",
        type=int,
        default=25,
        help="timing samples per bench (criterion sample_size parity)",
    )
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.set_defaults(fn=cmd_bench)

    for name in _UNPORTED_COMMANDS:
        sub.add_parser(name, help="not ported yet")

    args, extra = parser.parse_known_args(argv)
    try:
        if args.command in _UNPORTED_COMMANDS:
            raise _not_ported(args.command, _UNPORTED_COMMANDS[args.command])
        if extra:
            parser.error(f"unrecognized arguments: {' '.join(extra)}")
        return args.fn(args)
    except Exception as e:  # main.rs:130-133 error surface
        print(f"An error occured: {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
