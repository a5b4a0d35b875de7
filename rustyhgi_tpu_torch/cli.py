"""Command-line interface.

Counterpart of ``rustyhgi_tpu/cli.py`` (reference: src/options.rs:13-65,
src/main.rs:41-128): ``encode``/``decode``/``test`` with the same flags,
defaults (level=4, quantizator=medium, case-insensitive) and printout,
plus ``--format hgi|thgi``, ``decode --preview N``, ``--engine
auto|cuda|torch`` (the codec's backend; the engines are bit-identical)
and ``--device`` (default ``cuda``).

``encode``, ``decode`` and ``test`` take ``--backend torch|oracle|native``
where the JAX CLI takes ``jax|oracle|native``, routed branch for branch
as there: ``torch`` is :class:`HGICodec` on ``--engine``/``--device``;
``oracle`` the per-pixel NumPy model (:mod:`.oracle`); ``native`` the
scalar C++ stand-in (``native/``, built with ``make -C native``), which
codes Crossed only, so ``left_top`` takes the oracle.  ``oracle`` and
``native`` run on the host and read neither ``--engine`` nor
``--device``, except where the JAX CLI too goes through the codec:
``--color``, ``decode`` of a ``.thgic`` and ``decode --preview``.  A
``native`` run without the library raises.

``encode --format thgi --fast`` writes ``HGICodec.write_fast``: the
grid entropy-coded on the device (codec 7), only coded bytes copied to
the host.  As in the JAX CLI, ``--fast`` with ``--format hgi`` writes the
``.hgi``, and ``test --fast`` writes ``write_archive``'s bytes.

``decode`` of a subband-layout ``.thgi`` reads the subbands straight into
the subband decode; any other archive goes through the grid.
``--preview N`` decodes only the coarsest N levels (of a ``.thgi``, only
the payload prefix they need).

``encode --color`` keeps RGB: three planes in one ``.thgic``
(:mod:`.utils.color`), which ``decode`` reads by its magic, ``--preview``
included.

``encode-tiled`` cuts a plane into ``--tile`` squares, each its own
archive, encodes them as one batch split over the devices of ``--mesh``
(every CUDA device by default, or ``--device``'s), and streams them to a
``.thgit`` v2 with a CRC a block; ``--resume`` continues an interrupted
file from its first missing or corrupt block, ``--shared-table`` codes
every block against one rANS table stored in the header, ``--fast``
codes chunks of 32 tiles on the device.  ``decode-tiled`` decodes the
blocks as one batch and crops the plane.

``bench`` runs the criterion suite (:mod:`.utils.benchsuite`) on the card
(``--device cpu`` for the plain version on the host) and prints what the
JAX CLI prints.

Usage::

    python -m rustyhgi_tpu_torch encode -i in.png -o out.thgi --format thgi
    python -m rustyhgi_tpu_torch encode -i in.png -o fast.thgi --format thgi --fast
    python -m rustyhgi_tpu_torch decode -i out.thgi -o roundtrip.png
    python -m rustyhgi_tpu_torch decode -i out.thgi -o preview.png --preview 2
    python -m rustyhgi_tpu_torch test img.png -l 4 -q lossless --device cuda
    python -m rustyhgi_tpu_torch test img.png -l 4 -q lossless --backend native
    python -m rustyhgi_tpu_torch encode -i rgb.png -o out.thgic --color --format thgi
    python -m rustyhgi_tpu_torch encode-tiled -i huge.png -o huge.thgit --tile 512 --format thgi --fast
    python -m rustyhgi_tpu_torch decode-tiled -i huge.thgit -o huge_roundtrip.png
    python -m rustyhgi_tpu_torch bench --batch 8 --samples 25
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from .models.codec import HGICodec
from .ops.native import native_decode, native_encode
from .ops.predictors import predictor_name_for_tag
from .ops.quantizers import QuantizationLevel
from .utils.color import THGIC_MAGIC
from .utils.container import (
    Archive,
    _magic,
    is_subband_thgi,
    read_archive,
    read_preview,
    read_thgi_subbands,
    write_archive,
    write_thgi,
)
from .oracle import oracle_decode, oracle_encode
from .utils.imageio import load_luma, save_gray
from .utils.profiling import span

_FAST_CHUNK = 32  # tiles a K1 + X1 call of encode-tiled --fast


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


def _add_backend_option(p: argparse.ArgumentParser) -> None:
    p.add_argument(
        "--backend",
        choices=("torch", "oracle", "native"),
        default="torch",
        help="torch = the codec on --engine/--device; oracle = the per-pixel "
        "NumPy model; native = the scalar C++ stand-in (Crossed only: "
        "left_top takes the oracle). oracle and native run on the host and "
        "ignore --engine and --device, but for color and previews, which "
        "go through the codec",
    )


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
    p.add_argument(
        "--color",
        action="store_true",
        help="keep RGB (3 planes in one .thgic container; lossless uses a "
        "reversible green-delta transform) instead of the reference's "
        "luma conversion",
    )


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


def _make_grid(image: np.ndarray, quant, args) -> np.ndarray:
    """The residual grid of ``image`` by the host backend ``--backend``
    (JAX ``_make_grid``; ``torch`` goes through the codec)."""
    if args.backend == "native" and args.predictor == "crossed":
        return native_encode(image, args.level, quant)
    # The C++ stand-in codes Crossed only: left_top takes the oracle, as in JAX.
    return oracle_encode(image, args.level, quant, predictor=args.predictor)


def _decode_grid(grid: np.ndarray, levels: int, predictor: str, args) -> np.ndarray:
    """The plane of a residual grid by the host backend ``--backend`` (JAX
    ``_decode_grid``)."""
    if args.backend == "native" and predictor == "crossed":
        return native_decode(grid, levels)
    return oracle_decode(grid, levels, predictor=predictor)


def _host_archive(image: np.ndarray, quant, args) -> Archive:
    """The archive of ``image`` by the host backend ``--backend``; the
    codec, on the CPU, only names its metadata."""
    meta = HGICodec(args.level, quant, predictor=args.predictor, device="cpu").metadata_for(
        *image.shape)
    return Archive(meta, _make_grid(image, quant, args))


def cmd_encode(args) -> int:
    """One image to one archive.  The command is the span ``cli.encode``,
    the root of its stages' spans: ``cli.load`` (the image read),
    :func:`encode_color`'s or the codec's, and ``cli.write`` (the output's
    write; its bytes)."""
    with span("cli.encode"):
        blob = _encode(args)
        with span("cli.write", len(blob)):
            with open(args.output, "wb") as f:
                f.write(blob)
    return 0


def _encode(args) -> bytes:
    quant = QuantizationLevel.parse(args.quantizator)
    if args.color:
        # Through the codec whatever --backend says, as in the JAX CLI.
        from .utils.color import encode_color, load_rgb

        codec = _codec(args, quant)
        with span("cli.load"):
            rgb = load_rgb(args.input)
        return encode_color(codec, rgb, fmt=args.format)
    with span("cli.load"):
        image = load_luma(args.input)
    fast = args.format == "thgi" and args.fast
    if args.backend != "torch":
        # The JAX CLI's _serialize: --fast codes the host grid with the
        # device rANS's plain version.
        archive = _host_archive(image, quant, args)
        return write_thgi(archive, fast=True, device="cpu") if fast else \
            write_archive(archive, args.format)
    if fast:
        return _codec(args, quant).write_fast(image)
    return write_archive(_codec(args, quant).encode(image), args.format)


def cmd_decode(args) -> int:
    with open(args.input, "rb") as f:
        data = f.read()
    if _magic(data) == THGIC_MAGIC:
        from .utils.color import decode_color, decode_color_preview, save_rgb

        if args.preview is not None:
            rgb = decode_color_preview(data, args.preview, args.device, args.engine)
        else:
            rgb = decode_color(data, args.device, args.engine)
        save_rgb(args.output, rgb)
        return 0
    if args.preview is not None:
        # Only the coarsest N levels: a 2**(levels-N)-downsampled preview.
        meta, anchors, subbands, upto = read_preview(data, args.preview, device=args.device)
        shape = (meta.height, meta.width)
        preview = _archive_codec(args, meta).decode_preview(anchors, subbands, shape, upto)
        save_gray(args.output, preview.cpu().numpy())
        return 0
    if args.backend != "torch":
        archive = read_archive(data, device="cpu")
        meta = archive.metadata
        plane = _decode_grid(archive.grid, meta.scale_level,
                             predictor_name_for_tag(meta.interpolation), args)
        save_gray(args.output, plane)
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
    quant = QuantizationLevel.parse(args.quantizator)
    image = load_luma(args.input)
    if args.backend == "torch":
        codec = _codec(args, quant)
        grid, _ = codec.encode_plane(image)
        decoded = codec.decode_plane(grid).cpu().numpy()
        archive = Archive(codec.metadata_for(*image.shape), grid.cpu().numpy())
    else:
        archive = _host_archive(image, quant, args)
        decoded = _decode_grid(archive.grid, args.level, args.predictor, args)
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


def _mesh_devices(args, mesh_shape):
    """The mesh's devices: every CUDA device for ``--device cuda``, else
    ``--device``'s one device in every place of the mesh."""
    import torch

    dev = torch.device(args.device)
    if dev == torch.device("cuda"):
        return None
    return [dev] * (mesh_shape[0] * mesh_shape[1] if mesh_shape else 1)


def cmd_encode_tiled(args) -> int:
    """The gigapixel path: independent tile archives in a ``.thgit`` v2.

    Header (with the shared rANS table under ``--shared-table``), then a
    block a tile in row-major tile order, each framed with its length and
    CRC32 and flushed as it is written, so that an interrupted job leaves
    a prefix ``--resume`` continues.  The command is the span
    ``cli.encode_tiled`` and the stages of both paths are spans in it;
    without ``--fast``, ``tiles.encode`` (the batch's grids),
    ``tiles.fetch`` (their copy to the host) and, a block each,
    ``tiles.race`` (``write_archive``), ``tiles.frame`` and ``tiles.write``.
    """
    with span("cli.encode_tiled"):
        return _encode_tiled(args)


def _encode_tiled(args) -> int:
    from .ops.entropy import normalized_freqs
    from .parallel.mesh import make_mesh
    from .parallel.sharded import encode_batch_sharded, pad_batch, tile_plane
    from .utils.container import thgit2_block_frame, thgit2_header, thgit2_resume_point

    quant = QuantizationLevel.parse(args.quantizator)
    shared = args.shared_table
    if shared and args.format != "thgi":
        raise ValueError("--shared-table requires --format thgi")
    with span("cli.load"):
        image = load_luma(args.input)
    mesh_shape = None
    if args.mesh:
        parts = args.mesh.split(",")
        if len(parts) != 2:
            raise ValueError("--mesh expects DATA,TILE (e.g. 4,2)")
        mesh_shape = (int(parts[0]), int(parts[1]))

    with span("tiles.split"):
        tiles, _ = tile_plane(image, (args.tile, args.tile))
    n_tiles = tiles.shape[0]
    h, w = image.shape

    start = 0
    mode = "wb"
    freqs = None
    if args.resume:
        try:
            with open(args.output, "rb") as f:
                prefix = thgit2_resume_point(f.read(), args.tile, w, h)
        except OSError:
            prefix = None
        if prefix is not None:
            start, off, freqs = prefix
            if shared and freqs is None:
                raise ValueError("--shared-table resume needs a v2 archive with a table")
            if start >= n_tiles:
                return 0  # already complete
            with open(args.output, "r+b") as f:
                f.truncate(off)  # drop a trailing partial or corrupt block
            mode = "ab"
            print(f"resuming at block {start}/{n_tiles}", file=sys.stderr)

    # The codec checks the engine and device before any work: a
    # configuration error must not reach the retry below.
    codec = _codec(args, quant)
    if args.fast and (args.format != "thgi" or shared):
        raise ValueError(
            "--fast requires --format thgi and is incompatible with "
            "--shared-table (the device coder builds per-tile tables)"
        )
    if args.fast:
        from .ops.tpurans import MAX_SYMBOLS

        if args.tile * args.tile > MAX_SYMBOLS:
            # write_fast_batch would take the host coders tile by tile
            # beyond the device coder's exact histogram.
            raise ValueError(
                f"--fast tile {args.tile} exceeds the device coder's "
                f"envelope (tile*tile must be <= {MAX_SYMBOLS}); use a "
                "smaller --tile or drop --fast"
            )
        # A chunk of tiles is one K1 and one X1 call; each block equals
        # write_fast of its tile, so --resume and decode-tiled compose.
        remaining = tiles[start:]
        with open(args.output, mode) as f:
            if mode == "wb":
                header = thgit2_header(args.tile, w, h, n_tiles, None)
                with span("tiles.write", len(header)):
                    f.write(header)
            for lo in range(0, remaining.shape[0], _FAST_CHUNK):
                with span("tiles.chunk"):
                    for b in codec.write_fast_batch(remaining[lo : lo + _FAST_CHUNK]):
                        with span("tiles.frame", len(b)):
                            block = thgit2_block_frame(b)
                        with span("tiles.write", len(block)):
                            f.write(block)
                            f.flush()  # a valid resumable prefix at every block
        return 0

    mesh = make_mesh(mesh_shape, _mesh_devices(args, mesh_shape))
    remaining = tiles[start:]
    padded, _ = pad_batch(remaining, mesh.size)
    # One retry, as the JAX CLI has, on the same mesh and engine: it never
    # moves to the CPU or to the plain version.
    for attempt in (1, 2):
        try:
            with span("tiles.encode"):
                grids, _, _ = encode_batch_sharded(
                    padded, args.level, quant, mesh=mesh, predictor=args.predictor,
                    engine=args.engine,
                )
            with span("tiles.fetch") as sp:
                grids_host = grids[: remaining.shape[0]].cpu().numpy()
                sp.nbytes = grids_host.nbytes
            break
        except Exception as e:
            if attempt == 2:
                raise
            print(f"encode attempt failed ({e}); retrying", file=sys.stderr)
    if shared and freqs is None:
        # A fresh shared run starts at tile 0, so this is the table of
        # every real tile; the padding tiles stay out of it, which keeps
        # the bytes independent of the mesh.
        freqs = normalized_freqs(np.bincount(grids_host.reshape(-1), minlength=256))

    with open(args.output, mode) as f:
        if mode == "wb":
            header = thgit2_header(args.tile, w, h, n_tiles, freqs)
            with span("tiles.write", len(header)):
                f.write(header)
        meta = codec.metadata_for(args.tile, args.tile)
        for grid in grids_host:
            with span("tiles.race") as sp:
                b = write_archive(Archive(meta, grid), args.format, freqs=freqs)
                sp.nbytes = len(b)
            with span("tiles.frame", len(b)):
                block = thgit2_block_frame(b)
            with span("tiles.write", len(block)):
                f.write(block)
                f.flush()  # a valid resumable prefix at every block
    return 0


def cmd_decode_tiled(args) -> int:
    from .parallel.sharded import untile_plane
    from .utils.container import parse_thgit

    with open(args.input, "rb") as f:
        data = f.read()
    # parse_thgit checks every v2 block's CRC and names a corrupt block.
    tile, width, height, blocks, freqs = parse_thgit(data)
    archives = [read_archive(block, freqs=freqs, device=args.device) for block in blocks]
    # The last block's depth and tag drive the decode, as in the JAX CLI.
    codec = _archive_codec(args, archives[-1].metadata)
    tiles = codec.decode_plane(np.stack([a.grid for a in archives])).cpu().numpy()
    save_gray(args.output, untile_plane(tiles, (height, width)))
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
    _add_backend_option(p)
    p.set_defaults(fn=cmd_encode)

    p = sub.add_parser("decode", help="decompress an archive to an image")
    p.add_argument("-i", "--input", required=True)
    p.add_argument("-o", "--output", required=True)
    _add_device_options(p)
    _add_backend_option(p)
    p.add_argument("--preview", type=int, default=None, metavar="N",
                   help="decode only the coarsest N levels (a 2**(levels-N)-"
                   "downsampled preview)")
    p.set_defaults(fn=cmd_decode)

    p = sub.add_parser("test", help="roundtrip + metrics (reference parity)")
    p.add_argument("input")
    p.add_argument("-s", "--suffix", default="")
    _add_encoding_options(p)
    _add_backend_option(p)
    p.set_defaults(fn=cmd_test)

    p = sub.add_parser(
        "encode-tiled",
        help="tile a large image into independent streams, encode them as "
        "one batch split over the devices, emit one block archive per tile",
    )
    p.add_argument("-i", "--input", required=True)
    p.add_argument("-o", "--output", required=True, help="output .thgit path")
    p.add_argument("--tile", type=int, default=512, help="square tile size")
    p.add_argument(
        "--mesh",
        type=str,
        default=None,
        help="device mesh shape as DATA,TILE (default: all devices on the data axis)",
    )
    p.add_argument(
        "--resume",
        action="store_true",
        help="continue an interrupted job from the first missing block",
    )
    p.add_argument(
        "--shared-table",
        action="store_true",
        help="entropy-code all blocks against one global rANS table "
        "stored once in the header (requires --format thgi)",
    )
    _add_encoding_options(p)
    p.set_defaults(fn=cmd_encode_tiled)

    p = sub.add_parser("decode-tiled", help="decode a tiled archive back to an image")
    p.add_argument("-i", "--input", required=True)
    p.add_argument("-o", "--output", required=True)
    _add_device_options(p)
    p.set_defaults(fn=cmd_decode_tiled)

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

    args = parser.parse_args(argv)
    try:
        return args.fn(args)
    except Exception as e:  # main.rs:130-133 error surface
        print(f"An error occured: {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
