"""The ranks of the multi-process tiled tier on one machine, for the tests
and ``chip_smoke.py``.

:func:`run_ranks` starts N worker processes of this module, which meet in
a gloo group on ``127.0.0.1`` at a free port, waits for them, and kills
every rank when one is late, so that a lost peer never hangs the caller.
Each rank codes each plane (``-i`` with its ``-q`` and ``-o``, in turn):
it encodes its share of the tiles with
:func:`..parallel.multihost.encode_tiled_multihost`, rank 0 writes the
``.thgit`` (:func:`..parallel.multihost.write_thgit_multihost`), and it
decodes the blocks back with :func:`..parallel.multihost.decode_tiled_multihost`
and checks the plane against the input within the preset's error bound::

    outs = run_ranks(["-i", "big.tif", "-q", "lossless", "-o", "big.thgit",
                      "--tile", "512", "--shared-table"], ranks=2, timeout=300)
    records = rank_records(outs)

Every rank prints one line ``rank {json}`` a plane: its share of the
tiles (``local_indices``), the SHA-256 of the gathered blocks, of the
shared table and of the ``.thgit`` bytes, ``dcn_payload_bytes`` beside
the compressed and raw bytes, the calls of K1 and K2 it made, its stage
times on the host clock (device encode with its copy to the host, host
coding, the block gather, the whole decode; the device's context and the
kernel library come up first, off the clock, through ``HGICodec.compile``)
and its worst error.

``--device cuda`` (the default) runs every rank on every CUDA device of
the machine, so two ranks share a one-card machine's card; ``--device
cpu --places N`` runs a rank's mesh on N places of the CPU.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import socket
import subprocess
import sys
import time
from typing import List, Sequence

import numpy as np

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(argv: Sequence[str], ranks: int, timeout: float = 120.0) -> List[str]:
    """Start ``ranks`` workers with ``argv`` (this module's options but
    ``--ranks``, ``--rank`` and ``--port``, which it adds), wait for all
    of them and return each one's standard
    output.  On a timeout every worker is killed and TimeoutError raised;
    a worker that exits nonzero raises RuntimeError with its output."""
    port = str(free_port())
    procs = [
        subprocess.Popen(
            [sys.executable, "-m", "rustyhgi_tpu_torch.tools.multihost_run", *argv,
             "--ranks", str(ranks), "--rank", str(r), "--port", port],
            cwd=_ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for r in range(ranks)
    ]
    outs = []
    try:
        deadline = time.monotonic() + timeout
        for p in procs:
            outs.append(p.communicate(timeout=max(1.0, deadline - time.monotonic()))[0])
    except subprocess.TimeoutExpired:
        raise TimeoutError(f"multihost ranks did not finish within {timeout} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise RuntimeError(f"rank {r} exited {p.returncode}:\n{out[-4000:]}")
    return outs


def rank_records(outs: Sequence[str]) -> List[dict]:
    """The ``rank {json}`` records of the workers' outputs, rank by rank,
    each rank's planes in turn."""
    return [
        json.loads(line.split(None, 1)[1])
        for out in outs
        for line in out.splitlines()
        if line.startswith("rank {")
    ]


def _sha(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


def _legs(args) -> List[tuple]:
    """(input, preset, output) of each plane the ranks code."""
    if not len(args.input) == len(args.quantizator) == len(args.output):
        raise SystemExit("give one -q and one -o for each -i")
    return list(zip(args.input, args.quantizator, args.output))


def worker(args) -> int:
    import torch

    from ..models.codec import HGICodec
    from ..ops import cuda_codec
    from ..ops.quantizers import QuantizationLevel, linear_error
    from ..parallel import multihost
    from ..utils.imageio import load_luma
    from ..utils.profiling import stage_clock

    legs = _legs(args)
    multihost.initialize(multihost.MultiHostConfig(
        f"127.0.0.1:{args.port}", args.ranks, args.rank))
    devices = None if args.device == "cuda" else [torch.device(args.device)] * args.places
    tile = (args.tile, args.tile)
    # The device's context and the kernel library come up before the clock.
    for dev in {str(d) for d in multihost.make_mesh(None, devices).devices.flat}:
        HGICodec(args.level, legs[0][1], args.predictor, device=dev).compile(tile)
    failed = 0
    for leg, (path, preset, output) in enumerate(legs):
        plane = load_luma(path)
        quant = QuantizationLevel.parse(preset)
        cuda_codec.encode_launches = cuda_codec.decode_launches = 0
        t0 = time.perf_counter()
        with stage_clock({"device_encode": (multihost, "_encode_share"),
                          "host_coding": (multihost, "_encode_one_block"),
                          "gather": (multihost, "_gather_blocks")}) as spent:
            res = multihost.encode_tiled_multihost(
                plane, tile, args.level, quant, fmt=args.format,
                shared_table=args.shared_table, predictor=args.predictor, devices=devices,
            )
        spent["encode"] = time.perf_counter() - t0
        blob = multihost.write_thgit_multihost(res, args.tile)
        if args.rank == 0:
            with open(output, "wb") as f:
                f.write(blob)
        t0 = time.perf_counter()
        decoded = multihost.decode_tiled_multihost(res.blocks, res.shape, tile, freqs=res.freqs,
                                                   devices=devices)
        spent["decode"] = time.perf_counter() - t0
        err = int(np.abs(decoded.astype(np.int64) - plane).max())
        record = {
            "rank": args.rank,
            "world": args.ranks,
            "leg": leg,
            "preset": preset,
            "local_indices": res.local_indices,
            "blocks_sha256": _sha(b"".join(res.blocks)),
            "table_sha256": None if res.freqs is None else _sha(res.freqs.tobytes()),
            "thgit_sha256": _sha(blob),
            "dcn_payload_bytes": res.dcn_payload_bytes,
            "compressed_bytes": res.compressed_bytes,
            "raw_bytes": int(plane.size),
            "launches": {"K1": cuda_codec.encode_launches, "K2": cuda_codec.decode_launches},
            "seconds": spent,
            "max_abs_err": err,
        }
        print("rank " + json.dumps(record), flush=True)
        if err > linear_error(quant):
            print(f"rank {args.rank}: {path} max |err| {err} above the bound", file=sys.stderr)
            failed = 1
    return failed


def main(argv=None) -> int:
    """One rank, as :func:`run_ranks` starts it."""
    p = argparse.ArgumentParser(prog="rustyhgi_tpu_torch.tools.multihost_run",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("-i", "--input", required=True, action="append",
                   help="a plane, any image file; repeat for more planes, coded in turn")
    p.add_argument("-q", "--quantizator", required=True, action="append", help="preset, one an -i")
    p.add_argument("-o", "--output", required=True, action="append",
                   help=".thgit that rank 0 writes, one an -i")
    p.add_argument("--tile", type=int, default=512)
    p.add_argument("-l", "--level", type=int, default=4)
    p.add_argument("--predictor", default="crossed", choices=["crossed", "left_top"])
    p.add_argument("--format", default="thgi", choices=["hgi", "thgi"])
    p.add_argument("--shared-table", action="store_true")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--places", type=int, default=1, help="CPU places a rank (--device cpu)")
    p.add_argument("--ranks", type=int, required=True)
    p.add_argument("--rank", type=int, required=True)
    p.add_argument("--port", type=int, required=True)
    return worker(p.parse_args(argv))


if __name__ == "__main__":
    sys.exit(main())
