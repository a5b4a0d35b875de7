"""Worked examples: the seven production usage patterns, on the port.

Counterpart of the repository's ``examples/serving.py``.  Every section is
self-contained; ``--device`` is ``cuda`` by default (the kernels) and
``cpu`` runs the plain version::

    python -m rustyhgi_tpu_torch.examples.serving [--device cpu]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

import rustyhgi_tpu_torch as hgi
from rustyhgi_tpu_torch.models.codec import load_exported


def section(title):
    print(f"\n=== {title}")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="the port's seven usage patterns")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    device = p.parse_args(argv).device
    rng = np.random.default_rng(0)
    image = (np.add.outer(np.arange(512), np.arange(768)) % 256).astype(np.uint8)

    section("1. Single-plane encode/decode with a warm-up")
    codec = hgi.HGICodec(levels=4, quantization="medium", device=device).compile(image.shape)
    archive = codec.encode(image)  # no first-call cost after the warm-up
    blob = hgi.write_archive(archive, "thgi")
    decoded = codec.decode(hgi.read_archive(blob, device=device))
    err = np.abs(image.astype(int) - decoded.astype(int)).max()
    print(f"{image.shape} -> {len(blob)} bytes, max err {err} (bound 20)")

    section("2. Subband fast path (encode-only pipelines)")
    anchors, subbands, _ = codec.encode_subbands(image)
    rt = codec.decode_subbands(anchors, subbands, image.shape).cpu().numpy()
    print("subband roundtrip max err:", np.abs(image.astype(int) - rt.astype(int)).max())

    section("3. Shipped artifacts (torch.export programs of K1 and K2)")
    enc_artifact = codec.export_encoder(image.shape)
    serve_encode = load_exported(enc_artifact)
    grid, _ = serve_encode(torch.from_numpy(image).to(device))
    print(f"artifact: {len(enc_artifact)} bytes; grid {tuple(grid.shape)}; equal to encode:",
          np.array_equal(grid.cpu().numpy(), archive.grid))

    section("4. Progressive preview (prefix decode)")
    from rustyhgi_tpu_torch.utils.container import read_thgi_preview

    meta, anchors_pv, sub_pv, upto = read_thgi_preview(blob, 2, device=device)
    pv = codec.decode_preview(anchors_pv, sub_pv, (meta.height, meta.width), upto).cpu().numpy()
    s = 1 << (meta.scale_level - upto)
    print(f"level-{upto} preview {pv.shape} == full[::{s}, ::{s}]:",
          np.array_equal(pv, decoded[::s, ::s]))

    section("5. Fastest encode-to-archive (device encode + device rANS)")
    fast_blob = codec.write_fast(image)
    fast_back = hgi.read_archive(fast_blob, device=device)
    print(f"write_fast: {len(fast_blob)} bytes; grid matches:",
          np.array_equal(fast_back.grid, archive.grid))

    section("6. Color (RGB) encode with reversible green-delta transform")
    rgb = np.stack([image, image // 2 + 7, image // 3 + 11], axis=2)
    cblob = hgi.encode_color(hgi.HGICodec(4, "lossless", device=device), rgb)
    print(f"{rgb.shape} -> {len(cblob)} bytes; lossless exact:",
          np.array_equal(hgi.decode_color(cblob, device=device), rgb))

    section("7. Batched data-parallel encode over a mesh")
    from rustyhgi_tpu_torch.parallel import (
        encode_batch_sharded, make_mesh, pad_batch, tile_plane, untile_plane,
    )

    big = rng.integers(0, 256, (1200, 1600), np.uint8)
    tiles, shape = tile_plane(big, (512, 512))
    mesh = make_mesh(devices=None if device == "cuda" else [torch.device("cpu")])
    padded, _ = pad_batch(tiles, mesh.size)
    grids, recons, _ = encode_batch_sharded(
        padded, 4, hgi.QuantizationLevel.LOSSLESS, mesh=mesh
    )
    back = untile_plane(recons[: tiles.shape[0]].cpu().numpy(), shape)
    print(f"{big.shape} via {tiles.shape[0]} tiles on {mesh.size} device(s): lossless exact = "
          f"{np.array_equal(back, big)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
