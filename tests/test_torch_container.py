"""The port's .hgi container against the JAX package's, byte for byte."""

import os
import struct
import zlib

import numpy as np
import pytest

from rustyhgi_tpu.utils import container as jc
from rustyhgi_tpu.ops.quantizers import QuantizationLevel as JQL

from rustyhgi_tpu_torch.ops.quantizers import QuantizationLevel
from rustyhgi_tpu_torch.utils import container as tc

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
SYNTH = os.path.join(GOLDEN, "synthetic_16x12_l3_medium")


def _pair(grid, preset, interp, scale):
    h, w = grid.shape
    ours = tc.Archive(tc.Metadata(QuantizationLevel(preset), interp, w, h, scale), grid)
    ref = jc.Archive(jc.Metadata(JQL(preset), interp, w, h, scale), grid)
    return ours, ref


@pytest.mark.parametrize(
    "shape,preset,interp,scale",
    [((0, 0), 0, 0, 4), ((1, 7), 1, 2, 3), ((37, 53), 2, 0, 16), ((64, 64), 3, 1, 0),
     ((130, 68), 2, 2, 32)],
)
def test_write_hgi_bytes_equal_jax(shape, preset, interp, scale):
    rng = np.random.default_rng([1, *shape])
    # Mostly small residuals, like a real grid, so DEFLATE has work to do.
    grid = np.minimum(rng.geometric(0.3, shape) - 1, 255).astype(np.uint8)
    ours, ref = _pair(grid, preset, interp, scale)
    blob = tc.write_hgi(ours)
    assert blob == jc.write_hgi(ref)
    assert tc.write_archive(ours, "hgi") == blob
    back = jc.read_hgi(blob)
    assert back.metadata == ref.metadata and np.array_equal(back.grid, grid)
    mine = tc.read_archive(jc.write_hgi(ref))
    assert np.array_equal(mine.grid, grid)
    assert mine.metadata == ours.metadata


def test_deflate_best_matches_jax():
    rng = np.random.default_rng(2)
    for payload in (b"", b"\x00" * 5000, rng.integers(0, 256, 3000, np.uint8).tobytes(),
                    bytes(rng.integers(0, 4, 20000, np.uint8))):
        assert tc._deflate_best(payload) == jc._deflate_best(payload)


def test_synthetic_golden():
    want = np.load(SYNTH + "_grid.npy")
    with open(SYNTH + ".hgi", "rb") as f:
        blob = f.read()
    archive = tc.read_hgi(blob)
    assert np.array_equal(archive.grid, want)
    assert archive.metadata == tc.Metadata(QuantizationLevel.MEDIUM, 0, 16, 12, 3)
    assert tc.write_hgi(archive) == blob


@pytest.mark.parametrize("preset", ["lossless", "medium"])
def test_lena_goldens_parse_like_jax(preset):
    with open(os.path.join(GOLDEN, "baseline", f"lena_l4_{preset}.hgi"), "rb") as f:
        blob = f.read()
    ours, ref = tc.read_archive(blob), jc.read_archive(blob)
    assert np.array_equal(ours.grid, ref.grid)
    assert int(ours.metadata.quantization_level) == int(ref.metadata.quantization_level)
    assert ours.metadata.interpolation == ref.metadata.interpolation
    assert tc.write_hgi(ours) == blob


def _header(q=0, interp=0, w=4, h=4, scale=2):
    return struct.pack("<I", tc.HGI_MAGIC) + struct.pack("<IIIIQ", q, interp, w, h, scale)


@pytest.mark.parametrize(
    "data",
    [
        _header(w=1 << 16, h=1 << 15) + b"\x03\x00",  # beyond MAX_PLANE_PIXELS
        _header(scale=33) + b"\x03\x00",
        _header(w=0, h=5) + b"\x03\x00",
        _header()[:20],  # truncated metadata
        b"\x55\xa5",  # truncated magic
        b"GARBAGE!" * 8,
        _header() + zlib.compress(b"\x00" * 64)[2:-4],  # payload larger than declared
        _header() + zlib.compress(b"\x00" * 20)[2:-4],  # truncated payload
    ],
    ids=["bomb", "levels", "one-sided", "short-meta", "short-magic", "magic", "long", "short"],
)
def test_hostile_archives_rejected_like_jax(data):
    with pytest.raises(ValueError) as ours:
        tc.read_archive(data)
    with pytest.raises(ValueError) as ref:
        jc.read_archive(data)
    assert str(ours.value) == str(ref.value)


def test_grid_shape_must_match_metadata():
    meta = tc.Metadata(QuantizationLevel.LOW, 0, 5, 4, 2)
    with pytest.raises(ValueError, match="does not match"):
        tc.Archive(meta, np.zeros((5, 4), np.uint8))


def test_fast_codecs_write_and_read_like_jax():
    """The device-coded .thgi codecs 2 and 7 of the fast mode."""
    grid = np.arange(4, dtype=np.uint8).reshape(2, 2)
    archive = tc.Archive(tc.Metadata(QuantizationLevel.LOW, 0, 2, 2, 1), grid)
    ref = jc.Archive(jc.Metadata(JQL.LOW, 0, 2, 2, 1), grid)
    for tag, codecs in ((7, None), (2, ["bitpack"])):
        blob = tc.write_thgi(archive, fast=True, codecs=codecs, device="cpu")
        assert blob == jc.write_thgi(ref, fast=True, codecs=codecs) and blob[29] == tag
        for read in (lambda d: tc.read_archive(d, device="cpu"),
                     lambda d: tc.read_thgi(d, device="cpu")):
            assert np.array_equal(read(blob).grid, grid)
        # A body that is not the codec's stream is refused as JAX refuses it.
        junk = tc._thgi_frame(archive.metadata, 0, tag, 4, b"\x00" * 16)
        with pytest.raises(ValueError) as ours:
            tc.read_thgi_preview(junk, 1, device="cpu")
        with pytest.raises(ValueError) as want:
            jc.read_thgi_preview(junk, 1)
        assert str(ours.value) == str(want.value)


@pytest.mark.parametrize("magic", [0x7C61_A555, 0x7161_A555, 0x7161_A556],
                         ids=["thgic", "thgit-v1", "thgit-v2"])
def test_read_archive_refuses_other_containers_as_jax_does(magic):
    """A .thgic or .thgit is not an archive: its own reader takes it."""
    data = struct.pack("<I", magic) + b"\x00" * 32
    with pytest.raises(ValueError) as want:
        jc.read_archive(data)
    with pytest.raises(ValueError) as got:
        tc.read_archive(data, device="cpu")
    assert str(got.value) == str(want.value) == "incorrect magic number"


@pytest.mark.parametrize("fmt", ["thgic", "thgit", "png"])
def test_write_archive_refuses_other_formats_as_jax_does(fmt):
    meta = (QuantizationLevel.LOW, 0, 2, 2, 1)
    grid = np.zeros((2, 2), np.uint8)
    with pytest.raises(ValueError) as want:
        jc.write_archive(jc.Archive(jc.Metadata(JQL(int(meta[0])), *meta[1:]), grid), fmt)
    with pytest.raises(ValueError) as got:
        tc.write_archive(tc.Archive(tc.Metadata(*meta), grid), fmt)
    assert str(got.value) == str(want.value)
