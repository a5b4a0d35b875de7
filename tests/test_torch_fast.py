"""The port's fast mode against the JAX package's, byte for byte.

``HGICodec.write_fast`` and ``write_fast_batch`` (K1's plain version and
X1's), ``write_thgi(fast=True)`` with codec 7 and codec 2, the readers of
both codecs, the host rule above ``MAX_SYMBOLS`` and the CLI's ``encode
--fast``.  Inputs come from numpy seeds; the tolerance is exact equality.
"""

import hashlib
import json
import os
import struct

import numpy as np
import pytest
import torch

from rustyhgi_tpu.cli import main as jax_main
from rustyhgi_tpu.models.codec import HGICodec as JCodec
from rustyhgi_tpu.ops import tpurans as jt
from rustyhgi_tpu.ops.quantizers import QuantizationLevel as JQL
from rustyhgi_tpu.utils import container as jc

import rustyhgi_tpu_torch as hgi
from rustyhgi_tpu_torch.cli import main
from rustyhgi_tpu_torch.ops import tpurans
from rustyhgi_tpu_torch.ops.quantizers import QuantizationLevel
from rustyhgi_tpu_torch.utils import container as tc
from rustyhgi_tpu_torch.utils.imageio import load_luma, save_gray

BASELINE = os.path.join(os.path.dirname(__file__), "golden", "baseline")
CPU = ["--device", "cpu"]
SHAPES = [(17, 29), (37, 53), (1, 7), (61, 83), (9, 1), (40, 56), (33, 65)]
PRESETS = ["lossless", "low", "medium", "high"]


def _image(shape, seed=0):
    """A smooth plane with noise, so the residuals look like a photo's."""
    rng = np.random.default_rng([seed, *shape])
    h, w = shape
    base = 100 + 50 * np.sin(np.arange(h)[:, None] / 5.0) * np.cos(np.arange(w)[None, :] / 7.0)
    return np.clip(base + rng.normal(0, 8, shape), 0, 255).astype(np.uint8)


@pytest.mark.parametrize("levels", range(7))
@pytest.mark.parametrize("pred", ["crossed", "left_top"])
@pytest.mark.parametrize("preset", PRESETS)
def test_write_fast_equals_jax(preset, pred, levels):
    shape = SHAPES[(levels + 3 * PRESETS.index(preset) + (pred == "left_top")) % len(SHAPES)]
    img = _image(shape, levels)
    blob = hgi.HGICodec(levels, preset, predictor=pred, device="cpu").write_fast(img)
    assert blob == JCodec(levels, preset, predictor=pred).write_fast(img), shape
    assert blob[29] == tc._CODEC_RANS_TPU and blob[28] == 0


def test_write_fast_batch_equals_per_plane_and_jax():
    quiet = np.zeros((48, 56), np.uint8)
    grad = ((np.arange(48)[:, None] * np.arange(56)[None, :]) & 0xFF).astype(np.uint8)
    busy = np.random.default_rng(51).integers(0, 256, (48, 56), dtype=np.uint8)
    batch = np.stack([quiet, busy, grad, _image((48, 56))])
    codec = hgi.HGICodec(4, "medium", device="cpu")
    blobs = codec.write_fast_batch(batch)
    assert blobs == JCodec(4, "medium").write_fast_batch(batch)
    assert blobs == [codec.write_fast(plane) for plane in batch]
    assert codec.write_fast_batch(batch[:0]) == []
    # A torch tensor on the codec's device takes the same path.
    assert codec.write_fast_batch(torch.from_numpy(batch)) == blobs


def test_write_fast_refuses_like_jax():
    codec, ref = hgi.HGICodec(3, "medium", device="cpu"), JCodec(3, "medium")
    for images, ours, theirs in ((np.zeros((0, 0), np.uint8), codec.write_fast, ref.write_fast),
                                 (np.zeros((4, 4), np.uint8), codec.write_fast_batch, None)):
        with pytest.raises(ValueError) as err:
            ours(images)
        if theirs is not None:
            with pytest.raises(ValueError) as want:
                theirs(images)
            assert str(err.value) == str(want.value)


@pytest.fixture(scope="module")
def lena():
    with open(os.path.join(BASELINE, "lena_l4_lossless.hgi"), "rb") as f:
        archive = hgi.read_hgi(f.read())
    return hgi.HGICodec(4, "lossless", device="cpu").decode(archive)


@pytest.mark.parametrize("preset", ["lossless", "medium"])
def test_lena_fast_digests(lena, preset):
    with open(os.path.join(BASELINE, "manifest.json")) as f:
        entry = json.load(f)[f"lena_l4_{preset}"]
    codec = hgi.HGICodec(4, preset, device="cpu")
    blob = codec.write_fast(lena)
    assert hashlib.sha256(blob).hexdigest() == entry["fast_thgi_sha256"]
    assert len(blob) == entry["fast_thgi_bytes"]
    archive = hgi.read_archive(blob, device="cpu")
    assert np.array_equal(archive.grid, codec.encode(lena).grid)
    decoded = codec.decode(archive)
    assert hashlib.sha256(decoded.tobytes()).hexdigest() == entry["decoded_sha256"]


def _pair(grid, preset=2, interp=0, scale=4):
    h, w = grid.shape
    ours = tc.Archive(tc.Metadata(QuantizationLevel(preset), interp, w, h, scale), grid)
    ref = jc.Archive(jc.Metadata(JQL(preset), interp, w, h, scale), grid)
    return ours, ref


def _grid(shape, seed=1):
    rng = np.random.default_rng([seed, *shape])
    return np.minimum(rng.geometric(0.3, shape) - 1, 255).astype(np.uint8)


ARCHIVES = [((17, 29), 0, 0, 3), ((37, 53), 2, 2, 4), ((1, 7), 1, 0, 8), ((64, 64), 3, 0, 0)]
LAYOUTS = {"rowmajor": ("rowmajor",), "subband": ("subband",), "both": ("rowmajor", "subband")}


def _assert_fast_readers_match(blob):
    ours, ref = tc.read_archive(blob, device="cpu"), jc.read_archive(blob)
    assert ours.metadata.pack() == ref.metadata.pack() and np.array_equal(ours.grid, ref.grid)
    for upto in range(ours.metadata.scale_level + 2):
        # A fast codec has no decodable prefix: the preview decodes in full.
        mine, theirs = tc.read_thgi_preview(blob, upto, device="cpu"), jc.read_thgi_preview(blob, upto)
        assert mine[3] == theirs[3] and np.array_equal(mine[1], theirs[1])
        assert len(mine[2]) == len(theirs[2])
        assert all(np.array_equal(a, b) for qa, qb in zip(mine[2], theirs[2]) for a, b in zip(qa, qb))


@pytest.mark.parametrize("codecs", [None, ["rans_tpu"], ["bitpack"], ["deflate", "bitpack"]],
                         ids=lambda c: "+".join(c) if c else "default")
@pytest.mark.parametrize("layout", LAYOUTS)
def test_write_thgi_fast_equals_jax(layout, codecs):
    for shape, preset, interp, scale in ARCHIVES:
        grid = _grid(shape)
        ours, ref = _pair(grid, preset, interp, scale)
        kwargs = dict(layouts=LAYOUTS[layout], fast=True, codecs=codecs)
        try:
            want = jc.write_thgi(ref, **kwargs)
        except ValueError as e:  # the subband layout at depth 0
            with pytest.raises(ValueError, match="no valid candidates"):
                tc.write_thgi(ours, device="cpu", **kwargs)
            assert "no valid candidates" in str(e)
            continue
        blob = tc.write_thgi(ours, device="cpu", **kwargs)
        assert blob == want, (shape, scale)
        tag = tc._CODEC_BITPACK if codecs and "rans_tpu" not in codecs else tc._CODEC_RANS_TPU
        assert blob[29] == tag
        assert blob[28] == (1 if layout == "subband" else 0)
        _assert_fast_readers_match(blob)
        if layout == "subband":
            meta, anchors, subbands = tc.read_thgi_subbands(blob, device="cpu")
            want_sb = jc.read_thgi_subbands(blob)
            assert np.array_equal(anchors, want_sb[1])
            assert all(np.array_equal(a, b) for qa, qb in zip(subbands, want_sb[2])
                       for a, b in zip(qa, qb))


def test_write_thgi_fast_large_payload_equals_jax():
    """A 1080x1920 grid: 2048 lanes of 1013 rows, 2025 pack blocks."""
    grid = _grid((1080, 1920), seed=5)
    ours, ref = _pair(grid)
    for codecs in (None, ["bitpack"]):
        blob = tc.write_thgi(ours, fast=True, codecs=codecs, device="cpu")
        assert blob == jc.write_thgi(ref, fast=True, codecs=codecs)
        assert np.array_equal(tc.read_thgi(blob, device="cpu").grid, grid)


@pytest.mark.parametrize("tag", [2, 7])
@pytest.mark.parametrize("body", [b"", b"\x00" * 7, b"\x00" * 16, b"\xff" * 700],
                         ids=["empty", "short", "zeros", "junk"])
def test_hostile_fast_bodies_rejected_like_jax(tag, body):
    meta = tc.Metadata(QuantizationLevel.LOW, 0, 2, 2, 1)
    blob = tc._thgi_frame(meta, 0, tag, 4, body)
    for ours, ref in ((lambda: tc.read_archive(blob, device="cpu"), lambda: jc.read_archive(blob)),
                      (lambda: tc.read_thgi_preview(blob, 1, device="cpu"),
                       lambda: jc.read_thgi_preview(blob, 1))):
        with pytest.raises(ValueError) as err:
            ours()
        with pytest.raises(ValueError) as want:
            ref()
        assert str(err.value) == str(want.value)


def test_bitpack_read_defaults_to_the_card():
    """Codec 2 unpacks with K7 on the reader's device, by default CUDA;
    without a card that raises instead of running the plain version."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present, so the default device works")
    ours, _ = _pair(_grid((17, 29)))
    blob = tc.write_thgi(ours, fast=True, codecs=["bitpack"], device="cpu")
    with pytest.raises((AssertionError, RuntimeError)):
        tc.read_thgi(blob)
    with pytest.raises((AssertionError, RuntimeError)):
        tc.write_thgi(ours, fast=True)


def test_max_symbols_rule_equals_jax(monkeypatch):
    """Above MAX_SYMBOLS pixels write_fast takes the host coders, in both
    packages alike (the constant made small in both)."""
    monkeypatch.setattr(tpurans, "MAX_SYMBOLS", 1000)
    monkeypatch.setattr(jt, "MAX_SYMBOLS", 1000)
    small, big = _image((20, 50)), _image((21, 50))
    codec, ref = hgi.HGICodec(3, "medium", device="cpu"), JCodec(3, "medium")
    at = codec.write_fast(small)
    assert at == ref.write_fast(small) and at[29] == tc._CODEC_RANS_TPU
    above = codec.write_fast(big)
    assert above == ref.write_fast(big)
    assert above[28] == 0 and above[29] not in (tc._CODEC_RANS_TPU, tc._CODEC_BITPACK)
    assert np.array_equal(tc.read_thgi(above).grid, codec.encode(big).grid)
    batch = np.stack([big, big // 2])
    assert codec.write_fast_batch(batch) == ref.write_fast_batch(batch)


@pytest.fixture
def png(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    save_gray("img.png", _image((37, 61), 13))
    return "img.png"


@pytest.mark.parametrize(
    "flags",
    [[], ["-q", "lossless"], ["--predictor", "left_top", "-l", "3", "-q", "high"], ["-l", "0"]],
    ids=["defaults", "lossless", "left_top-l3-high", "l0"],
)
def test_cli_encode_fast_equals_jax_cli(png, flags):
    assert jax_main(["encode", "-i", png, "-o", "ref.thgi", "--format", "thgi", "--fast", *flags]) == 0
    assert main(["encode", "-i", png, "-o", "ours.thgi", "--format", "thgi", "--fast",
                 *flags, *CPU]) == 0
    with open("ref.thgi", "rb") as a, open("ours.thgi", "rb") as b:
        ours = b.read()
        assert a.read() == ours
    assert ours[29] == tc._CODEC_RANS_TPU
    for extra in ([], ["--preview", "1"]):
        assert jax_main(["decode", "-i", "ref.thgi", "-o", "ref.png", *extra]) == 0
        assert main(["decode", "-i", "ours.thgi", "-o", "ours.png", *extra, *CPU]) == 0
        assert np.array_equal(load_luma("ours.png"), load_luma("ref.png")), extra


def test_cli_decodes_a_bitpack_thgi_like_jax(png):
    grid = _grid((37, 61))
    ours, _ = _pair(grid, scale=3)
    with open("b.thgi", "wb") as f:
        f.write(tc.write_thgi(ours, fast=True, codecs=["bitpack"], device="cpu"))
    assert jax_main(["decode", "-i", "b.thgi", "-o", "ref.png"]) == 0
    assert main(["decode", "-i", "b.thgi", "-o", "ours.png", *CPU]) == 0
    assert np.array_equal(load_luma("ours.png"), load_luma("ref.png"))


def test_fast_blob_header_is_the_thgi_layout():
    blob = hgi.HGICodec(2, "low", device="cpu").write_fast(_image((9, 11)))
    magic, = struct.unpack_from("<I", blob, 0)
    layout, codec, raw = struct.unpack_from("<BBQ", blob, 28)
    assert (magic, layout, codec, raw) == (tc.THGI_MAGIC, 0, tc._CODEC_RANS_TPU, 99)


@pytest.mark.parametrize("codecs,module,coder", [(None, "tpurans", "encode_bytes"),
                                                 (["bitpack"], "bitpack", "pack_bytes")],
                         ids=["rans_tpu", "bitpack"])
def test_fast_write_raises_the_device_coders_error(monkeypatch, codecs, module, coder):
    """A device coder's failure reaches the caller with its own message;
    the race drops only a coder that refuses its payload (ValueError)."""
    def fail(*args):
        raise RuntimeError(f"{coder} failed: CUDA error 700 (an illegal memory access)")

    monkeypatch.setattr(getattr(tc, module), coder, fail)
    ours, _ = _pair(_grid((17, 29)))
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        tc.write_thgi(ours, fast=True, codecs=codecs, device="cpu")


@pytest.mark.parametrize("layout", ["rowmajor", "subband"])
def test_cli_decode_entropy_decodes_once(png, monkeypatch, layout):
    """The CLI picks the decode from the header, so each payload is
    entropy-decoded once, whichever layout the archive holds."""
    ours, _ = _pair(_grid((37, 61)), scale=3)
    blob = tc.write_thgi(ours, layouts=(layout,), fast=True, device="cpu")
    assert tc.is_subband_thgi(blob) == (layout == "subband")
    with open("f.thgi", "wb") as f:
        f.write(blob)
    seen = []
    real = tc.read_thgi_payload

    def counted(*args, **kwargs):
        seen.append(1)
        return real(*args, **kwargs)

    monkeypatch.setattr(tc, "read_thgi_payload", counted)
    assert main(["decode", "-i", "f.thgi", "-o", "f.png", *CPU]) == 0
    assert len(seen) == 1
    want = hgi.HGICodec(3, "medium", device="cpu").decode(tc.read_thgi(blob, device="cpu"))
    assert np.array_equal(load_luma("f.png"), want)
