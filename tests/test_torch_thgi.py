"""The port's ``.thgi`` container and host coders against the JAX package's.

Byte for byte: ``write_thgi`` over every layout and host codec, the
readers, the header guards, the rANS and ctx coders (native and
pure-Python), the LENA ``.thgi`` digests of the manifest, and the CLI's
``--format thgi``, ``decode`` and ``decode --preview``.  Inputs come from
numpy seeds; the tolerance is exact equality.
"""

import hashlib
import json
import os
import struct

import numpy as np
import pytest

from rustyhgi_tpu.cli import main as jax_main
from rustyhgi_tpu.ops import ctxcoder as jctx
from rustyhgi_tpu.ops import entropy as jentropy
from rustyhgi_tpu.ops import native as jnative
from rustyhgi_tpu.ops.quantizers import QuantizationLevel as JQL
from rustyhgi_tpu.utils import container as jc

import rustyhgi_tpu_torch as hgi
from rustyhgi_tpu_torch.cli import main
from rustyhgi_tpu_torch.ops import ctxcoder, entropy, native
from rustyhgi_tpu_torch.ops.quantizers import QuantizationLevel
from rustyhgi_tpu_torch.utils import container as tc
from rustyhgi_tpu_torch.utils.imageio import load_luma, save_gray

from conftest import synthetic_image

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
BASELINE = os.path.join(GOLDEN, "baseline")
CPU = ["--device", "cpu"]


def _grid(shape, seed=1):
    # Mostly small residuals, like a real grid, with the anchors' spread.
    rng = np.random.default_rng([seed, *shape])
    return np.minimum(rng.geometric(0.3, shape) - 1, 255).astype(np.uint8)


def _pair(grid, preset, interp, scale):
    h, w = grid.shape
    ours = tc.Archive(tc.Metadata(QuantizationLevel(preset), interp, w, h, scale), grid)
    ref = jc.Archive(jc.Metadata(JQL(preset), interp, w, h, scale), grid)
    return ours, ref


def _freqs(grid):
    return entropy.normalized_freqs(np.bincount(grid.reshape(-1), minlength=256) + 1)


def _sha(b: bytes) -> str:
    return hashlib.sha256(b).hexdigest()


def _same_error(fn_ours, fn_ref):
    with pytest.raises(Exception) as ours:
        fn_ours()
    with pytest.raises(Exception) as ref:
        fn_ref()
    assert type(ours.value) is type(ref.value)
    assert str(ours.value) == str(ref.value)


ARCHIVES = [((17, 29), 0, 0, 3), ((37, 53), 2, 2, 4), ((1, 7), 1, 0, 8), ((64, 64), 3, 0, 0),
            ((0, 0), 2, 0, 4)]
LAYOUTS = {"rowmajor": ("rowmajor",), "subband": ("subband",), "both": ("rowmajor", "subband")}
CODECS = [None, ["deflate"], ["rans"], ["ctx"], ["rans_shared"], ["ctx_mt"],
          ["deflate", "rans", "ctx"]]


def _assert_readers_match(blob, freqs=None):
    ours, ref = tc.read_thgi(blob, freqs), jc.read_thgi(blob, freqs)
    assert ours.metadata.pack() == ref.metadata.pack()
    assert np.array_equal(ours.grid, ref.grid)
    try:
        ref_sb = jc.read_thgi_subbands(blob, freqs)
    except ValueError as e:
        with pytest.raises(ValueError, match=str(e)):
            tc.read_thgi_subbands(blob, freqs)
    else:
        meta, anchors, subbands = tc.read_thgi_subbands(blob, freqs)
        assert meta.pack() == ref_sb[0].pack() and np.array_equal(anchors, ref_sb[1])
        assert all(np.array_equal(a, b) for qa, qb in zip(subbands, ref_sb[2])
                   for a, b in zip(qa, qb))
    for upto in range(ours.metadata.scale_level + 2):
        mine, theirs = tc.read_thgi_preview(blob, upto, freqs), jc.read_thgi_preview(blob, upto, freqs)
        assert mine[3] == theirs[3] and np.array_equal(mine[1], theirs[1])
        assert len(mine[2]) == len(theirs[2])
        assert all(np.array_equal(a, b) for qa, qb in zip(mine[2], theirs[2])
                   for a, b in zip(qa, qb))


@pytest.mark.parametrize("codecs", CODECS, ids=lambda c: "+".join(c) if c else "default")
@pytest.mark.parametrize("layout", LAYOUTS)
def test_write_thgi_bytes_equal_jax(layout, codecs):
    for shape, preset, interp, scale in ARCHIVES:
        grid = _grid(shape)
        ours, ref = _pair(grid, preset, interp, scale)
        freqs = _freqs(grid) if codecs == ["rans_shared"] else None
        kwargs = dict(layouts=LAYOUTS[layout], codecs=codecs, freqs=freqs)
        try:
            want = jc.write_thgi(ref, **kwargs)
        except ValueError as e:  # e.g. the subband layout at depth 0
            with pytest.raises(ValueError, match="no valid candidates"):
                tc.write_thgi(ours, **kwargs)
            assert "no valid candidates" in str(e)
            continue
        blob = tc.write_thgi(ours, **kwargs)
        assert blob == want, (shape, preset, scale)
        _assert_readers_match(blob, freqs)


@pytest.mark.parametrize("codec", ["rans_mt", "ctx_mt"])
def test_write_thgi_large_payload_equal_jax(codec):
    """A 1080x1920 grid: a 2 MB payload, past the two-chunk rANS threshold
    and at two ctx chunks."""
    grid = _grid((1080, 1920), seed=5)
    ours, ref = _pair(grid, 2, 0, 4)
    assert ctxcoder.ctx_mt_chunks(grid.size) == 2 and grid.size >= tc._MT_THRESHOLD
    blob = tc.write_thgi(ours, codecs=[codec])
    assert blob == jc.write_thgi(ref, codecs=[codec])
    assert blob[29] == tc._CODEC_NAMES[codec]
    _assert_readers_match(blob)


def test_write_archive_thgi_and_read_archive():
    grid = _grid((37, 53))
    ours, ref = _pair(grid, 2, 0, 4)
    blob = tc.write_archive(ours, "thgi")
    assert blob == jc.write_archive(ref, "thgi")
    assert np.array_equal(tc.read_archive(blob).grid, grid)
    freqs = _freqs(grid)
    shared = tc.write_archive(ours, "thgi", freqs=freqs)
    assert shared == jc.write_archive(ref, "thgi", freqs=freqs)
    assert np.array_equal(tc.read_archive(shared, freqs).grid, grid)
    _same_error(lambda: tc.write_archive(ours, "hgi", freqs=freqs),
                lambda: jc.write_archive(ref, "hgi", freqs=freqs))


def test_ctx_candidate_needs_the_native_coder(monkeypatch):
    """Without the native coder the default race drops the ctx candidate,
    in both packages alike; an explicit request still forces it."""
    grid = _grid((37, 53))
    ours, ref = _pair(grid, 2, 0, 4)
    monkeypatch.setattr(native, "available", lambda: False)
    monkeypatch.setattr(jnative, "available", lambda: False)
    blob = tc.write_thgi(ours)
    assert blob == jc.write_thgi(ref)
    assert blob[29] not in (tc._CODEC_CTX, tc._CODEC_CTX_MT)
    forced = tc.write_thgi(ours, codecs=["ctx"])
    assert forced == jc.write_thgi(ref, codecs=["ctx"])
    assert np.array_equal(tc.read_thgi(forced).grid, grid)


def _thgi_header(layout=1, codec=0, raw=None, w=5, h=4, scale=2, q=2):
    meta = struct.pack("<IIIIQ", q, 0, w, h, scale)
    if raw is None:
        raw = w * h if layout == 0 else 2 * 2 + 3 * (2 * 2 + 4 * 4)
    return struct.pack("<I", tc.THGI_MAGIC) + meta + struct.pack("<BBQ", layout, codec, raw)


@pytest.mark.parametrize(
    "data",
    [
        _thgi_header()[:30],  # truncated layout/codec/size
        _thgi_header()[:20],  # truncated metadata
        _thgi_header(raw=1 << 40),  # declared size beyond the layout's
        _thgi_header(layout=0, raw=21),
        _thgi_header(layout=2),  # unknown layout
        _thgi_header(codec=9) + b"\x00" * 8,  # unknown codec
        _thgi_header(w=1 << 16, h=1 << 15),  # beyond MAX_PLANE_PIXELS
        _thgi_header(scale=33),
        _thgi_header(w=0, h=5),
        _thgi_header(codec=1) + b"\x00" * 40,  # truncated rANS stream
        _thgi_header(codec=0) + b"\x03\x00",  # truncated DEFLATE payload
        _thgi_header(codec=4, layout=0, raw=20) + b"\x00" * 8,  # ctx needs subbands
        _thgi_header(codec=6) + b"\x09",  # implausible ctx_mt chunk count
        _thgi_header(codec=5) + b"\x00" * 40,  # shared table not given
    ],
    ids=["short-head", "short-meta", "oversized", "oversized-rowmajor", "layout", "codec",
         "bomb", "levels", "one-sided", "short-rans", "short-deflate", "ctx-rowmajor",
         "ctx-mt-chunks", "shared-no-freqs"],
)
def test_hostile_thgi_rejected_like_jax(data):
    _same_error(lambda: tc.read_archive(data), lambda: jc.read_archive(data))
    _same_error(lambda: tc.read_thgi_preview(data, 1), lambda: jc.read_thgi_preview(data, 1))


def test_python_coders_equal_native():
    assert native.available()
    rng = np.random.default_rng(9)
    payload = np.minimum(rng.geometric(0.2, 3000) - 1, 255).astype(np.uint8).tobytes()
    freqs = _freqs(np.frombuffer(payload, np.uint8))
    for table in (None, freqs):
        stream = entropy._py_rans_encode(payload, table)
        assert stream == native.native_rans_compress(payload, table)
        assert stream == jentropy._py_rans_encode(payload, table)
        assert entropy._py_rans_decode(stream, len(payload)) == payload
        assert native.native_rans_decompress(stream, len(payload)) == payload
    pieces = ctxcoder.piece_table((5, 6), [(5, 6), (10, 12), (20, 24)])
    sub = np.minimum(rng.geometric(0.3, sum(h * w for h, w, _ in pieces)) - 1, 255)
    sub = sub.astype(np.uint8).tobytes()
    for shift in (4, 5):
        stream = ctxcoder.py_ctx_encode(sub, pieces, shift)
        assert stream == native.native_ctx_compress(sub, pieces, shift)
        assert stream == jctx.py_ctx_encode(sub, pieces, shift)
        assert ctxcoder.py_ctx_decode(stream, pieces, shift) == sub
        assert native.native_ctx_decompress(stream, pieces, shift) == sub
    for k in (1, 2, 3):
        assert ctxcoder.split_pieces(pieces, k) == jctx.split_pieces(pieces, k)
        mt = ctxcoder.ctx_encode_mt(sub, pieces, 5, k=k)
        assert mt == jctx.ctx_encode_mt(sub, pieces, 5, k=k)
        assert ctxcoder.ctx_decode_mt(mt, pieces, 5) == sub


def test_normalized_freqs_and_chunk_counts_match_jax():
    rng = np.random.default_rng(4)
    for counts in (np.zeros(256, np.int64), rng.integers(0, 1000, 256),
                   np.eye(256, dtype=np.int64)[7] * 10**9,
                   np.bincount(rng.integers(0, 3, 100000), minlength=256)):
        assert np.array_equal(entropy.normalized_freqs(counts), jentropy.normalized_freqs(counts))
    for n in (0, 1, 1 << 19, 2_073_600, 2_088_960, 30 << 20):
        assert ctxcoder.ctx_mt_chunks(n) == jctx.ctx_mt_chunks(n)


@pytest.fixture(scope="module")
def manifest():
    with open(os.path.join(BASELINE, "manifest.json")) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def lena():
    """The LENA luma, recovered from its lossless golden on the CPU path."""
    with open(os.path.join(BASELINE, "lena_l4_lossless.hgi"), "rb") as f:
        archive = hgi.read_hgi(f.read())
    return hgi.HGICodec(4, "lossless", device="cpu").decode(archive)


@pytest.mark.parametrize("preset", ["lossless", "medium"])
def test_lena_thgi_digests(lena, manifest, preset):
    entry = manifest[f"lena_l4_{preset}"]
    codec = hgi.HGICodec(4, preset, device="cpu")
    blob = hgi.write_archive(codec.encode(lena), "thgi")
    assert _sha(blob) == entry["thgi_sha256"] and len(blob) == entry["thgi_bytes"]
    with open(os.path.join(BASELINE, f"lena_l4_{preset}.thgi"), "rb") as f:
        golden = f.read()
    assert blob == golden
    # Subband-direct decode and the grid path both give the manifest's plane.
    meta, anchors, subbands = hgi.read_thgi_subbands(golden)
    direct = codec.decode_subbands(anchors, subbands, (meta.height, meta.width)).numpy()
    assert _sha(direct.tobytes()) == entry["decoded_sha256"]
    assert _sha(codec.decode(hgi.read_archive(golden)).tobytes()) == entry["decoded_sha256"]
    # The subband encode feeds the same container bytes through the grid.
    anchors, subbands, _ = codec.encode_subbands(lena)
    grid = codec.assemble_grid(anchors, subbands, lena.shape).numpy()
    assert hgi.write_thgi(hgi.Archive(codec.metadata_for(*lena.shape), grid)) == golden
    # The preview of the golden is the full decode, sampled.
    meta, anchors, subbands, upto = hgi.read_thgi_preview(golden, 2)
    preview = codec.decode_preview(anchors, subbands, (meta.height, meta.width), upto).numpy()
    assert np.array_equal(preview, direct[::4, ::4])


def test_synthetic_thgi_golden():
    with open(os.path.join(GOLDEN, "synthetic_16x12_l3_medium.thgi"), "rb") as f:
        blob = f.read()
    want = np.load(os.path.join(GOLDEN, "synthetic_16x12_l3_medium_grid.npy"))
    archive = tc.read_archive(blob)
    assert np.array_equal(archive.grid, want)
    assert archive.metadata.pack() == jc.read_archive(blob).metadata.pack()
    assert tc.write_thgi(archive) == jc.write_thgi(jc.read_archive(blob))


@pytest.fixture
def png(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    rng = np.random.default_rng(12)
    img = synthetic_image(61, 37) // 2 + rng.integers(0, 16, (37, 61), dtype=np.uint8)
    save_gray("img.png", img)
    return "img.png"


@pytest.mark.parametrize(
    "flags",
    [[], ["-q", "lossless"], ["--predictor", "left_top", "-l", "3", "-q", "high"],
     ["-l", "0"], ["-l", "16", "-q", "low"]],
    ids=["defaults", "lossless", "left_top-l3-high", "l0", "l16"],
)
def test_cli_thgi_matches_jax_cli(png, capsys, flags):
    assert jax_main(["encode", "-i", png, "-o", "ref.thgi", "--format", "thgi", *flags]) == 0
    assert main(["encode", "-i", png, "-o", "ours.thgi", "--format", "thgi", *flags, *CPU]) == 0
    with open("ref.thgi", "rb") as a, open("ours.thgi", "rb") as b:
        assert a.read() == b.read()
    for extra in ([], ["--preview", "2"], ["--preview", "0"]):
        assert jax_main(["decode", "-i", "ref.thgi", "-o", "ref.png", *extra]) == 0
        assert main(["decode", "-i", "ref.thgi", "-o", "ours.png", *extra, *CPU]) == 0
        assert np.array_equal(load_luma("ours.png"), load_luma("ref.png")), extra
    capsys.readouterr()
    assert jax_main(["test", png, "--format", "thgi", "-s", "_t", *flags]) == 0
    ref = capsys.readouterr().out
    with open("img_t.thgi", "rb") as f:
        ref_blob = f.read()
    assert main(["test", png, "--format", "thgi", "-s", "_t", *flags, *CPU]) == 0
    assert capsys.readouterr().out == ref
    with open("img_t.thgi", "rb") as f:
        assert f.read() == ref_blob


def test_cli_preview_of_an_hgi_matches_jax_cli(png):
    assert main(["encode", "-i", png, "-o", "x.hgi", *CPU]) == 0
    assert jax_main(["decode", "-i", "x.hgi", "-o", "ref.png", "--preview", "1"]) == 0
    assert main(["decode", "-i", "x.hgi", "-o", "ours.png", "--preview", "1", *CPU]) == 0
    assert np.array_equal(load_luma("ours.png"), load_luma("ref.png"))
    assert load_luma("ours.png").shape == (5, 8)


def test_cli_fast_writes_the_jax_fast_thgi(png):
    assert jax_main(["encode", "-i", png, "-o", "ref.thgi", "--format", "thgi", "--fast"]) == 0
    assert main(["encode", "-i", png, "-o", "x.thgi", "--format", "thgi", "--fast", *CPU]) == 0
    with open("ref.thgi", "rb") as a, open("x.thgi", "rb") as b:
        assert a.read() == b.read()
    # --fast with the reference format writes the .hgi, as the JAX CLI does.
    assert jax_main(["encode", "-i", png, "-o", "ref.hgi", "--fast"]) == 0
    assert main(["encode", "-i", png, "-o", "x.hgi", "--fast", *CPU]) == 0
    with open("ref.hgi", "rb") as a, open("x.hgi", "rb") as b:
        assert a.read() == b.read()


@pytest.mark.parametrize("upto", [0, 1, 2, 3])
def test_cli_thgic_preview_matches_jax(png, upto):
    """A .thgic is read by its magic, --preview included."""
    from rustyhgi_tpu_torch.utils.color import load_rgb, save_rgb

    gray = load_luma(png)
    save_rgb("rgb.png", np.stack([gray, gray // 2 + 40, 255 - gray], 2))
    argv = ["encode", "-i", "rgb.png", "-o", "x.thgic", "--color", "--format", "thgi", "-l", "3"]
    assert jax_main(argv) == 0
    preview = ["--preview", str(upto)]
    assert jax_main(["decode", "-i", "x.thgic", "-o", "ref.png", *preview]) == 0
    assert main(["decode", "-i", "x.thgic", "-o", "ours.png", *preview, *CPU]) == 0
    assert np.array_equal(load_rgb("ours.png"), load_rgb("ref.png"))
    s = 1 << (3 - upto)
    assert load_rgb("ours.png").shape == (-(-37 // s), -(-61 // s), 3)