"""The port's tiled tier against ``rustyhgi_tpu.parallel`` and the JAX CLI on the CPU.

The JAX functions run on their own default mesh (the 8 virtual CPU
devices of ``tests/conftest.py``); the port's on meshes of 1, 2 and 4
CPU devices.  Every comparison is exact.
"""

import collections
import os
import struct

import numpy as np
import pytest
import torch

from rustyhgi_tpu.cli import main as jax_main
from rustyhgi_tpu.parallel import mesh as jmesh
from rustyhgi_tpu.parallel import sharded as js
from rustyhgi_tpu.utils import container as jc

from rustyhgi_tpu_torch.cli import main
from rustyhgi_tpu_torch.ops.quantizers import QuantizationLevel
from rustyhgi_tpu_torch.parallel import mesh as tm
from rustyhgi_tpu_torch.parallel import sharded as ts
from rustyhgi_tpu_torch.utils import container as tc
from rustyhgi_tpu_torch.utils import profiling
from rustyhgi_tpu_torch.utils.imageio import load_luma, save_gray

CPU = ["--device", "cpu"]


def _mesh(n, shape=None):
    return tm.make_mesh(shape, [torch.device("cpu")] * n)


def _np(t):
    return t.cpu().numpy()


# -- tile_plane, untile_plane, pad_batch, make_mesh ----------------------------


@pytest.mark.parametrize("hw,tile", [((37, 61), (16, 16)), ((64, 64), (32, 32)),
                                     ((5, 9), (8, 4)), ((100, 90), (32, 32))])
def test_tile_untile_pad_match_jax(hw, tile):
    plane = np.random.default_rng(hw[0]).integers(0, 256, hw, dtype=np.uint8)
    tiles, shape = ts.tile_plane(plane, tile)
    want_tiles, want_shape = js.tile_plane(plane, tile)
    assert shape == want_shape and np.array_equal(tiles, want_tiles)
    assert np.array_equal(ts.untile_plane(tiles, shape), plane)
    for multiple in (1, 3, 8):
        got, pad = ts.pad_batch(tiles, multiple)
        want, want_pad = js.pad_batch(tiles, multiple)
        assert pad == want_pad and np.array_equal(got, want)
    with pytest.raises(ValueError) as want:
        js.untile_plane(tiles[1:], shape)
    with pytest.raises(ValueError) as got:
        ts.untile_plane(tiles[1:], shape)
    assert str(got.value) == str(want.value)


def test_make_mesh_matches_jax():
    mesh = _mesh(8, (4, 2))
    assert mesh.devices.shape == (4, 2) and mesh.size == 8
    assert mesh.axis_names == (tm.DATA_AXIS, tm.TILE_AXIS) == ("data", "tile")
    assert _mesh(4).devices.shape == (4, 1)
    with pytest.raises(ValueError) as want:
        jmesh.make_mesh((3, 2))
    with pytest.raises(ValueError) as got:
        _mesh(8, (3, 2))
    assert str(got.value) == str(want.value) == "mesh shape (3, 2) != 8 devices"


def test_make_mesh_without_cuda_needs_named_devices(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tm.make_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ts.encode_batch_sharded(np.zeros((2, 8, 8), np.uint8), 2, QuantizationLevel.MEDIUM)


# -- the batch split ----------------------------------------------------------


@pytest.fixture(scope="module")
def batch():
    return np.random.default_rng(7).integers(0, 256, size=(8, 24, 40), dtype=np.uint8)


@pytest.mark.parametrize("predictor", ("crossed", "left_top"))
@pytest.mark.parametrize("preset", ("lossless", "medium"))
@pytest.mark.parametrize("n", (1, 2, 4))
def test_batch_sharded_matches_jax(batch, n, preset, predictor):
    q = QuantizationLevel.parse(preset)
    want = js.encode_batch_sharded(batch, 3, int(q), with_histogram=True, predictor=predictor)
    grids, recons, hist = ts.encode_batch_sharded(
        batch, 3, q, mesh=_mesh(n), with_histogram=True, predictor=predictor)
    assert np.array_equal(_np(grids), np.asarray(want[0]))
    assert np.array_equal(_np(recons), np.asarray(want[1]))
    assert hist.dtype == torch.int32 and np.array_equal(_np(hist), np.asarray(want[2]))
    assert np.array_equal(_np(ts.sharded_histogram(_np(grids), _mesh(n))), np.asarray(want[2]))
    decoded = ts.decode_batch_sharded(grids, 3, mesh=_mesh(n), predictor=predictor)
    want_decoded = js.decode_batch_sharded(np.asarray(want[0]), 3, predictor=predictor)
    assert np.array_equal(_np(decoded), np.asarray(want_decoded))
    assert np.array_equal(_np(decoded), _np(recons))


@pytest.mark.parametrize("engine", ("auto", "torch"))
@pytest.mark.parametrize("n", (1, 2, 4))
def test_subband_batch_sharded_matches_jax(batch, n, engine):
    q = QuantizationLevel.MEDIUM
    want_a, want_s = js.encode_subbands_batch_sharded(batch, 3, int(q))
    anchors, subbands = ts.encode_subbands_batch_sharded(batch, 3, q, mesh=_mesh(n), engine=engine)
    assert np.array_equal(_np(anchors), np.asarray(want_a))
    assert len(subbands) == len(want_s)
    for got, want in zip(subbands, want_s):
        for g, w in zip(got, want):
            assert np.array_equal(_np(g), np.asarray(w))
    decoded = ts.decode_subbands_batch_sharded(anchors, subbands, (24, 40), 3, mesh=_mesh(n),
                                               engine=engine)
    want_decoded = js.decode_subbands_batch_sharded(want_a, want_s, (24, 40), 3)
    assert np.array_equal(_np(decoded), np.asarray(want_decoded))


def test_histogram_none_unasked_and_the_int32_guard(batch):
    q = QuantizationLevel.MEDIUM
    assert ts.encode_batch_sharded(batch, 3, q, mesh=_mesh(2))[2] is None
    assert js.encode_batch_sharded(batch, 3, int(q))[2] is None
    # 2**31 pixels of stride 0: the guard must fire before anything is read.
    huge = np.broadcast_to(np.uint8(0), (1 << 16, 1 << 8, 1 << 7))
    with pytest.raises(ValueError) as want:
        js.encode_batch_sharded(huge, 3, int(q), with_histogram=True)
    with pytest.raises(ValueError) as got:
        ts.encode_batch_sharded(huge, 3, q, mesh=_mesh(2), with_histogram=True)
    assert str(got.value) == str(want.value)


def test_batch_not_a_multiple_of_the_mesh_is_refused(batch):
    with pytest.raises(ValueError, match="not divisible by the mesh's 3 devices"):
        ts.encode_batch_sharded(batch, 3, QuantizationLevel.MEDIUM, mesh=_mesh(3))
    with pytest.raises(ValueError):
        js.encode_batch_sharded(batch[:3], 3, int(QuantizationLevel.MEDIUM))


# -- the .thgit container -------------------------------------------------------


def _blocks(n=3):
    rng = np.random.default_rng(5)
    return [bytes(rng.integers(0, 256, 7 + i, dtype=np.uint8)) for i in range(n)]


def _v1(tile, w, h, blocks):
    head = struct.pack("<IIIII", jc.THGIT_MAGIC, tile, w, h, len(blocks))
    return head + b"".join(struct.pack("<Q", len(b)) + b for b in blocks)


def _v2(tile, w, h, blocks, freqs=None):
    return jc.thgit2_header(tile, w, h, len(blocks), freqs) + b"".join(
        jc.thgit2_block_frame(b) for b in blocks)


FREQS = np.full(256, 64, np.uint16)


@pytest.mark.parametrize("kind", ("v1", "v2", "v2-table"))
def test_parse_thgit_reads_jax_written_files(kind):
    blocks = _blocks()
    data = {"v1": lambda: _v1(16, 40, 30, blocks), "v2": lambda: _v2(16, 40, 30, blocks),
            "v2-table": lambda: _v2(16, 40, 30, blocks, FREQS)}[kind]()
    if kind != "v1":
        freqs = FREQS if kind == "v2-table" else None
        assert tc.thgit2_header(16, 40, 30, 3, freqs) == jc.thgit2_header(16, 40, 30, 3, freqs)
        assert tc.thgit2_block_frame(blocks[0]) == jc.thgit2_block_frame(blocks[0])
    tile, w, h, got, freqs = tc.parse_thgit(data)
    want = jc.parse_thgit(data)
    assert (tile, w, h, got) == want[:4] == (16, 40, 30, blocks)
    assert (freqs is None) == (want[4] is None)
    if freqs is not None:
        assert np.array_equal(freqs, want[4]) and np.array_equal(freqs, FREQS)


def _flip(data, at):
    return data[:at] + bytes([data[at] ^ 1]) + data[at + 1:]


MALFORMED = {
    "short": lambda v2: v2[:19],
    "short-v2": lambda v2: v2[:20],
    "bad-magic": lambda v2: struct.pack("<I", 0x7B61_A555) + v2[4:],
    "zero-tile": lambda v2: v2[:4] + struct.pack("<I", 0) + v2[8:],
    "cut-table": lambda v2: v2[:100],
    "cut-frame": lambda v2: v2[:21 + 512 + 5],
    "cut-block": lambda v2: v2[:-1],
    "crc": lambda v2: _flip(v2, len(v2) - 1),
    "v1-cut": lambda v2: _v1(16, 40, 30, _blocks())[:-2],
}


@pytest.mark.parametrize("case", MALFORMED)
def test_parse_thgit_raises_the_jax_errors(case):
    data = MALFORMED[case](_v2(16, 40, 30, _blocks(), FREQS))
    with pytest.raises(ValueError) as want:
        jc.parse_thgit(data)
    with pytest.raises(ValueError) as got:
        tc.parse_thgit(data)
    assert str(got.value) == str(want.value)


RESUMES = {
    "whole": lambda v2: v2,
    "cut-block": lambda v2: v2[:-3],
    "crc": lambda v2: _flip(v2, len(v2) - 1),
    "cut-table": lambda v2: v2[:300],
    "v1": lambda v2: _v1(16, 40, 30, _blocks()),
    "other-tile": lambda v2: v2[:4] + struct.pack("<I", 32) + v2[8:],
    "short": lambda v2: v2[:20],
}


@pytest.mark.parametrize("table", [None, FREQS], ids=["no-table", "table"])
@pytest.mark.parametrize("case", RESUMES)
def test_resume_point_matches_the_jax_cli(tmp_path, case, table):
    from rustyhgi_tpu.cli import _read_thgit_prefix

    data = RESUMES[case](_v2(16, 40, 30, _blocks(), table))
    path = tmp_path / "x.thgit"
    path.write_bytes(data)
    want = _read_thgit_prefix(str(path), 16, 40, 30)
    got = tc.thgit2_resume_point(data, 16, 40, 30)
    assert (got is None) == (want is None)
    if got is not None:
        assert got[:2] == want[:2]
        assert (got[2] is None) == (want[2] is None)
        assert got[2] is None or np.array_equal(got[2], want[2])


# -- the CLI: encode-tiled and decode-tiled --------------------------------------


@pytest.fixture
def plane_png(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    rng = np.random.default_rng(13)
    y, x = np.mgrid[0:100, 0:90]
    plane = ((x * 3 + y * 2) // 2 + rng.integers(0, 12, (100, 90))) % 256
    save_gray("plane.png", plane.astype(np.uint8))
    return "plane.png"


FORMATS = {
    "hgi": ["--format", "hgi"],
    "thgi": ["--format", "thgi"],
    "shared": ["--format", "thgi", "--shared-table"],
    "fast": ["--format", "thgi", "--fast"],
}
PREDICTORS = {"crossed-l3": ["-l", "3"], "left_top-l4": ["--predictor", "left_top", "-l", "4"]}


def _read(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("predictor", PREDICTORS)
@pytest.mark.parametrize("preset", ("lossless", "medium"))
@pytest.mark.parametrize("fmt", FORMATS)
def test_encode_tiled_matches_the_jax_cli(plane_png, fmt, preset, predictor):
    flags = ["--tile", "32", "-q", preset, *FORMATS[fmt], *PREDICTORS[predictor]]
    assert jax_main(["encode-tiled", "-i", plane_png, "-o", "ref.thgit", *flags]) == 0
    assert main(["encode-tiled", "-i", plane_png, "-o", "ours.thgit", *flags, *CPU]) == 0
    assert _read("ours.thgit") == _read("ref.thgit")
    assert jax_main(["decode-tiled", "-i", "ref.thgit", "-o", "ref.png"]) == 0
    assert main(["decode-tiled", "-i", "ref.thgit", "-o", "ours.png", *CPU]) == 0
    assert _read("ours.png") == _read("ref.png")
    err = np.abs(load_luma("ours.png").astype(np.int64) - load_luma(plane_png)).max()
    assert err <= (0 if preset == "lossless" else 20)


@pytest.mark.parametrize("mesh", ("2,2", "4,1"))
def test_encode_tiled_bytes_do_not_depend_on_the_mesh(plane_png, mesh):
    flags = ["--tile", "32", "-q", "medium", "--format", "thgi", "--shared-table", *CPU]
    assert main(["encode-tiled", "-i", plane_png, "-o", "one.thgit", *flags]) == 0
    assert main(["encode-tiled", "-i", plane_png, "-o", "mesh.thgit", "--mesh", mesh, *flags]) == 0
    assert _read("mesh.thgit") == _read("one.thgit")


# -- the program's spans over encode-tiled --fast ------------------------------


@pytest.fixture
def recorder():
    profiling.enable_spans()
    try:
        yield profiling
    finally:
        profiling.disable_spans()


@pytest.mark.parametrize("tile", (16, 32))
def test_encode_tiled_fast_records_its_stages(plane_png, recorder, tile):
    flags = ["--tile", str(tile), "--format", "thgi", "--fast", *CPU]
    assert main(["encode-tiled", "-i", plane_png, "-o", "on.thgit", *flags]) == 0
    got = profiling.spans()
    profiling.disable_spans()
    assert main(["encode-tiled", "-i", plane_png, "-o", "off.thgit", *flags]) == 0
    data = _read("on.thgit")
    assert data == _read("off.thgit")
    n = -(-100 // tile) * -(-90 // tile)
    chunks = -(-n // 32)  # the command's chunks of tiles
    per_chunk = ("tiles.chunk", "codec.h2d", "codec.k1_launch", "codec.x1_launch",
                 "codec.fetch_heads", "codec.fetch_words", "codec.frame")
    want = {"cli.encode_tiled": 1, "cli.load": 1, "tiles.split": 1, "tiles.frame": n,
            "tiles.write": n + 1}  # each block's, and the header's
    want.update({name: chunks for name in per_chunk})
    assert collections.Counter(s.name for s in got) == want
    root = next(s for s in got if s.name == "cli.encode_tiled")
    assert {s.request for s in got} == {root.id}
    ids = {s.id: s.name for s in got}
    for s in got:
        parent = ids.get(s.parent)
        if s.name.startswith("codec.") or s.name in ("tiles.frame", "tiles.write"):
            assert parent in ("tiles.chunk", "cli.encode_tiled")
        elif s is not root:
            assert parent == "cli.encode_tiled"

    def nbytes(name):
        return sum(s.nbytes for s in got if s.name == name)

    assert nbytes("codec.h2d") == n * tile * tile  # the tiles came from the host
    assert nbytes("tiles.write") == len(data)
    assert nbytes("tiles.frame") == len(data) - _block_offsets(data)[0] - 12 * n
    # Tables, counts and states of every tile; the coded words, u16 each
    # (none at all where each lane's state holds its few symbols).
    assert nbytes("codec.fetch_heads") > 0 and nbytes("codec.fetch_words") % 2 == 0


CODERS = {"coder.deflate": 4, "coder.rans": 2, "coder.ctx": 1}  # jobs a tile's race


@pytest.mark.parametrize("tile", (16, 32))
def test_encode_tiled_race_records_its_stages(plane_png, recorder, tile):
    from rustyhgi_tpu_torch.ops import native

    flags = ["--tile", str(tile), "--format", "thgi", *CPU]
    assert main(["encode-tiled", "-i", plane_png, "-o", "on.thgit", *flags]) == 0
    got = profiling.spans()
    profiling.disable_spans()
    assert main(["encode-tiled", "-i", plane_png, "-o", "off.thgit", *flags]) == 0
    data = _read("on.thgit")
    assert data == _read("off.thgit")
    n = -(-100 // tile) * -(-90 // tile)
    coders = dict(CODERS, **({} if native.available() else {"coder.ctx": 0}))
    want = {"cli.encode_tiled": 1, "cli.load": 1, "tiles.split": 1, "tiles.encode": 1,
            "codec.h2d": 1, "tiles.fetch": 1, "tiles.race": n, "tiles.frame": n, "tiles.write": n + 1,
            "thgi.payload": n, "thgi.wait": n}
    want.update({name: k * n for name, k in coders.items() if k})
    assert collections.Counter(s.name for s in got) == want
    root = next(s for s in got if s.name == "cli.encode_tiled")
    assert {s.request for s in got} == {root.id}
    names = {s.id: s.name for s in got}
    for s in got:
        parent = names.get(s.parent)
        if s.name.startswith(("coder.", "thgi.")):
            assert parent == "tiles.race" and s.thread == s.name.startswith("coder.")
        elif s.name == "codec.h2d":
            assert parent == "tiles.encode"
        elif s is not root:
            assert parent == "cli.encode_tiled" and not s.thread

    def nbytes(name):
        return sum(s.nbytes for s in got if s.name == name)

    offsets = _block_offsets(data)
    assert nbytes("tiles.fetch") == n * tile * tile  # the batch's grids, a byte a pixel
    assert nbytes("tiles.write") == len(data)
    assert nbytes("tiles.race") == nbytes("tiles.frame") == len(data) - offsets[0] - 12 * n
    # Each coder's job carries its payload: the grid, or the subband
    # layout's anchors and quads, which a tile of a multiple of 16 holds
    # unpadded at depth 4.
    assert nbytes("thgi.payload") == n * tile * tile
    for name, k in coders.items():
        assert nbytes(name) == k * n * tile * tile


def test_race_wins_add_up_to_the_tiles(plane_png):
    tc.RACE_WINS.clear()
    flags = ["--tile", "16", "--format", "thgi", *CPU]
    assert main(["encode-tiled", "-i", plane_png, "-o", "t.thgit", *flags]) == 0
    data = _read("t.thgit")
    heads = collections.Counter((data[off + 12 + 28], data[off + 12 + 29])
                                for off in _block_offsets(data))
    assert sum(tc.RACE_WINS.values()) == 7 * 6 == sum(heads.values())
    assert dict(tc.RACE_WINS) == dict(heads)
    tc.RACE_WINS.clear()
    assert main(["encode-tiled", "-i", plane_png, "-o", "f.thgit", "--fast", *flags]) == 0
    assert not tc.RACE_WINS  # one device coder: no race


@pytest.mark.parametrize("recorded", (True, False), ids=("recorder-on", "recorder-off"))
def test_program_ranges_enter_a_profile_only_inside_trace(plane_png, recorded):
    from torch.profiler import ProfilerActivity, profile

    flags = ["--tile", "32", "--format", "thgi", "--fast", *CPU]
    if recorded:
        profiling.enable_spans()
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            assert main(["encode-tiled", "-i", plane_png, "-o", "a.thgit", *flags]) == 0
        assert not [e.name for e in prof.events() if e.name.startswith("hgi.")]
        with profiling.trace(None, device="cpu") as prof:
            assert main(["encode-tiled", "-i", plane_png, "-o", "b.thgit", *flags]) == 0
        names = collections.Counter(e.name for e in prof.events() if e.name.startswith("hgi."))
        assert names["hgi.cli.encode_tiled"] == 1 and names["hgi.tiles.frame"] == 12
        assert {"hgi.tiles.split", "hgi.tiles.chunk", "hgi.codec.h2d", "hgi.codec.frame",
                "hgi.tiles.write"} <= set(names)
        with profile(activities=[ProfilerActivity.CPU]) as prof:  # and none after it
            assert main(["encode-tiled", "-i", plane_png, "-o", "c.thgit", *flags]) == 0
        assert not [e.name for e in prof.events() if e.name.startswith("hgi.")]
    finally:
        profiling.disable_spans()
    assert _read("a.thgit") == _read("b.thgit") == _read("c.thgit")
    assert len(profiling.spans()) == 0


def _block_offsets(data):
    """The byte offset of each block frame of a v2 file."""
    off = 21 + (512 if data[20] & 1 else 0)
    offsets = []
    while off < len(data):
        offsets.append(off)
        off += 12 + struct.unpack_from("<Q", data, off)[0]
    return offsets


@pytest.mark.parametrize("damage", ("truncate", "flip"))
@pytest.mark.parametrize("fmt", ("hgi", "shared", "fast"))
def test_resume_after_damage_equals_the_uninterrupted_file(plane_png, capsys, fmt, damage):
    flags = ["--tile", "32", "-q", "medium", *FORMATS[fmt], *CPU]
    assert main(["encode-tiled", "-i", plane_png, "-o", "whole.thgit", *flags]) == 0
    whole = _read("whole.thgit")
    at = _block_offsets(whole)[5]
    # Halfway into block 5, or one byte of block 5 flipped.
    damaged = whole[:at + 20] if damage == "truncate" else _flip(whole, at + 20)
    with open("part.thgit", "wb") as f:
        f.write(damaged)
    with pytest.raises(ValueError) as err:
        tc.parse_thgit(damaged)
    assert "block 5/12" in str(err.value)
    capsys.readouterr()
    assert main(["encode-tiled", "-i", plane_png, "-o", "part.thgit", "--resume", *flags]) == 0
    assert "resuming at block 5/12" in capsys.readouterr().err
    assert _read("part.thgit") == whole
    assert jax_main(["encode-tiled", "-i", plane_png, "-o", "ref.thgit", *flags[:-2]]) == 0
    assert _read("ref.thgit") == whole


def test_resume_of_a_v1_file_starts_from_scratch(plane_png, capsys):
    flags = ["--tile", "32", "-q", "lossless", "--format", "thgi", *CPU]
    assert main(["encode-tiled", "-i", plane_png, "-o", "whole.thgit", *flags]) == 0
    _, w, h, blocks, _ = tc.parse_thgit(_read("whole.thgit"))
    with open("old.thgit", "wb") as f:
        f.write(_v1(32, w, h, blocks[:4]))
    assert main(["encode-tiled", "-i", plane_png, "-o", "old.thgit", "--resume", *flags]) == 0
    assert "resuming" not in capsys.readouterr().err
    assert _read("old.thgit") == _read("whole.thgit")
    assert main(["decode-tiled", "-i", "whole.thgit", "-o", "a.png", *CPU]) == 0
    with open("v1.thgit", "wb") as f:
        f.write(_v1(32, w, h, blocks))
    assert main(["decode-tiled", "-i", "v1.thgit", "-o", "b.png", *CPU]) == 0
    assert _read("a.png") == _read("b.png")


REFUSALS = {
    "fast-hgi": ["--fast", "--format", "hgi"],
    "fast-shared": ["--fast", "--format", "thgi", "--shared-table"],
    "shared-hgi": ["--shared-table"],
    "mesh-form": ["--mesh", "4"],
    # tile * tile > 2**24: caught by the guard before any encode.
    "fast-tile": ["--fast", "--format", "thgi", "--tile", "4097"],
}


@pytest.mark.parametrize("case", REFUSALS)
def test_refusals_give_the_jax_messages(plane_png, capsys, case):
    argv = ["encode-tiled", "-i", plane_png, "-o", "x.thgit", *REFUSALS[case]]
    assert jax_main(argv) == 1
    want = capsys.readouterr().err
    assert main([*argv, *CPU]) == 1
    assert capsys.readouterr().err == want
    assert want.startswith("An error occured: ")


def test_corrupt_block_is_named_by_decode_tiled(plane_png, capsys):
    assert main(["encode-tiled", "-i", plane_png, "-o", "x.thgit", "--tile", "32", *CPU]) == 0
    data = _read("x.thgit")
    with open("x.thgit", "wb") as f:
        f.write(_flip(data, _block_offsets(data)[2] + 15))
    assert jax_main(["decode-tiled", "-i", "x.thgit", "-o", "ref.png"]) == 1
    want = capsys.readouterr().err
    assert main(["decode-tiled", "-i", "x.thgit", "-o", "x.png", *CPU]) == 1
    assert capsys.readouterr().err == want == "An error occured: CRC mismatch in block 2/12\n"


def test_one_retry_on_the_same_mesh(plane_png, capsys, monkeypatch):
    flags = ["--tile", "32", "-q", "medium", *CPU]
    assert main(["encode-tiled", "-i", plane_png, "-o", "clean.thgit", *flags]) == 0
    real = ts.encode_batch_sharded
    seen = []

    def flaky(*args, **kw):
        seen.append(kw["mesh"])
        if len(seen) == 1:
            raise RuntimeError("transient")
        return real(*args, **kw)

    monkeypatch.setattr(ts, "encode_batch_sharded", flaky)
    capsys.readouterr()
    assert main(["encode-tiled", "-i", plane_png, "-o", "x.thgit", *flags]) == 0
    assert capsys.readouterr().err == "encode attempt failed (transient); retrying\n"
    assert seen[0] is seen[1] and seen[0].devices.flat[0] == torch.device("cpu")
    assert _read("x.thgit") == _read("clean.thgit")
    seen.clear()
    monkeypatch.setattr(ts, "encode_batch_sharded",
                        lambda *a, **kw: (_ for _ in ()).throw(RuntimeError("sticky")))
    assert main(["encode-tiled", "-i", plane_png, "-o", "y.thgit", *flags]) == 1
    err = capsys.readouterr().err
    assert err.count("retrying") == 1 and err.endswith("An error occured: sticky\n")


def test_tiled_without_a_card_exits_1(plane_png, capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert main(["encode-tiled", "-i", plane_png, "-o", "x.thgit", "--tile", "32"]) == 1
    assert "CUDA is not available" in capsys.readouterr().err
    assert not os.path.exists("x.thgit")
