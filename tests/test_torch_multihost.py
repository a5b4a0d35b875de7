"""The port's multi-process tiled tier against ``rustyhgi_tpu.parallel.multihost``.

The port's ranks are worker processes of
``rustyhgi_tpu_torch.tools.multihost_run`` that import only the port and
meet in a gloo group on ``127.0.0.1`` at a free port, each on a mesh of 4
CPU places; ``run_ranks`` kills every rank when one is late (120 s), so a
lost peer fails the test instead of hanging it.  The JAX functions run in
the pytest process on the 8 virtual CPU devices of ``tests/conftest.py``,
which is one process with as many devices as two ranks of 4.  Every
comparison is exact.
"""

import hashlib
import os
import struct
import zlib

import numpy as np
import pytest
import torch

from rustyhgi_tpu.ops.quantizers import QuantizationLevel as JQ
from rustyhgi_tpu.parallel import multihost as jm

from rustyhgi_tpu_torch.cli import main
from rustyhgi_tpu_torch.ops.quantizers import QuantizationLevel
from rustyhgi_tpu_torch.parallel import multihost as tm
from rustyhgi_tpu_torch.tools import multihost_run
from rustyhgi_tpu_torch.utils.imageio import save_gray

CPU4 = [torch.device("cpu")] * 4


def _plane64():
    xx, yy = np.meshgrid(np.arange(64), np.arange(64))
    return (((xx * 3 + yy * 2) // 4) % 256).astype(np.uint8)


def _sha(b: bytes) -> str:
    return hashlib.sha256(b).hexdigest()


def _ranks(tmp_path, plane, ranks, *flags):
    path = str(tmp_path / "plane.png")
    save_gray(path, plane)
    outs = multihost_run.run_ranks(
        ["-i", path, "-o", str(tmp_path / "out.thgit"), "--tile", "16", "-l", "3",
         "--device", "cpu", "--places", "4", *flags], ranks, timeout=120)
    records = multihost_run.rank_records(outs)
    assert [r["rank"] for r in records] == list(range(ranks))
    return records, (tmp_path / "out.thgit").read_bytes()


def _jax_thgit(plane, preset, fmt, shared, predictor="crossed"):
    res = jm.encode_tiled_multihost(plane, (16, 16), 3, preset, fmt=fmt, shared_table=shared,
                                    predictor=predictor)
    return res, jm.write_thgit_multihost(res, 16)


def test_two_ranks_lossless_shared_table_match_jax_and_encode_tiled(tmp_path):
    plane = _plane64()
    records, blob = _ranks(tmp_path, plane, 2, "-q", "lossless", "--shared-table")
    assert records[0]["local_indices"] == list(range(8))
    assert records[1]["local_indices"] == list(range(8, 16))
    for key in ("blocks_sha256", "table_sha256", "thgit_sha256"):
        assert records[0][key] == records[1][key] is not None
    jres, jblob = _jax_thgit(plane, JQ.LOSSLESS, "thgi", True)
    assert blob == jblob
    assert records[0]["thgit_sha256"] == _sha(jblob)
    assert records[0]["blocks_sha256"] == _sha(b"".join(jres.blocks))
    assert records[0]["table_sha256"] == _sha(jres.freqs.tobytes())
    for r in records:
        assert 0 < r["dcn_payload_bytes"] < r["raw_bytes"] == plane.size
        assert r["compressed_bytes"] == jres.compressed_bytes
        assert r["max_abs_err"] == 0
    # The port's one-process encode-tiled writes the same file.
    save_gray(str(tmp_path / "p.png"), plane)
    assert main(["encode-tiled", "-i", str(tmp_path / "p.png"), "-o", str(tmp_path / "one.thgit"),
                 "--tile", "16", "-l", "3", "-q", "lossless", "--format", "thgi",
                 "--shared-table", "--device", "cpu"]) == 0
    assert (tmp_path / "one.thgit").read_bytes() == blob


def test_two_ranks_medium_left_top_hgi_match_jax(tmp_path):
    plane = _plane64()
    records, blob = _ranks(tmp_path, plane, 2, "-q", "medium", "--predictor", "left_top",
                           "--format", "hgi")
    assert records[0]["thgit_sha256"] == records[1]["thgit_sha256"]
    assert records[0]["table_sha256"] is None
    assert all(r["max_abs_err"] <= 20 for r in records)
    assert blob == _jax_thgit(plane, JQ.MEDIUM, "hgi", False, "left_top")[1]


def test_world_size_one_and_two_write_the_same_bytes(tmp_path):
    plane = _plane64()
    one, blob_one = _ranks(tmp_path, plane, 1, "-q", "medium", "--shared-table")
    two, blob_two = _ranks(tmp_path, plane, 2, "-q", "medium", "--shared-table")
    assert blob_one == blob_two
    assert one[0]["local_indices"] == list(range(16))
    assert one[0]["dcn_payload_bytes"] == 0
    assert one[0]["thgit_sha256"] == two[1]["thgit_sha256"]


def test_padding_only_rank_decodes(tmp_path):
    # 4 tiles on 2 ranks x 4 places: the batch pads to 8, so rank 1's share
    # is only padding; it must still join every collective and decode.
    xx, yy = np.meshgrid(np.arange(32), np.arange(32))
    plane = ((xx + yy) % 256).astype(np.uint8)
    records, blob = _ranks(tmp_path, plane, 2, "-q", "lossless")
    assert records[0]["local_indices"] == [0, 1, 2, 3]
    assert records[1]["local_indices"] == []
    assert all(r["max_abs_err"] == 0 for r in records)
    assert blob == _jax_thgit(plane, JQ.LOSSLESS, "thgi", False)[1]


def test_one_launch_codes_several_planes_in_turn(tmp_path):
    planes = [_plane64(), np.random.default_rng(3).integers(0, 256, (40, 56), dtype=np.uint8)]
    argv = []
    for i, (plane, preset) in enumerate(zip(planes, ("lossless", "medium"))):
        save_gray(str(tmp_path / f"p{i}.png"), plane)
        argv += ["-i", str(tmp_path / f"p{i}.png"), "-q", preset,
                 "-o", str(tmp_path / f"p{i}.thgit")]
    records = multihost_run.rank_records(multihost_run.run_ranks(
        [*argv, "--tile", "16", "-l", "3", "--shared-table", "--device", "cpu", "--places", "4"],
        2, timeout=120))
    assert [(r["rank"], r["leg"], r["preset"]) for r in records] == [
        (0, 0, "lossless"), (0, 1, "medium"), (1, 0, "lossless"), (1, 1, "medium")]
    for i, (plane, preset) in enumerate(zip(planes, (JQ.LOSSLESS, JQ.MEDIUM))):
        want = _jax_thgit(plane, preset, "thgi", True)[1]
        assert (tmp_path / f"p{i}.thgit").read_bytes() == want
        assert {r["thgit_sha256"] for r in records if r["leg"] == i} == {_sha(want)}
    with pytest.raises(SystemExit, match="one -q and one -o for each -i"):
        multihost_run.main(["-i", "a", "-i", "b", "-q", "lossless", "-q", "medium", "-o", "x",
                            "--ranks", "1", "--rank", "0", "--port", "1"])


# -- one process (world size 1), in the pytest process ------------------------


@pytest.mark.parametrize("fmt,shared", [("thgi", True), ("thgi", False), ("hgi", False)])
@pytest.mark.parametrize("preset", ["lossless", "medium"])
@pytest.mark.parametrize("pred", ["crossed", "left_top"])
def test_one_process_matches_jax(fmt, shared, preset, pred):
    plane = np.random.default_rng(7).integers(0, 256, (40, 56), dtype=np.uint8)
    res = tm.encode_tiled_multihost(plane, (16, 16), 3, QuantizationLevel.parse(preset), fmt=fmt,
                                    shared_table=shared, predictor=pred, devices=CPU4)
    jres, jblob = _jax_thgit(plane, JQ.parse(preset), fmt, shared, pred)
    assert res.blocks == jres.blocks
    assert res.local_indices == jres.local_indices == list(range(12))
    assert res.dcn_payload_bytes == jres.dcn_payload_bytes == 0
    assert res.shape == jres.shape and res.compressed_bytes == jres.compressed_bytes
    assert (res.freqs is None) == (not shared)
    if shared:
        assert np.array_equal(res.freqs, jres.freqs)
    assert tm.write_thgit_multihost(res, 16) == jblob
    dec = tm.decode_tiled_multihost(res.blocks, res.shape, (16, 16), freqs=res.freqs,
                                    devices=CPU4)
    assert np.array_equal(dec, jm.decode_tiled_multihost(jres.blocks, jres.shape, (16, 16),
                                                         freqs=jres.freqs))
    assert tm.decode_tiled_multihost(res.blocks, res.shape, (16, 16), freqs=res.freqs,
                                     devices=CPU4, gather=False) is None


def test_mesh_shape_does_not_change_the_bytes():
    plane = _plane64()
    base = tm.encode_tiled_multihost(plane, (16, 16), 3, QuantizationLevel.MEDIUM,
                                     shared_table=True, devices=CPU4[:1])
    for shape, n in (((2, 2), 4), ((4, 1), 4), ((3, 1), 3)):
        res = tm.encode_tiled_multihost(plane, (16, 16), 3, QuantizationLevel.MEDIUM,
                                        shared_table=True, mesh_shape=shape,
                                        devices=[torch.device("cpu")] * n)
        assert res.blocks == base.blocks and np.array_equal(res.freqs, base.freqs)


def test_encode_without_cuda_needs_named_devices(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tm.encode_tiled_multihost(_plane64(), (16, 16), 3, QuantizationLevel.LOSSLESS)
    tm.initialize(tm.MultiHostConfig())  # no group for one process
    tm.initialize(tm.MultiHostConfig("127.0.0.1:1", 1, 0))
    assert not torch.distributed.is_initialized()


# -- faults ---------------------------------------------------------------------


def _frames(pairs):
    return b"".join(struct.pack("<IQI", i, len(b), zlib.crc32(b)) + b for i, b in pairs)


def test_collect_blocks_orders_the_rows():
    rows = [_frames([(2, b"cc"), (0, b"a")]), _frames([(1, b"")]), b""]
    assert tm.collect_blocks(rows, 3) == [b"a", b"", b"cc"]


@pytest.mark.parametrize("case,message,indices", [
    ("duplicate", r"duplicate tile assignment \(driver bug\) from processes \[1\]", [1]),
    ("corrupt", "corrupt blocks after DCN gather", [2]),
    ("truncated", "corrupt blocks after DCN gather", [2]),
    ("missing", "tiles missing after gather", [2, 3]),
])
def test_collect_blocks_names_the_bad_tiles(case, message, indices):
    rows = [_frames([(0, b"zero"), (1, b"one")]), _frames([(2, b"two"), (3, b"three")])]
    if case == "duplicate":
        rows[1] = _frames([(1, b"one"), (2, b"two"), (3, b"three")])
    elif case == "corrupt":
        rows[1] = rows[1].replace(b"two", b"tw0")
    elif case == "truncated":
        rows[1] = _frames([(2, b"two")])[:-1]
        rows[1] = _frames([(3, b"three")]) + rows[1]
    else:
        rows[1] = b""
    with pytest.raises(tm.TileCodingError, match=message) as err:
        tm.collect_blocks(rows, 4)
    assert err.value.indices == indices
    assert f"tiles {indices}" in str(err.value)


def _decode_errors(fn, blocks, shape):
    with pytest.raises(Exception) as err:
        fn(blocks, shape)
    return type(err.value).__name__, str(err.value), getattr(err.value, "indices", None)


@pytest.mark.parametrize("fault", ["count", "block0", "bad", "mismatch", "shape"])
def test_decode_faults_match_jax(fault):
    plane = _plane64()
    res = tm.encode_tiled_multihost(plane, (16, 16), 3, QuantizationLevel.LOSSLESS,
                                    devices=CPU4)
    blocks = list(res.blocks)
    if fault == "count":
        blocks = blocks[:-2]
    elif fault == "block0":
        blocks[0] = b"junk"
    elif fault == "bad":
        blocks[5] = blocks[5][:20]
    elif fault == "mismatch":
        other = tm.encode_tiled_multihost(plane, (16, 16), 2, QuantizationLevel.LOSSLESS,
                                          devices=CPU4)
        blocks[9] = other.blocks[9]
    else:
        other = tm.encode_tiled_multihost(plane, (8, 8), 3, QuantizationLevel.LOSSLESS,
                                          devices=CPU4)
        blocks[3] = other.blocks[3]
    got = _decode_errors(
        lambda b, s: tm.decode_tiled_multihost(b, s, (16, 16), devices=CPU4), blocks, res.shape)
    want = _decode_errors(
        lambda b, s: jm.decode_tiled_multihost(b, s, (16, 16)), blocks, res.shape)
    assert got == want
    assert got[0] == "TileCodingError"
