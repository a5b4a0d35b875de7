"""The reference reads and writes what the program's plain path does, at
tiny sizes on the CPU: byte for byte for the fast ``.thgi`` and the
``.thgit``, pixel for pixel for the decode, and within each preset's
error of the source."""

import numpy as np
import pytest

from hgibench.reference import formats, hgi, rans


def _planes(seed, b, h, w, sigma=20):
    rng = np.random.default_rng(seed)
    return np.clip(128 + rng.normal(0, sigma, (b, h, w)), 0, 255).astype(np.uint8)


@pytest.mark.parametrize("h, w, preset, predictor", [
    (64, 96, "medium", "crossed"), (33, 70, "lossless", "crossed"), (100, 130, "high", "left_top"),
    (17, 300, "low", "crossed"), (1, 1, "medium", "crossed"), (256, 256, "lossless", "left_top"),
])
def test_fast_archives_equal_the_programs_and_read_back(h, w, preset, predictor):
    from rustyhgi_tpu_torch.models.codec import HGICodec
    from rustyhgi_tpu_torch.utils.container import read_archive

    planes = _planes(h * w, 3, h, w)
    codec = HGICodec(4, preset, predictor=predictor, device="cpu")
    program = [codec.write_fast(p) for p in planes]
    assert program == formats.write_fast(planes, 4, preset, predictor)
    decoded = formats.read_fast(program)
    assert np.array_equal(decoded, np.stack([codec.decode(read_archive(b, device="cpu"))
                                             for b in program]))
    assert np.abs(decoded.astype(int) - planes).max() <= hgi.ERRORS[preset]


def test_thgit_equals_the_commands_output(tmp_path):
    from PIL import Image
    from rustyhgi_tpu_torch import cli

    plane = _planes(7, 1, 300, 530)[0]
    Image.fromarray(plane).save(tmp_path / "s.tif")
    out = tmp_path / "s.thgit"
    assert cli.main(["encode-tiled", "-i", str(tmp_path / "s.tif"), "-o", str(out), "--tile", "128",
                     "--format", "thgi", "--fast", "--level", "4", "--quantizator", "lossless",
                     "--device", "cpu"]) == 0
    data, ends = formats.thgit_bytes(plane, 128, 4, "lossless")
    assert out.read_bytes() == data and ends[-1] == len(data) and len(ends) == 3 * 5
    tile, w, h, blocks = formats.parse_thgit(data)
    assert (tile, w, h) == (128, 530, 300)
    tiles = formats.read_fast(blocks)
    assert np.array_equal(tiles, formats.tile_plane(plane, 128))


@pytest.mark.parametrize("n", [1, 5, 1000, 70000])
def test_rans_round_trip_and_rejects_a_bad_stream(n):
    sym = np.random.default_rng(n).integers(0, 40, (2, n), dtype=np.uint8)
    payloads = rans.encode(sym)
    assert np.array_equal(rans.decode(payloads), sym)
    bad = bytearray(payloads[0])
    bad[-1] ^= 0x55
    with pytest.raises(ValueError):
        rans.decode([bytes(bad)])


def test_the_controls_break_the_bound():
    planes = _planes(3, 2, 64, 96)
    coarse = formats.read_fast(formats.write_fast(planes, 4, "medium", error=30))
    assert np.abs(coarse.astype(int) - planes).max() > 20
    skipped = formats.read_fast(formats.write_fast(planes, 4, "medium"), skip_finest=True)
    assert np.abs(skipped.astype(int) - planes).max() > 20


def test_a_corrupt_thgit_is_refused():
    data, _ = formats.thgit_bytes(_planes(1, 1, 40, 40)[0], 32, 4, "lossless")
    bad = bytearray(data)
    bad[40] ^= 1
    with pytest.raises(ValueError):
        formats.parse_thgit(bytes(bad))
