"""The port's color (``.thgic``) against ``rustyhgi_tpu.utils.color`` on the CPU.

Every comparison is exact: lossy containers are held to the JAX bytes,
not to a bound.
"""

import struct

import numpy as np
import pytest

from rustyhgi_tpu.cli import main as jax_main
from rustyhgi_tpu.models.codec import HGICodec as JaxCodec
from rustyhgi_tpu.oracle import oracle_decode
from rustyhgi_tpu.utils import color as jc

from rustyhgi_tpu_torch.cli import main
from rustyhgi_tpu_torch.models.codec import HGICodec
from rustyhgi_tpu_torch.ops.quantizers import QuantizationLevel, linear_error
from rustyhgi_tpu_torch.utils import color as tc
from rustyhgi_tpu_torch.utils.container import read_archive

CPU = ["--device", "cpu"]
PRESETS = ("lossless", "low", "medium", "high")
SHAPES = {"40x56": (40, 56), "37x61": (37, 61)}


def correlated(h, w, seed=3):
    """A smooth scene in three channels with offsets and a little noise:
    green-delta's case."""
    rng = np.random.default_rng(seed)
    y = np.linspace(0.0, 6.0, h)[:, None]
    x = np.linspace(0.0, 9.0, w)[None, :]
    base = 128 + 60 * np.sin(y) * np.cos(x) + 30 * np.sin(3 * x + y)
    planes = [base + off + rng.normal(0.0, 3.0, (h, w)) for off in (12, 0, -9)]
    return np.clip(np.stack(planes, 2), 0, 255).astype(np.uint8)


def independent(h, w, seed=4):
    """Unrelated channels, a ramp, noise and another ramp: identity's case."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    planes = [(x * 4) % 256, rng.integers(0, 256, (h, w)), (y * 5 + 17) % 256]
    return np.stack(planes, 2).astype(np.uint8)


IMAGES = {"correlated": correlated, "independent": independent}


def _bound(preset):
    return linear_error(QuantizationLevel.parse(preset))


def _codec(levels, preset, predictor="crossed"):
    return HGICodec(levels, preset, predictor=predictor, device="cpu")


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("image", IMAGES, ids=str)
@pytest.mark.parametrize("fmt", ("hgi", "thgi"))
@pytest.mark.parametrize("preset", PRESETS)
def test_thgic_bytes_match_jax(preset, fmt, image, shape):
    rgb = IMAGES[image](*SHAPES[shape])
    want = jc.encode_color(JaxCodec(4, preset), rgb, fmt)
    got = tc.encode_color(_codec(4, preset), rgb, fmt)
    assert got == want
    back = tc.decode_color(got, device="cpu")
    err = np.abs(back.astype(np.int64) - rgb).max()
    assert err <= _bound(preset)
    if preset == "lossless":
        assert np.array_equal(back, rgb)


@pytest.mark.parametrize("image,transform", [("correlated", 1), ("independent", 0)])
def test_lossless_race_picks_the_jax_transform(image, transform):
    rgb = IMAGES[image](40, 56)
    got = tc.encode_color(_codec(4, "lossless"), rgb)
    assert got[5] == jc.encode_color(JaxCodec(4, "lossless"), rgb)[5] == transform
    planes = np.moveaxis(rgb, 2, 0)
    sizes = [len(jc._encode_one(JaxCodec(4, "lossless"), planes, t, "thgi")) for t in (1, 0)]
    assert len(got) == min(sizes)


@pytest.mark.parametrize("engine", ("auto", "torch"))
@pytest.mark.parametrize("fmt", ("hgi", "thgi"))
@pytest.mark.parametrize("preset", ("lossless", "medium"))
def test_preview_equals_the_sampled_full_decode(preset, fmt, engine):
    rgb = correlated(37, 61)
    blob = tc.encode_color(_codec(4, preset), rgb, fmt)
    full = tc.decode_color(blob, device="cpu", backend=engine)
    for upto in range(5):
        s = 1 << (4 - upto)
        preview = tc.decode_color_preview(blob, upto, device="cpu", backend=engine)
        assert np.array_equal(preview, full[::s, ::s]), upto
        assert np.array_equal(preview, jc.decode_color_preview(blob, upto))


@pytest.mark.parametrize("preset", ("lossless", "medium"))
def test_left_top_decodes_by_its_tag(preset):
    """JAX's decode_color ignores the tag and decodes left_top planes with
    the crossed tree; the port decodes each plane as its grayscale decode
    and the oracle do."""
    rgb = correlated(40, 56)
    blob = tc.encode_color(_codec(4, preset, "left_top"), rgb, "thgi")
    assert blob == jc.encode_color(JaxCodec(4, preset, predictor="left_top"), rgb, "thgi")
    transform, blobs = tc._split_thgic(blob)
    archives = [read_archive(b, device="cpu") for b in blobs]
    planes = np.stack([_codec(4, preset).decode(a) for a in archives])
    for a, plane in zip(archives, planes):
        assert a.metadata.interpolation != 0
        assert np.array_equal(plane, oracle_decode(a.grid, 4, predictor="left_top"))
    if transform == 1:
        g, dr, db = planes.astype(np.int16)
        planes = np.stack([(dr + g) & 255, g, (db + g) & 255]).astype(np.uint8)
    back = tc.decode_color(blob, device="cpu")
    assert np.array_equal(back, np.moveaxis(planes, 0, 2))
    assert np.abs(back.astype(np.int64) - rgb).max() <= _bound(preset)
    preview = tc.decode_color_preview(blob, 2, device="cpu")
    assert np.array_equal(preview, back[::4, ::4])


def _frame(n_planes, transform, blobs):
    parts = [struct.pack("<IBB", tc.THGIC_MAGIC, n_planes, transform)]
    for b in blobs:
        parts += [struct.pack("<Q", len(b)), b]
    return b"".join(parts)


def _good():
    return tc.encode_color(_codec(2, "medium"), correlated(9, 11), "hgi")


MALFORMED = {
    "empty": lambda: b"",
    "short-head": lambda: _good()[:5],
    "bad-magic": lambda: struct.pack("<I", 0x7B61_A555) + _good()[4:],
    "two-planes": lambda: _frame(2, 0, tc._split_thgic(_good())[1][:2]),
    "bad-transform": lambda: _frame(3, 2, tc._split_thgic(_good())[1]),
    "cut-length": lambda: _good()[:10],
    "cut-blob": lambda: _good()[:-1],
}


@pytest.mark.parametrize("case", MALFORMED)
def test_split_thgic_raises_the_jax_errors(case):
    data = MALFORMED[case]()
    with pytest.raises(ValueError) as want:
        jc._split_thgic(data)
    with pytest.raises(ValueError) as got:
        tc._split_thgic(data)
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match=str(want.value)):
        tc.decode_color(data, device="cpu")


def test_planes_of_different_tags_are_refused():
    rgb = correlated(9, 11)
    crossed = tc._split_thgic(tc.encode_color(_codec(2, "medium"), rgb, "hgi"))[1]
    left_top = tc._split_thgic(tc.encode_color(_codec(2, "medium", "left_top"), rgb, "hgi"))[1]
    mixed = _frame(3, 0, [crossed[0], left_top[1], crossed[2]])
    for decode in (lambda d: tc.decode_color(d, device="cpu"),
                   lambda d: tc.decode_color_preview(d, 1, device="cpu")):
        with pytest.raises(ValueError, match="differ in shape, depth or predictor tag"):
            decode(mixed)


def test_encode_color_refuses_what_jax_refuses():
    for bad in (np.zeros((4, 5), np.uint8), np.zeros((4, 5, 4), np.uint8)):
        with pytest.raises(ValueError) as want:
            jc.encode_color(JaxCodec(2, "medium"), bad)
        with pytest.raises(ValueError) as got:
            tc.encode_color(_codec(2, "medium"), bad)
        assert str(got.value) == str(want.value)


@pytest.fixture
def rgb_png(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    tc.save_rgb("c.png", correlated(37, 61))
    return "c.png"


@pytest.mark.parametrize("predictor", ("crossed", "left_top"))
@pytest.mark.parametrize("fmt", ("hgi", "thgi"))
@pytest.mark.parametrize("preset", ("lossless", "medium"))
def test_cli_color_matches_the_jax_cli(rgb_png, preset, fmt, predictor):
    flags = ["--color", "-q", preset, "--format", fmt, "-l", "3", "--predictor", predictor]
    assert jax_main(["encode", "-i", rgb_png, "-o", "ref.thgic", *flags]) == 0
    assert main(["encode", "-i", rgb_png, "-o", "ours.thgic", *flags, *CPU]) == 0
    with open("ref.thgic", "rb") as a, open("ours.thgic", "rb") as b:
        assert a.read() == b.read()
    for extra in ([], ["--preview", "1"]):
        assert main(["decode", "-i", "ref.thgic", "-o", "ours.png", *extra, *CPU]) == 0
        ours = tc.load_rgb("ours.png")
        if predictor == "crossed":  # JAX decodes every plane crossed (see above)
            assert jax_main(["decode", "-i", "ref.thgic", "-o", "ref.png", *extra]) == 0
            assert np.array_equal(ours, tc.load_rgb("ref.png"))
        want = tc.decode_color(open("ref.thgic", "rb").read(), device="cpu")
        assert np.array_equal(ours, want[::4, ::4] if extra else want)


def test_without_a_card_color_needs_the_cpu_by_name(monkeypatch):
    blob = tc.encode_color(_codec(2, "medium"), correlated(9, 11), "hgi")
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    for call in (lambda: tc.decode_color(blob), lambda: tc.decode_color_preview(blob, 1),
                 lambda: tc.encode_color(HGICodec(2, "medium"), correlated(9, 11))):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    assert tc.decode_color(blob, device="cpu").shape == (9, 11, 3)
