"""The port's color encode against the benchmark's plain NumPy reference
(``hgibench/reference/color.py``) on the CPU, byte for byte, and the
spans and the counter that ``encode --color`` records.

The reference races the ctx coder only where the program does: with the
native coders present."""

import numpy as np
import pytest
from PIL import Image

from hgibench.reference import color as ref
from rustyhgi_tpu_torch.cli import main
from rustyhgi_tpu_torch.models.codec import HGICodec
from rustyhgi_tpu_torch.ops import native
from rustyhgi_tpu_torch.utils import color as tc
from rustyhgi_tpu_torch.utils import profiling

SHAPES = {"48x64": (48, 64), "64x40": (64, 40)}


def correlated(h, w, seed=3):
    """Channels sharing their texture, with offsets: green-delta's case."""
    rng = np.random.default_rng(seed)
    y = np.linspace(0.0, 6.0, h)[:, None]
    x = np.linspace(0.0, 9.0, w)[None, :]
    base = 128 + 60 * np.sin(y) * np.cos(x) + rng.normal(0.0, 4.0, (h, w))
    planes = [base + off + rng.normal(0.0, 0.5, (h, w)) for off in (12, 0, -9)]
    return np.clip(np.stack(planes, 2), 0, 255).astype(np.uint8)


def independent(h, w, seed=4):
    """Unrelated channels, a ramp, noise and another ramp: identity's case."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    planes = [(x * 4) % 256, rng.integers(0, 256, (h, w)), (y * 5 + 17) % 256]
    return np.stack(planes, 2).astype(np.uint8)


def green_zero(h, w):
    """G all 0: both transforms store the same three archives, a tie."""
    rgb = correlated(h, w, seed=5)
    rgb[:, :, 1] = 0
    return rgb


IMAGES = {"correlated": (correlated, ref.GDELTA), "independent": (independent, ref.IDENTITY),
          "tie": (green_zero, ref.GDELTA)}


def _codecs():
    return ("deflate", "rans", "ctx") if native.available() else ("deflate", "rans")


@pytest.fixture
def recorded():
    """Spans kept while the test runs; the recorder is off again after it."""
    profiling.enable_spans()
    try:
        yield
    finally:
        profiling.disable_spans()


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("image", IMAGES)
def test_encode_color_is_the_references_byte_for_byte(image, shape):
    make, transform = IMAGES[image]
    rgb = make(*SHAPES[shape])
    got = tc.encode_color(HGICodec(4, "lossless", device="cpu"), rgb, "thgi")
    (want, kept), = ref.encode([rgb], 4, "lossless", codecs=_codecs())
    assert got == want and kept == transform and got[5] == transform
    assert np.array_equal(ref.decode(got), rgb)
    other = ref.encode([rgb], 4, "lossless", codecs=_codecs(), keep="identity")[0]
    assert (other[0] == got) == (transform == ref.IDENTITY)


def test_the_reference_codes_a_batch_as_each_image_alone():
    images = [correlated(48, 64), independent(48, 64), green_zero(48, 64)]
    batch = ref.encode(images, 4, "lossless", codecs=_codecs())
    assert batch == [ref.encode([rgb], 4, "lossless", codecs=_codecs())[0] for rgb in images]


def _spans_of(tmp_path, rgb, *extra):
    path, out = tmp_path / "in.png", tmp_path / "out.thgic"
    Image.fromarray(rgb).save(path)
    assert main(["encode", "-i", str(path), "-o", str(out), "--format", "thgi", "-q",
                 "lossless", "--device", "cpu", *extra]) == 0
    return profiling.spans(), out.read_bytes()


def test_the_color_commands_spans_nest_and_carry_bytes(tmp_path, recorded):
    h, w = 48, 64
    records, blob = _spans_of(tmp_path, correlated(h, w), "--color")
    by_id = {s.id: s for s in records}
    names = [s.name for s in records]

    def parent(s):
        return by_id[s.parent].name if s.parent in by_id else None

    root, = [s for s in records if s.parent is None]
    assert root.name == "cli.encode" and all(s.request == root.id for s in records)
    assert names.count("cli.load") == 1 and names.count("cli.write") == 1
    assert [s.nbytes for s in records if s.name == "cli.write"] == [len(blob)]
    encodes = [s for s in records if s.name == "color.encode"]
    assert len(encodes) == 2 and {parent(s) for s in encodes} == {"cli.encode"}
    for name in ("color.forward", "color.grids"):
        got = [s for s in records if s.name == name]
        assert len(got) == 2 and {parent(s) for s in got} == {"color.encode"}
        assert {s.nbytes for s in got} == {3 * h * w}
    planes = [s for s in records if s.name == "color.plane"]
    assert len(planes) == 6 and {parent(s) for s in planes} == {"color.encode"}
    assert all(s.nbytes > 0 for s in planes)
    kept = ref.split(blob)[1]
    assert {len(b) for b in kept} <= {s.nbytes for s in planes}
    coders = [s for s in records if s.name.startswith("coder.")]
    assert {s.name for s in coders} == {f"coder.{c}" for c in _codecs()}
    assert {parent(s) for s in coders} == {"color.plane"} and all(s.thread for s in coders)
    for name in ("thgi.payload", "thgi.wait"):
        got = [s for s in records if s.name == name]
        assert len(got) == 6 and {parent(s) for s in got} == {"color.plane"}


def test_the_luma_commands_spans(tmp_path, recorded):
    records, blob = _spans_of(tmp_path, correlated(48, 64))
    root, = [s for s in records if s.parent is None]
    assert root.name == "cli.encode" and all(s.request == root.id for s in records)
    children = {s.name for s in records if s.parent == root.id}
    assert {"cli.load", "cli.write", "codec.h2d", "thgi.wait"} <= children
    assert [s.nbytes for s in records if s.name == "cli.write"] == [len(blob)]


def test_an_untraced_command_writes_the_same_bytes(tmp_path):
    rgb = independent(64, 40)
    profiling.enable_spans()
    try:
        _, traced = _spans_of(tmp_path, rgb, "--color")
    finally:
        profiling.disable_spans()
    _, untraced = _spans_of(tmp_path, rgb, "--color")
    assert traced == untraced == ref.encode([rgb], 4, "lossless", codecs=_codecs())[0][0]


def test_transform_wins_counts_the_kept_transform():
    codec = HGICodec(4, "lossless", device="cpu")
    tc.TRANSFORM_WINS.clear()
    for make in (correlated, independent, green_zero, correlated):
        tc.encode_color(codec, make(48, 64))
    assert dict(tc.TRANSFORM_WINS) == {"gdelta": 3, "identity": 1}
    tc.encode_color(HGICodec(4, "medium", device="cpu"), correlated(48, 64))
    assert dict(tc.TRANSFORM_WINS) == {"gdelta": 3, "identity": 1}  # lossy races nothing
    tc.TRANSFORM_WINS.clear()
