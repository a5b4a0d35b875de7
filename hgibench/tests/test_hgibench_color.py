"""The color cell on the CPU: whole small runs of ``kodak-color`` with its
control and planted faults, what a pass counts, the readers of the color
encode's spans and counter, the suite's generator and the reference's
reader."""

import time
from types import SimpleNamespace

import numpy as np
import pytest

from hgibench import photos, run, spans, spec
from hgibench.core import Request
from hgibench.entries import encode_color
from hgibench.reference import color as ref

CELL = "kodak-color"
SEED = 2**31 + 11
PHOTO = {"count": 4, "portraits": 1, "identity_images": 2}
SMALL = {"config": {"codec": {"height": 40, "width": 56}, "photo": PHOTO}}
SPAN_READERS = ("load_ms.color", "grids_ms.color", "plane_race_ms.color", "pool_busy_pct.color")
# The race cell's readers that read the color cell as they stand.
RACE_READERS = ("ctx_ms.race", "deflate_ms.race", "rans_ms.race")


def _native():
    from rustyhgi_tpu_torch.ops import native

    if not native.available():
        pytest.skip("the program races ctx only with its native coders")


def _run(trace=False, control=False, seconds=1.0):
    return run.run_cell(CELL, SEED, seconds, trace, device="cpu", overrides=SMALL,
                        control=control, t0=time.perf_counter())


def _suite():
    cfg = spec.load_cell(CELL).config
    return [im.numpy() for im in photos.photo_suite(SEED, dict(cfg["photo"], **PHOTO), 40, 56)]


# -- whole small runs on the CPU ---------------------------------------------------


def test_a_small_run_is_correct_and_counts_every_pass_whole():
    _native()
    r = _run()
    assert r["correct"] and r["failed"] == 0 and r["attempted"] > 0
    assert set(r["metrics"]) == {"bits_per_pixel", "setup_s"}
    assert all(v["value"] <= v["limit"] for v in r["checks"].values())
    images = _suite()
    nbytes = sum(len(ref.encode([im], 4, "lossless")[0][0]) for im in images)
    pixels = sum(im.shape[0] * im.shape[1] for im in images)
    assert r["metrics"]["bits_per_pixel"]["value"] == pytest.approx(8 * nbytes / pixels, rel=1e-12)


def test_a_traced_run_reads_the_programs_count_of_transforms():
    _native()
    r = _run(trace=True)
    kept = [t for im in _suite() for _, t in ref.encode([im], 4, "lossless")]
    assert r["correct"]
    assert r["metrics"]["gdelta_wins_pct.color"]["value"] == pytest.approx(
        100.0 * kept.count(ref.GDELTA) / len(kept))
    assert 0.0 <= r["metrics"]["ctx_wins_pct.race"]["value"] <= 100.0


def test_the_control_is_not_correct():
    r = _run(control=True)
    assert not r["correct"] and r["checks"]["outputs_differing"]["value"] > 0


def test_a_byte_altered_by_the_program_is_not_correct(monkeypatch):
    _native()
    from rustyhgi_tpu_torch.utils import color

    encode = color.encode_color

    def altered(codec, rgb, fmt="thgi"):
        blob = bytearray(encode(codec, rgb, fmt))
        blob[-1] ^= 1
        return bytes(blob)

    monkeypatch.setattr(color, "encode_color", altered)
    r = _run()
    assert not r["correct"] and r["checks"]["outputs_differing"]["value"] > 0


@pytest.mark.parametrize("tie", ["green-delta", "identity"])
def test_a_tie_given_to_identity_is_not_correct(tie, monkeypatch):
    """An image whose G is all 0 ties: both transforms store the same
    three archives.  The program keeps green-delta there, and a program
    that keeps identity is not correct."""
    _native()
    import torch
    from rustyhgi_tpu_torch.utils import color

    suite = photos.photo_suite

    def green_zero(*args, **kwargs):
        images = suite(*args, **kwargs)
        images[0][:, :, 1] = 0
        return images

    def tie_to_identity(codec, rgb, fmt="thgi"):
        planes = torch.from_numpy(np.ascontiguousarray(np.moveaxis(rgb, 2, 0)))
        encoded = [color._encode_one(codec, planes, t, fmt) for t in (0, 1)]
        return min(encoded, key=len)

    monkeypatch.setattr(photos, "photo_suite", green_zero)
    if tie == "identity":
        monkeypatch.setattr(color, "encode_color", tie_to_identity)
    r = _run()
    assert r["correct"] == (tie == "green-delta")


# -- what a pass counts ------------------------------------------------------------


def _passes(marks, failed=(), seconds=10.0):
    """Requests of two images each, an output's marks a list of ``(host time,
    bytes drained)``, counted by the entry, those of ``failed`` failed; the
    second pass ends after the close."""
    s = SimpleNamespace(images=[np.zeros((4, 6, 3), np.uint8), np.zeros((6, 4, 3), np.uint8)],
                        transforms={0: {"gdelta": 2}, 1: {"gdelta": 1, "identity": 1}},
                        wins={0: {(1, 4): 9, (0, 1): 3}, 1: {(1, 4): 6, (1, 3): 6}})
    s.outputs = [encode_color.fast._Output(j % 2, "", m) for j, m in enumerate(marks)]
    s.passes = [[0, 1], [2, 3]]
    ends = [marks[1][-1][0], marks[3][-1][0]]
    requests = [Request(i, 0, 0.0, 0.0, end, i not in failed) for i, end in enumerate(ends)]
    window = SimpleNamespace(requests=requests, seconds=seconds, t0=0.0)
    encode_color.count(s, window)
    return requests


def _read(name, requests, seconds=10.0):
    window = SimpleNamespace(requests=requests, seconds=seconds, t0=0.0)
    return spec.load_metric(name).read(run.Ctx(SimpleNamespace(entry=None), None, window, 0.0))


def test_a_pass_cut_by_the_close_counts_whole():
    marks = [[(1.0, 100)], [(2.0, 50), (2.5, 120)], [(9.0, 100)], [(11.0, 60), (14.0, 120)]]
    requests = _passes(marks)
    assert [r.info["pixels"] for r in requests] == [48, 48]
    assert [r.info["bytes"] for r in requests] == [220, 220]
    assert _read("bits_per_pixel", requests) == pytest.approx(8 * 440 / 96)
    assert _read("gdelta_wins_pct.color", requests) == pytest.approx(75.0)
    assert requests[0].info["wins"] == {"1.4": 9, "0.1": 3}
    assert _read("ctx_wins_pct.race", requests) == pytest.approx(100.0 * 15 / 24)


def test_a_failed_pass_counts_nothing():
    marks = [[(1.0, 100)], [(2.0, 120)], [(9.0, 100)], [(11.0, 120)]]
    requests = _passes(marks, failed=(1,))
    assert "pixels" not in requests[1].info
    assert _read("bits_per_pixel", requests) == pytest.approx(8 * 220 / 48)


# -- the readers of the color encode's spans ---------------------------------------


def _span(i, name, parent, request, a, b):
    return SimpleNamespace(id=i, name=name, parent=parent, request=request, start_ns=a, end_ns=b,
                           nbytes=None, depth=0)


def _ctx(records, monkeypatch, served=1):
    monkeypatch.setattr(spans, "window_spans", lambda ctx: records)
    window = SimpleNamespace(t0=0.0, seconds=10.0, requests=[])
    return SimpleNamespace(window=window, reading=object(),
                           ok=[SimpleNamespace(info={}) for _ in range(served)])


def test_the_readers_count_every_pass_the_window_started(monkeypatch):
    ms = 1_000_000
    records = []
    for first, start in ((1, 0), (100, 50 * ms)):  # two passes of one image each
        records += [_span(first, "cli.encode", None, first, start, start + 40 * ms),
                    _span(first + 1, "cli.load", first, first, start, start + 2 * ms),
                    _span(first + 2, "color.grids", first, first, start + 2 * ms, start + 5 * ms),
                    _span(first + 3, "color.plane", first, first, start + 5 * ms, start + 25 * ms),
                    _span(first + 4, "coder.ctx", first + 3, first, start + 5 * ms,
                          start + 25 * ms),
                    _span(first + 5, "coder.deflate", first + 3, first, start + 5 * ms,
                          start + 15 * ms)]
    ctx_ = _ctx(records, monkeypatch, served=2)
    read = {name: spec.load_metric(name).read(ctx_) for name in SPAN_READERS + RACE_READERS}
    assert read == {"load_ms.color": 2.0, "grids_ms.color": 3.0, "plane_race_ms.color": 20.0,
                    "pool_busy_pct.color": 100.0 * 30 / (4 * 20), "ctx_ms.race": 20.0,
                    "deflate_ms.race": 10.0, "rans_ms.race": None}


@pytest.mark.parametrize("records", [None, [], "other"], ids=["untraced", "none", "other-spans"])
def test_the_readers_read_nothing_without_their_spans(records, monkeypatch):
    if records == "other":
        records = [_span(1, "cli.encode_tiled", None, 1, 0, 10), _span(2, "tiles.race", 1, 1, 0, 5)]
    ctx_ = _ctx(records, monkeypatch)
    for name in SPAN_READERS + ("gdelta_wins_pct.color",):
        assert spec.load_metric(name).read(ctx_) is None


def test_every_reader_of_the_cell_reads_the_programs_color_encode(tmp_path, monkeypatch):
    """The span readers on the spans a small encode --color records, the
    coders' jobs on the pool's threads among them."""
    _native()
    from PIL import Image
    from rustyhgi_tpu_torch import cli
    from rustyhgi_tpu_torch.utils import profiling

    cell = spec.load_cell(CELL)
    assert {m["name"] for m in cell.per_layer} >= set(SPAN_READERS + RACE_READERS) | {
        "gdelta_wins_pct.color", "ctx_wins_pct.race", "idle_unnamed_pct.encode"}
    Image.fromarray(_suite()[0]).save(tmp_path / "p.png")
    profiling.enable_spans(spans.CAPACITY)
    since = time.perf_counter_ns()
    rc = cli.main(["encode", "-i", str(tmp_path / "p.png"), "-o", str(tmp_path / "p.thgic"),
                   "--color", "--format", "thgi", "-q", "lossless", "--device", "cpu"])
    assert rc == 0
    read = {name: spec.load_metric(name).read(_ctx(profiling.spans(since), monkeypatch))
            for name in SPAN_READERS + RACE_READERS}
    assert all(v is not None and v > 0 for v in read.values()), read
    assert read["pool_busy_pct.color"] <= 100.0


# -- the suite and the reference -----------------------------------------------------


def test_the_suite_is_seeded_and_holds_its_mix():
    photo = spec.load_cell(CELL).config["photo"]
    images = photos.photo_suite(7, photo, 32, 48)
    again = photos.photo_suite(7, photo, 32, 48)
    other = photos.photo_suite(8, photo, 32, 48)
    assert len(images) == photo["count"] and all((a == b).all() for a, b in zip(images, again))
    assert any((a != b).any() for a, b in zip(images, other) if a.shape == b.shape)
    assert sum(im.shape[:2] == (48, 32) for im in images) == photo["portraits"]
    assert all(im.shape[2] == 3 and str(im.dtype) == "torch.uint8" for im in images)


@pytest.mark.parametrize("cut", [0, 5, 10, -1], ids=["empty", "head", "length", "archive"])
def test_the_reference_refuses_a_cut_container(cut):
    rgb = np.random.default_rng(1).integers(0, 256, (16, 24, 3), np.uint8)
    (data, _), = ref.encode([rgb], 2, "lossless", codecs=("deflate",))
    assert np.array_equal(ref.decode(data), rgb)
    with pytest.raises(ValueError):
        ref.split(data[:cut])
