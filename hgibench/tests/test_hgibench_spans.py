"""The program's spans on the profiled slice's clock, on synthetic readings:
the clocks' offset from the harness's own ranges, the idle gaps cut by
nested spans, and each reader of the spans on a hand-built context."""

import importlib
import random
import types

import pytest

from hgibench import run, spans, spec
from hgibench.core import Request, Window
from hgibench.trace import Reading

OFFSET = 100.0  # host clock less profiler clock in the synthetic slice
NS = 1_000_000_000


def _span(i, name, a, b, parent=None, depth=0, nbytes=None):
    """A span from ``a`` to ``b`` host seconds."""
    return types.SimpleNamespace(id=i, name=name, parent=parent, request=1, depth=depth,
                                 start_ns=round(a * NS), end_ns=round(b * NS), nbytes=nbytes)


# One command of the window, from 100.0 to 101.0 on the host clock, and a
# split that ran before the window opened.
SPANS = [
    _span(9, "tiles.split", 99.0, 99.1, parent=8, depth=1),
    _span(2, "cli.load", 100.0, 100.4, 1, 1),
    _span(3, "tiles.split", 100.4, 100.5, 1, 1),
    _span(5, "codec.h2d", 100.5, 100.6, 4, 2, nbytes=100_000_000),
    _span(6, "codec.frame", 100.7, 100.75, 4, 2),
    _span(7, "tiles.frame", 100.75, 100.8, 4, 2, nbytes=1000),
    _span(10, "tiles.write", 100.8, 100.85, 4, 2, nbytes=1012),
    _span(4, "tiles.chunk", 100.5, 100.9, 1, 1),
    _span(1, "cli.encode_tiled", 100.0, 101.0),
]
# The slice: 0.0-1.2 s on the profiler's clock, the card busy 0.55-0.7 s.
DEVICE = [("encode_lossless", 0.55, 0.6), ("rans_encode_lanes", 0.6, 0.7)]
CALLS = {"encode_tiled": [(99.0, 99.5), (100.0, 101.0)], "load": [(100.0, 100.4)],
         "fetch": [(100.61, 100.62), (100.63, 100.64), (100.65, 100.66)]}
HOST = [("encode_tiled", 1e-6, 1.0), ("load", 2e-6, 0.4), ("fetch", 0.61 + 3e-6, 0.62),
        ("fetch", 0.63 + 2e-6, 0.64), ("fetch", 0.65 + 1e-6, 0.66)]


def _ctx(reading=True):
    ok = [Request(i, 0, 0.0, 0.0, 1.0, True) for i in range(2)]
    window = Window(t0=OFFSET, seconds=1.2, requests=ok, kept={})
    r = Reading(DEVICE, HOST, (0.0, 1.2), {}) if reading else None
    clock = types.SimpleNamespace(calls=CALLS)
    return run.Ctx(types.SimpleNamespace(entry=None), None, window, 1.0, clock, r, 0)


@pytest.fixture
def recorded(monkeypatch):
    monkeypatch.setattr(spans, "recorded",
                        lambda since_ns: [s for s in SPANS if s.start_ns >= since_ns])


def test_the_offset_is_recovered_from_calls_matched_in_order():
    rnd = random.Random(5)
    # Calls come at irregular times, as a program's do.
    fetch = [10.0 + 0.3 * i + rnd.uniform(0, 0.01) for i in range(40)]
    calls = {"fetch": [(a, a + 0.1) for a in fetch],
             "load": [(9.0 + i, 9.2 + i) for i in range(5)]}
    # The slice saw calls 12-29 of the fetches and 1-2 of the loads.
    ranges = [("fetch", calls["fetch"][i][0] - 7.25 + rnd.uniform(0, 2e-5), 0.0)
              for i in range(12, 30)]
    ranges += [("load", calls["load"][i][0] - 7.25 + rnd.uniform(0, 2e-5), 0.0) for i in (1, 2)]
    rnd.shuffle(ranges)
    assert spans.offset_s(calls, ranges) == pytest.approx(7.25, abs=2e-5)


def test_offsets_that_spread_over_a_tenth_of_a_millisecond_read_nothing():
    calls = {"fetch": [(10.0 + 0.3 * i, 10.1 + 0.3 * i) for i in range(20)]}
    ranges = [("fetch", calls["fetch"][i][0] - 7.25 + (i % 2) * 3e-4, 0.0) for i in range(20)]
    assert spans.offset_s(calls, ranges) is None
    assert spans.offset_s(calls, []) is None
    assert spans.offset_s({"load": []}, [("load", 1.0, 2.0)]) is None


def test_gaps_are_cut_by_the_innermost_span_and_the_rest_is_unnamed():
    stretches = spans._innermost(SPANS, OFFSET, 0.0, 1.2)
    assert [s[2] for s in stretches] == ["cli.load", "tiles.split", "codec.h2d", "tiles.chunk",
                                         "codec.frame", "tiles.frame", "tiles.write",
                                         "tiles.chunk"]
    split = spans.split_gaps([(0.0, 0.55), (0.7, 1.2)], stretches)
    want = {"cli.load": 0.4, "tiles.split": 0.1, "codec.h2d": 0.05, "codec.frame": 0.05,
            "tiles.frame": 0.05, "tiles.write": 0.05, "tiles.chunk": 0.05,
            spans.UNNAMED: 0.3}  # the command's own 0.1 s and 0.2 s after it
    assert split == pytest.approx(want)
    assert spans.split_gaps([(0.0, 1.0)], []) == {spans.UNNAMED: 1.0}


def test_the_idle_split_of_a_hand_built_slice(recorded):
    split = spans.idle_by_span(_ctx())
    assert sum(split.values()) == pytest.approx(1.05)
    assert split[spans.UNNAMED] == pytest.approx(0.3)
    assert split["cli.load"] == pytest.approx(0.4)


READ = {"split_ms.encode": 50.0, "h2d_ms.encode": 50.0, "h2d_gb_s.encode": 1.0,
        "frame_ms.encode": 50.0, "out_ms.encode": 25.0,
        "idle_unnamed_pct.encode": 100.0 * 0.3 / 1.05}


@pytest.mark.parametrize("name", sorted(READ))
def test_each_reader_on_a_hand_built_context(name, recorded):
    assert spans.window_spans(_ctx()) is not None
    assert spec.load_metric(name).read(_ctx()) == pytest.approx(READ[name])


@pytest.mark.parametrize("name", sorted(READ))
def test_a_reader_reads_nothing_without_a_kept_slice(name, recorded):
    assert spec.load_metric(name).read(_ctx(reading=False)) is None


@pytest.mark.parametrize("name", sorted(READ))
def test_a_reader_reads_nothing_from_a_program_without_the_recorder(name, monkeypatch):
    monkeypatch.setattr(spans, "_ON", False)
    assert spans.recorded(0) is None
    assert spec.load_metric(name).read(_ctx()) is None


ABSENT = {"split_ms.encode": ("tiles.split",), "h2d_ms.encode": ("codec.h2d",),
          "h2d_gb_s.encode": ("codec.h2d",), "frame_ms.encode": ("codec.frame", "tiles.frame"),
          "out_ms.encode": ("tiles.write",)}


@pytest.mark.parametrize("name", sorted(ABSENT))
def test_a_reader_reads_nothing_when_its_spans_are_absent(name, monkeypatch):
    # A program whose stage was renamed or moved records the others alone.
    kept = [s for s in SPANS if s.name not in ABSENT[name]]
    monkeypatch.setattr(spans, "recorded", lambda since_ns: kept)
    assert spec.load_metric(name).read(_ctx()) is None


@pytest.mark.parametrize("name", sorted(READ))
def test_a_reader_reads_nothing_from_the_command_span_alone(name, monkeypatch):
    root = [s for s in SPANS if s.parent is None]
    monkeypatch.setattr(spans, "recorded", lambda since_ns: root)
    assert spec.load_metric(name).read(_ctx()) is None
    assert spans.idle_by_span(_ctx()) is None


def test_importing_the_module_turns_the_recorder_on():
    from rustyhgi_tpu_torch.utils import profiling

    profiling.disable_spans()
    importlib.reload(spans)
    with profiling.span("tiles.split"):
        pass
    assert spans.recorded(0)[-1].name == "tiles.split"
