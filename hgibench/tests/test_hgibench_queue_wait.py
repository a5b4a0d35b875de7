"""The race's queue wait (``ctx_queued_ms.race``): the ctx jobs' waits for
a pool thread, per served scene, on synthetic spans and on the spans a
small racing encode-tiled records on the CPU; nothing, not 0, from a
program whose spans lack the field; and its one cell in
``BENCHMARK.json``."""

import json
import os
import time
from types import SimpleNamespace

import pytest

from hgibench import spans, spec
from hgibench.scenes import race_scenes

NAME = "ctx_queued_ms.race"
CELL = "ikonos-scene-race"
MS = 1_000_000


def _read(records, monkeypatch, served=1):
    monkeypatch.setattr(spans, "window_spans", lambda ctx: records)
    window = SimpleNamespace(t0=0.0, seconds=10.0, requests=[])
    ctx_ = SimpleNamespace(window=window, reading=object(),
                           ok=[SimpleNamespace(info={}) for _ in range(served)])
    return spec.load_metric(NAME).read(ctx_)


def _span(i, name, parent, request, a, b, **fields):
    """A span; ``fields`` such as a pool job's ``queued_ns``, which a
    program before it records without."""
    return SimpleNamespace(id=i, name=name, parent=parent, request=request, start_ns=a, end_ns=b,
                           nbytes=None, depth=0, **fields)


def _scene(first, start, queued=True):
    """A scene's command, race and coder jobs, each job with its wait
    for a thread unless ``queued`` is False."""

    def job(i, name, wait_ms, ms):
        fields = {"queued_ns": wait_ms * MS} if queued else {}
        return _span(first + i, name, first + 1, first, start + wait_ms * MS,
                     start + (wait_ms + ms) * MS, **fields)

    return [_span(first, "cli.encode_tiled", None, first, start, start + 30 * MS),
            _span(first + 1, "tiles.race", first, first, start, start + 20 * MS),
            job(2, "coder.ctx", 3, 8), job(3, "coder.ctx_mt", 2, 5),
            job(4, "coder.deflate", 1, 6), job(5, "coder.rans", 7, 2)]


def test_it_sums_the_ctx_jobs_waits_per_served_scene(monkeypatch):
    s = 1_000_000_000
    # The deflate and rans jobs' waits are not the ctx jobs'.
    assert _read(_scene(1, s), monkeypatch) == 5.0
    # The close at 10 s cuts the second scene; it runs to its end and counts.
    assert _read(_scene(1, s) + _scene(100, 9 * s), monkeypatch, served=2) == 5.0


@pytest.mark.parametrize("records", [None, [], "other", "unqueued", "mixed"],
                         ids=["untraced", "none", "other-spans", "no-field", "one-without"])
def test_it_reads_nothing_without_its_spans_or_their_field(records, monkeypatch):
    s = 1_000_000_000
    if isinstance(records, str):
        records = {"other": [_span(1, "cli.encode_tiled", None, 1, 0, 10),
                             _span(2, "tiles.chunk", 1, 1, 0, 5)],
                   "unqueued": _scene(1, s, queued=False),
                   # One job without the field among the others would leave the sum short.
                   "mixed": _scene(1, s) + _scene(100, 6 * s, queued=False)}[records]
    assert _read(records, monkeypatch, served=2) is None


def test_it_reads_nothing_with_no_scene_served(monkeypatch):
    assert _read(_scene(1, 0), monkeypatch, served=0) is None


def test_it_is_listed_in_the_race_cell_alone():
    with open(os.path.join(spec.ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    m = next(m for m in bench["per_layer"] if m["name"] == NAME)
    assert m["workloads"] == [CELL]
    assert (m["source"], m["moves"], m["unit"], m["better"]) == (
        "program_span", "bits_per_pixel", "ms", "lower")
    assert bench["per_layer"][-1] is m
    assert NAME in {m["name"] for m in spec.load_cell(CELL).per_layer}
    assert NAME not in {m["name"] for m in spec.load_cell("ikonos-scene-fast").per_layer}


def test_it_reads_the_programs_racing_encode(tmp_path, monkeypatch):
    """The ctx jobs of a small racing encode-tiled, carried to the pool's
    threads, each record a wait no longer than the command ran."""
    from rustyhgi_tpu_torch.ops import native

    if not native.available():
        pytest.skip("the program races ctx only with its native coders")
    from PIL import Image
    from rustyhgi_tpu_torch import cli
    from rustyhgi_tpu_torch.utils import profiling

    Image.fromarray(race_scenes(7, 1, 96, 160, 9.0, 28.8)[0].numpy()).save(tmp_path / "s.tif")
    profiling.enable_spans(spans.CAPACITY)
    since = time.perf_counter_ns()
    rc = cli.main(["encode-tiled", "-i", str(tmp_path / "s.tif"), "-o", str(tmp_path / "s.thgit"),
                   "--tile", "64", "--format", "thgi", "--device", "cpu"])
    assert rc == 0
    records = profiling.spans(since)
    jobs = [s for s in records if s.name in ("coder.ctx", "coder.ctx_mt")]
    command = next(s for s in records if s.name == "cli.encode_tiled")
    assert jobs and all(s.thread and 0 <= s.queued_ns <= command.end_ns - command.start_ns
                        for s in jobs)
    read = _read(records, monkeypatch)
    assert read is not None and read == sum(s.queued_ns for s in jobs) / 1e6
