"""The port's stage timer and trace against the JAX package's profiling module."""

import itertools
import json
import os
import time

import pytest
import torch

from rustyhgi_tpu.utils import profiling as jax_profiling

from rustyhgi_tpu_torch.utils import profiling


def _drive(timer_cls, monkeypatch):
    """The same stages on a fake clock: 1 ms, 2.5 ms, 4 ms and 8 ms."""
    ticks = itertools.accumulate([0.0, 0.001, 0.0, 0.0025, 0.0, 0.004, 0.0, 0.008])
    monkeypatch.setattr(time, "perf_counter", lambda it=iter(list(ticks)): next(it))
    timer = timer_cls()
    with timer.stage("encode", items=2_073_600):
        pass
    with timer.stage("entropy"):
        pass
    with timer.stage("encode", items=2_073_600):
        pass
    with timer.stage("zero items", items=0):
        pass
    monkeypatch.undo()
    return timer


def test_stage_timer_report_and_str_match_jax(monkeypatch):
    ours = _drive(profiling.StageTimer, monkeypatch)
    ref = _drive(jax_profiling.StageTimer, monkeypatch)
    assert ours.report() == ref.report()
    assert str(ours) == str(ref)
    assert set(ours.report()["encode"]) == {"seconds", "items_per_s"}
    assert "items_per_s" not in ours.report()["entropy"]


@pytest.mark.parametrize(
    "seconds,items",
    [({}, {}), ({"a": 0.5, "b": 0.0}, {"a": 10.0, "b": 3.0}),
     ({"write_hgi (host)": 8.84271}, {"write_hgi (host)": 2073600.0})],
)
def test_stage_timer_formats_like_jax(seconds, items):
    ours, ref = profiling.StageTimer(), jax_profiling.StageTimer()
    for t in (ours, ref):
        t.seconds, t.items = dict(seconds), dict(items)
    assert ours.report() == ref.report()
    assert str(ours) == str(ref)


def test_stage_accumulates_real_time():
    timer = profiling.StageTimer()
    for _ in range(2):
        with timer.stage("sleep", items=1):
            time.sleep(0.01)
    assert timer.seconds["sleep"] >= 0.02
    assert timer.items["sleep"] == 2


def test_trace_writes_a_chrome_trace_on_the_cpu(tmp_path):
    with profiling.trace(str(tmp_path / "t"), device="cpu") as prof:
        (torch.arange(1000) * 3).sum()
    files = os.listdir(tmp_path / "t")
    assert len(files) == 1 and files[0].endswith(".json")
    with open(tmp_path / "t" / files[0]) as f:
        assert "traceEvents" in json.load(f)
    assert len(prof.key_averages()) > 0


def test_device_averages_leave_out_the_spans_marks_on_the_card():
    from types import SimpleNamespace

    from torch.autograd import DeviceType

    def avg(key, device_type=DeviceType.CUDA, self_us=5.0, **kw):
        return SimpleNamespace(key=key, device_type=device_type, self_device_time_total=self_us,
                               **kw)

    kept = [avg("encode_lossless"), avg("Memcpy HtoD (Pageable -> Device)"),
            avg("Memset (Device)", is_user_annotation=False)]
    events = [*kept, avg("hgi.codec.h2d", self_us=900.0),
              avg("hgi.tiles.chunk", self_us=900.0, is_user_annotation=True),
              avg("a range", self_us=900.0, is_user_annotation=True),
              avg("aten::mul", DeviceType.CPU), avg("idle kernel", self_us=0.0)]
    prof = SimpleNamespace(key_averages=lambda: events)
    assert profiling.device_averages(prof) == kept


def test_trace_without_a_directory_writes_nothing(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    with profiling.trace(None, device="cpu") as prof:
        (torch.arange(1000) * 3).sum()
    assert os.listdir(tmp_path) == []
    assert any(e.key == "aten::mul" for e in prof.key_averages())


def test_trace_on_cuda_without_a_card_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        with profiling.trace(str(tmp_path), device="cuda"):
            pass


def test_stage_clock_times_named_functions_and_puts_them_back():
    import types

    from rustyhgi_tpu_torch.utils.profiling import stage_clock

    mod = types.SimpleNamespace(slow=lambda x: time.sleep(0.01) or x + 1, fast=lambda: 0)
    originals = (mod.slow, mod.fast)
    with stage_clock({"slow": (mod, "slow"), "fast": (mod, "fast")}) as spent:
        assert mod.slow(1) == 2 and mod.slow(2) == 3
    assert (mod.slow, mod.fast) == originals
    assert spent["slow"] >= 0.02 and spent["fast"] == 0.0


# -- the span recorder ----------------------------------------------------------


@pytest.fixture
def recorder():
    profiling.enable_spans()
    try:
        yield profiling
    finally:
        profiling.disable_spans()


def test_spans_nest_with_their_parent_and_request(recorder):
    with profiling.span("cli.encode_tiled") as root:
        with profiling.span("tiles.chunk") as chunk:
            with profiling.span("codec.h2d", 64) as h2d:
                pass
            with profiling.span("codec.fetch_words") as fetch:
                fetch.nbytes = 10
    with profiling.span("cli.encode_tiled") as other:
        pass
    got = profiling.spans()
    assert [s.name for s in got] == ["codec.h2d", "codec.fetch_words", "tiles.chunk",
                                     "cli.encode_tiled", "cli.encode_tiled"]
    assert (root.parent, chunk.parent, h2d.parent, fetch.parent) == (None, root.id, chunk.id,
                                                                      chunk.id)
    assert {s.request for s in got[:4]} == {root.id} and other.request == other.id != root.id
    assert [s.depth for s in got] == [2, 2, 1, 0, 0]
    assert (h2d.nbytes, fetch.nbytes, chunk.nbytes) == (64, 10, None)
    assert root.start_ns <= chunk.start_ns <= h2d.start_ns <= h2d.end_ns <= fetch.start_ns
    assert fetch.end_ns <= chunk.end_ns <= root.end_ns <= other.start_ns
    assert profiling.spans(since_ns=other.start_ns) == [other]


def test_a_span_that_raises_is_recorded_and_closed(recorder):
    with pytest.raises(ValueError):
        with profiling.span("codec.frame"):
            raise ValueError("bad block")
    with profiling.span("codec.frame") as after:
        pass
    assert [s.name for s in profiling.spans()] == ["codec.frame"] * 2
    assert after.parent is None and after.depth == 0


@pytest.mark.parametrize("capacity", [1, 3, 8])
def test_the_ring_keeps_the_newest_spans(recorder, capacity):
    profiling.enable_spans(capacity)
    for i in range(10):
        with profiling.span(f"s{i}"):
            pass
    assert [s.name for s in profiling.spans()] == [f"s{i}" for i in range(10 - capacity, 10)]
    with pytest.raises(ValueError, match="capacity"):
        profiling.enable_spans(0)


def test_self_time_is_the_duration_less_the_children():
    def made(i, parent, a, b):
        s = profiling.Span(f"s{i}")
        s.id, s.parent, s.start_ns, s.end_ns = i, parent, a, b
        return s

    records = [made(1, None, 0, 1000), made(2, 1, 100, 400), made(3, 1, 500, 700),
               made(4, 2, 150, 250), made(5, 99, 0, 50)]
    assert profiling.self_ns(records) == {1: 500, 2: 200, 3: 200, 4: 100, 5: 50}


def _made(i, parent, a, b):
    s = profiling.Span(f"s{i}")
    s.id, s.parent, s.start_ns, s.end_ns = i, parent, a, b
    return s


@pytest.mark.parametrize("children, own", [
    ([(100, 400), (300, 700)], 400),  # two that overlap: their union is 600
    ([(100, 400), (150, 250), (500, 700)], 500),  # one inside another
    ([(-50, 200), (900, 1300)], 700),  # cut to the parent's interval
    ([(100, 900), (100, 900), (100, 900), (100, 900)], 200),  # four pool threads at once
], ids=["overlap", "nested", "outside", "four-at-once"])
def test_self_time_leaves_out_the_union_of_overlapping_children(children, own):
    records = [_made(1, None, 0, 1000)]
    records += [_made(i + 2, 1, a, b) for i, (a, b) in enumerate(children)]
    got = profiling.self_ns(records)
    assert got[1] == own
    assert all(got[i + 2] == b - a for i, (a, b) in enumerate(children))


def test_a_job_on_a_pool_runs_its_spans_under_the_submitter(recorder):
    from concurrent.futures import ThreadPoolExecutor

    def job(k):
        with profiling.span("coder.rans", k) as inner:
            with profiling.span("coder.inner"):
                time.sleep(0.05 if k == 0 else 0)
        return inner

    # One thread, so the second job waits for the first to end; carried
    # once, as write_thgi does, so every job's wait counts from one stamp.
    with ThreadPoolExecutor(1) as pool:
        with profiling.span("cli.encode_tiled") as root:
            with profiling.span("tiles.race") as race:
                carried = profiling.carry(job)
                jobs = [pool.submit(carried, k) for k in range(4)]
                spans = [f.result() for f in jobs]
            with profiling.span("tiles.frame") as after:
                pass
        outside = pool.submit(profiling.carry(job), 9).result()
    for k, s in enumerate(spans):
        assert (s.parent, s.request, s.depth, s.thread, s.nbytes) == (race.id, root.id, 2, True, k)
        assert 0 <= s.queued_ns <= s.start_ns - race.start_ns
    ran = spans[0].end_ns - spans[0].start_ns
    assert spans[1].queued_ns >= ran >= 50_000_000 and spans[0].queued_ns < ran // 2
    inner = [s for s in profiling.spans() if s.name == "coder.inner"]
    assert len(inner) == 5 and {s.parent for s in inner[:4]} == {s.id for s in spans}
    assert all(s.thread and s.depth == 3 and s.request == root.id for s in inner[:4])
    assert not (root.thread or race.thread or after.thread) and after.parent == root.id
    # Submitted outside any span, a job's spans are its own requests.
    assert (outside.parent, outside.request, outside.thread) == (None, outside.id, False)
    # Only a span opened on a carried job's base waited in the queue.
    assert all(s.queued_ns is None for s in inner + [root, race, after, outside])


def test_a_carried_job_leaves_the_pool_thread_as_it_found_it(recorder):
    from concurrent.futures import ThreadPoolExecutor

    def fails():
        with profiling.span("coder.ctx"):
            raise ValueError("refused")

    def job():
        with profiling.span("coder.rans") as s:
            pass
        return s

    with ThreadPoolExecutor(1) as pool:
        with profiling.span("tiles.race") as race:
            with pytest.raises(ValueError):
                pool.submit(profiling.carry(fails)).result()
            carried = pool.submit(profiling.carry(job)).result()
        alone = pool.submit(profiling.carry(job)).result()  # outside any span
    assert (carried.parent, carried.thread) == (race.id, True)
    assert (alone.parent, alone.request, alone.depth, alone.thread) == (None, alone.id, 0, False)
    failed = next(s for s in profiling.spans() if s.name == "coder.ctx")
    assert failed.parent == race.id and failed.end_ns >= failed.start_ns


def test_off_the_submit_path_hands_over_the_job_itself_and_allocates_nothing():
    import tracemalloc

    def job():
        return 1

    assert profiling.carry(job) is job
    with profiling.span("tiles.race"):
        assert profiling.carry(job) is job
    tracemalloc.start()
    try:
        before = tracemalloc.take_snapshot()
        for _ in range(1000):
            profiling.carry(job)
        after = tracemalloc.take_snapshot()
    finally:
        tracemalloc.stop()
    mine = [tracemalloc.Filter(True, profiling.__file__)]
    grown = after.filter_traces(mine).compare_to(before.filter_traces(mine), "lineno")
    assert sum(d.size_diff for d in grown) == 0


def test_off_records_nothing_and_returns_one_shared_context(monkeypatch):
    def no_clock():
        raise AssertionError("a span read the clock while nothing records")

    monkeypatch.setattr(time, "perf_counter_ns", no_clock)
    assert profiling.spans() == []
    a, b = profiling.span("codec.h2d", 5), profiling.span("tiles.write")
    assert a is b is profiling._NO_SPAN
    with a as s:
        s.nbytes = 123  # dropped
    assert s.nbytes is None and profiling.spans() == []
    assert not hasattr(s, "__dict__")



def test_device_timers_on_the_cpu(monkeypatch):
    calls = []
    samples = profiling.device_samples(lambda: calls.append(1), 3, "cpu")
    assert len(calls) == 4  # one warm-up call, then the timed ones
    assert len(samples) == 3 and all(t >= 0 for t in samples)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert profiling.device_trace(lambda: calls.append(1)) == {}
    assert len(calls) == 4
    assert profiling.kernel_launches({}) is None
