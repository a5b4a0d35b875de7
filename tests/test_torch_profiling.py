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
