"""The window's CPU seconds (``core.WindowUsage``): a child reaped inside
the window counts and one reaped after it does not, the deltas of this
process's own threads, the run's result line, and ``spread``'s third set
of runs on other seeds."""

import json
import subprocess
import sys
import time
from types import SimpleNamespace

import pytest

from hgibench import core, run, spec, spread
from hgibench.core import WindowUsage
from hgibench.drivers import closed_loop

BURN = "import time\nt = time.process_time()\nwhile time.process_time() - t < {}: pass\n"
KEYS = {"user_s", "sys_s", "read_at_s"}


def _burn(cpu_s):
    subprocess.run([sys.executable, "-c", BURN.format(cpu_s)], check=True, timeout=60)


def test_usage_counts_a_child_reaped_inside_the_window_and_not_one_reaped_after():
    inside, after, seconds = 0.3, 1.0, 3.0
    reaped = []

    def request(state, item):
        if not reaped:
            _burn(inside)
            reaped.append(time.perf_counter())
        else:
            time.sleep(0.05)
        return item

    entry = SimpleNamespace(request=request, account=lambda s, item, out: (1, 1))
    t = time.perf_counter()
    w = closed_loop.run(entry, None, {"pool": 2}, 1, seconds, log=lambda *a: None)
    _burn(after)
    assert reaped[0] - t < seconds  # the first child was reaped inside the window
    u = w.usage
    assert set(u) == KEYS and u["read_at_s"] == pytest.approx(seconds, abs=0.5)
    assert inside <= u["user_s"] + u["sys_s"] < inside + after * 0.8
    # read now, the usage holds the child reaped after the window too
    assert core.usage()["user_s"] - u["user_s"] > after * 0.8


def test_window_usage_deltas_of_this_process():
    usage = WindowUsage(0.2)
    usage.start()
    t = time.process_time()
    while time.process_time() - t < 0.1:
        pass
    time.sleep(0.25)
    out = usage.stop()
    assert set(out) == KEYS
    assert 0.09 <= out["user_s"] + out["sys_s"] < 1.0 and out["read_at_s"] >= 0.2


def test_the_close_is_read_while_a_request_still_runs():
    """The request cut by the window's end runs on past the close; the
    usage is read at the close, not when the loop sees it."""
    seconds, cut = 0.5, 1.5

    def request(state, item):
        t = time.process_time()
        while time.process_time() - t < cut:
            pass
        return item

    entry = SimpleNamespace(request=request)
    w = closed_loop.run(entry, None, {"pool": 1}, 1, seconds, log=lambda *a: None)
    assert w.requests[-1].end > cut
    assert w.usage["read_at_s"] == pytest.approx(seconds, abs=0.2)
    assert w.usage["user_s"] + w.usage["sys_s"] < cut * 0.8


def test_a_run_gives_its_windows_usage_before_the_checks():
    r = run.run_cell("ikonos-scene-fast", 2**31 + 13, 0.5, False, device="cpu",
                     overrides={"config": {"codec": {"height": 300, "width": 530, "tile": 128}}},
                     control=False, t0=time.perf_counter(), bench=spec.load_bench())
    assert r["correct"] and list(r)[-2:] == ["usage", "checks"]
    assert set(r["usage"]) == KEYS and r["usage"]["user_s"] > 0
    json.dumps(r)


def test_spread_reads_a_third_set_on_other_seeds(tmp_path, capsys):
    def run_file(name, value):
        path = tmp_path / name
        path.write_text("log\n" + json.dumps({"metrics": {"m": {"value": value, "unit": "x"}}}) + "\n")
        return str(path)

    a = [run_file(f"a{i}", v) for i, v in enumerate([10, 11, 12, 13, 14, 15])]
    b = [run_file(f"b{i}", v) for i, v in enumerate([10, 10, 12, 12, 14, 14])]
    c = [run_file(f"c{i}", v) for i, v in enumerate([20, 21, 22, 23, 24, 90])]
    assert spread.main(a + ["--"] + b + ["--"] + c) == 0
    line = json.loads(capsys.readouterr().out)
    assert line["median_c"] == 22.5 and line["c"] == [20, 21, 22, 23, 24, 90]
    assert line["trimmed_c"] < line["spread_c"]
    assert spread.main(a + ["--"] + b) == 0
    assert "median_c" not in json.loads(capsys.readouterr().out)
