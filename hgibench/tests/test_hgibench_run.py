"""Whole runs of each cell on the CPU at a small size: the result line,
the control (the reference with a guarantee broken, in the program's
place) and planted faults of the program all come out as not correct.
The harness's look for a card is skipped; the program's plain versions
run.  ``cuda`` tests run a short cell on the card."""

import json
import os
import shutil
import subprocess
import sys
import time

import pytest

from hgibench import run, spec

with open(os.path.join(spec.PKG, "tests", "serving_cells.json")) as f:
    BENCH = spec.merge(spec.load_bench(), json.load(f))  # with the serving cells kept for later
SMALL = {
    "fullhd-write-serial": {"config": {"codec": {"height": 96, "width": 160}},
                            "mix": {"pool": 4, "sample": 6, "warmup_s": 0.2}},
    "fullhd-read-serial": {"config": {"codec": {"height": 96, "width": 160}},
                           "mix": {"pool": 4, "sample": 6, "warmup_s": 0.2}},
    "ikonos-scene-fast": {"config": {"codec": {"height": 300, "width": 530, "tile": 128}}},
}
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def _run(cell, trace=False, control=False, seconds=0.5, seed=2**31 + 11):
    return run.run_cell(cell, seed, seconds, trace, device="cpu", overrides=SMALL[cell],
                        control=control, t0=time.perf_counter(), bench=BENCH)


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_a_run_prints_its_result_line(cell):
    r = _run(cell)
    assert list(r)[:5] == KEYS and list(r)[-1] == "checks"
    assert r["correct"] and r["failed"] == 0 and r["attempted"] > 0
    c = spec.load_cell(cell, BENCH)
    assert set(r["metrics"]) == {m["name"] for m in c.end_to_end}
    assert all(v["value"] > 0 for v in r["metrics"].values())
    assert all(v["value"] <= v["limit"] for v in r["checks"].values())
    json.dumps(r)


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_a_traced_run_reads_the_host_timers(cell):
    r = _run(cell, trace=True)
    c = spec.load_cell(cell, BENCH)
    host = {m["name"] for m in c.per_layer if m["source"] == "host_clock"}
    assert r["correct"] and set(r["metrics"]) == host


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_the_control_is_not_correct(cell):
    r = _run(cell, control=True)
    assert not r["correct"]
    assert r["checks"]["max_abs_error"]["value"] > r["checks"]["max_abs_error"]["limit"]


def _altered_archive(monkeypatch):
    from rustyhgi_tpu_torch.models.codec import HGICodec

    write = HGICodec.write_fast

    def altered(self, image):
        blob = bytearray(write(self, image))
        blob[len(blob) // 2] ^= 0x10
        return bytes(blob)

    monkeypatch.setattr(HGICodec, "write_fast", altered)


def _altered_plane(monkeypatch):
    from rustyhgi_tpu_torch.models.codec import HGICodec

    decode = HGICodec.decode

    def altered(self, archive):
        out = decode(self, archive).copy()
        out[5, 7] ^= 1
        return out

    monkeypatch.setattr(HGICodec, "decode", altered)


def _altered_block(monkeypatch):
    from rustyhgi_tpu_torch.models.codec import HGICodec

    batch = HGICodec.write_fast_batch

    def altered(self, images):
        blobs = batch(self, images)
        blobs[-1] = blobs[-1][:-1] + bytes([blobs[-1][-1] ^ 1])
        return blobs

    monkeypatch.setattr(HGICodec, "write_fast_batch", altered)


def _half_the_batch(monkeypatch):
    from rustyhgi_tpu_torch.models.codec import HGICodec

    batch = HGICodec.write_fast_batch

    def halved(self, images):
        half = max(1, len(images) // 2)
        blobs = batch(self, images[:half])
        return [blobs[i % half] for i in range(len(images))]

    monkeypatch.setattr(HGICodec, "write_fast_batch", halved)


@pytest.mark.parametrize("cell, fault", [
    ("fullhd-write-serial", _altered_archive), ("fullhd-read-serial", _altered_plane),
    ("ikonos-scene-fast", _altered_block), ("ikonos-scene-fast", _half_the_batch),
], ids=["write-answer-altered", "read-answer-altered", "scene-answer-altered",
        "scene-half-the-batch"])
def test_a_fault_in_the_program_is_not_correct(cell, fault, monkeypatch):
    fault(monkeypatch)
    r = _run(cell)
    assert not r["correct"]


def test_without_a_card_it_exits_2_and_prints_no_result(capsys):
    torch = pytest.importorskip("torch")
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    assert run.main(["--workload", "ikonos-scene-fast", "--seed", "1", "--seconds", "1"]) == 2
    assert capsys.readouterr().out == ""


def test_without_the_program_it_fails(tmp_path):
    shutil.copy(os.path.join(spec.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(spec.PKG, tmp_path / "hgibench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    env = {k: v for k, v in os.environ.items() if k not in ("PYTHONPATH",)}
    p = subprocess.run([sys.executable, "-m", "hgibench.run", "--workload", "fullhd-write-serial",
                        "--seed", "1", "--seconds", "1"], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode != 0 and p.stdout == ""


@pytest.fixture
def cuda():
    torch = pytest.importorskip("torch")
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("cell", sorted(SMALL))
def test_a_short_run_on_the_card(cell, cuda):
    r = run.run_cell(cell, 3, 1.0, True, device=cuda, overrides=SMALL[cell], t0=time.perf_counter(),
                     bench=BENCH)
    assert r["correct"] and r["device"]["platform"] == "gpu"
    r = run.run_cell(cell, 3, 1.0, False, device=cuda, overrides=SMALL[cell], control=True,
                     t0=time.perf_counter(), bench=BENCH)
    assert not r["correct"]
