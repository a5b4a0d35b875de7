"""The port's bench (``python -m rustyhgi_tpu_torch.bench``) against the root
``bench.py``, and its scalar C++ baseline against the JAX package's."""

import json

import numpy as np
import pytest
import torch

import bench as jax_bench
from rustyhgi_tpu.oracle import oracle_decode, oracle_encode
from rustyhgi_tpu.ops import native as jax_native

from rustyhgi_tpu_torch import bench
from rustyhgi_tpu_torch.ops import native
from rustyhgi_tpu_torch.ops.quantizers import QuantizationLevel

@pytest.mark.parametrize("wh", [(1920, 1080), (61, 37), (1, 1)])
def test_synthetic_matches_root_bench(wh):
    assert np.array_equal(bench.synthetic(*wh), jax_bench.synthetic(*wh))


@pytest.mark.parametrize("shape", [(37, 53), (1, 7), (9, 1), (64, 96), (33, 17)])
@pytest.mark.parametrize("levels", [0, 1, 4, 8])
@pytest.mark.parametrize("preset", list(QuantizationLevel), ids=lambda p: p.name.lower())
def test_native_codec_matches_jax_and_the_oracle(shape, levels, preset):
    if not (native.available() and jax_native.available()):
        pytest.skip("native/librustyhgi.so cannot be built here")
    img = np.random.default_rng([levels, *shape]).integers(0, 256, shape, dtype=np.uint8)
    grid = native.native_encode(img, levels, preset)
    assert np.array_equal(grid, jax_native.native_encode(img, levels, preset))
    assert np.array_equal(grid, oracle_encode(img, levels, preset))
    out = native.native_decode(grid, levels)
    assert np.array_equal(out, jax_native.native_decode(grid, levels))
    assert np.array_equal(out, oracle_decode(grid, levels))


@pytest.fixture
def small(monkeypatch):
    """Every row group at a size the CPU runs in seconds."""
    for name, value in (("W", 64), ("H", 48), ("BATCH", 2), ("SWEEP_H", 40),
                        ("SWEEP_W", 56), ("ENTROPY_PLANES", 2)):
        monkeypatch.setattr(bench, name, value)


def test_main_on_the_cpu_writes_every_row_group(small, tmp_path, capsys):
    details = tmp_path / "d" / "details.json"
    assert bench.main(["--device", "cpu", "--rounds", "1", "--details", str(details)]) == 0
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(last) == {"metric", "value", "unit", "vs_baseline"}
    assert last["metric"] == "encode_throughput_lossless_l4" and last["unit"] == "MPix/s"
    assert last["value"] > 0
    d = json.loads(details.read_text())
    assert d["device"] == "cpu" and d["card"] is None
    shapes = ("2x48x64", "1x48x64")
    for group, rows in (
        ("engines", ("cuda_grid", "cuda_subband", "torch_grid", "torch_subband")),
        ("aux", ("cuda_decode_grid", "torch_decode_grid", "cuda_encode_grid_medium",
                 "torch_encode_grid_medium", "cuda_encode_subband_medium")),
        ("subband_decode", ("cuda_decode_subband", "torch_decode_subband")),
    ):
        assert set(d[group]) == {f"{r} {s}" for r in rows for s in shapes}, group
        for row in d[group].values():
            assert row["median_mpix_s"] > 0 and len(row["samples"]) == 1
            assert row["device_ms"] is None  # no device time on the CPU
    assert d["headline_engine"].endswith(" 2x48x64")
    assert d["headline_mpix_s"] == d["engines"][d["headline_engine"]]["median_mpix_s"]
    assert set(d["level_sweep"]) == {str(lv) for lv in range(1, 9)}
    assert all(r["engine"] == "torch" and r["mpix_s"] > 0 for r in d["level_sweep"].values())
    assert set(d["lena_container_bytes"]) == {"lossless", "medium"}
    e = d["entropy_MBps"]
    for key in ("rans_MBps", "rans_mt_MBps", "deflate9_MBps", "ctx_MBps", "ctx_mt_MBps",
                "e2e_rans_mpix_s", "e2e_fast_mpix_s", "e2e_fast_batch_mpix_s",
                "rans_tpu_payload_vs_host_rans", "rans_tpu_host_MBps"):
        assert e[key] > 0, key
    decomp = e["e2e_decomp"]
    assert set(decomp) == {"e2e_fast", "e2e_fast_batch", "e2e_rans"}
    assert decomp["e2e_rans"]["link_bytes"] == 48 * 64
    for name in ("e2e_fast", "e2e_fast_batch"):
        # The exact fetch: tables, counts and states, then the coded words,
        # which the payload holds with its framing.
        assert 0 < decomp[name]["link_bytes"] < decomp[name]["payload_bytes"] + 4096
    if native.available():
        assert last["vs_baseline"] > 0
        assert set(d["baseline_scalar_cpp"]) == {"encode_mpix_s", "decode_mpix_s"}


def test_lena_sizes_match_the_manifest():
    with open(bench.LENA_GOLDEN.replace("lena_l4_lossless.hgi", "manifest.json")) as f:
        manifest = json.load(f)
    sizes = bench.lena_sizes("cpu")
    for preset in ("lossless", "medium"):
        entry = manifest[f"lena_l4_{preset}"]
        assert sizes[preset]["hgi"] == entry["hgi_bytes"]
        if native.available():  # the .thgi race needs the native ctx coder
            assert sizes[preset]["thgi"] == entry["thgi_bytes"]


def test_cuda_seconds_per_call_remeasures_below_the_floor_and_never_clamps(monkeypatch):
    seen = []

    def samples(fn, iters, device):
        seen.append(iters)
        return [1e-9] * iters

    monkeypatch.setattr(bench.profiling, "device_samples", samples)
    with pytest.raises(RuntimeError, match="below the bytes floor"):
        bench.cuda_seconds_per_call(lambda: None, "cpu", floor_bytes=10**9)
    assert seen == [bench.REPEATS] * bench.RETRIES
    assert bench.cuda_seconds_per_call(lambda: None, "cpu", floor_bytes=1) == 1e-9


def test_scalar_baseline_without_the_native_library(monkeypatch):
    monkeypatch.setattr(native, "available", lambda: False)
    image = bench.synthetic(64, 48)
    with pytest.raises(RuntimeError, match="scalar C\\+\\+ baseline needs"):
        bench.scalar_baseline(image, "cuda")  # the card's headline needs its ratio
    assert bench.scalar_baseline(image, "cpu") == {}


def test_default_device_without_a_card_raises(small, monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bench.main(["--rounds", "1", "--details", str(tmp_path / "d.json")])
    assert not (tmp_path / "d.json").exists()
