"""The port's criterion suite against ``rustyhgi_tpu/utils/benchsuite.py``."""

import numpy as np
import pytest
import torch

from rustyhgi_tpu.utils import benchsuite as jax_bs

from rustyhgi_tpu_torch.ops import cuda_codec
from rustyhgi_tpu_torch.ops.quantizers import QuantizationLevel, quantize_fn
from rustyhgi_tpu_torch.utils import benchsuite


@pytest.fixture
def small(monkeypatch):
    """A 48x32 image in both modules, so that a whole suite runs in seconds."""
    for mod in (benchsuite, jax_bs):
        monkeypatch.setattr(mod, "W", 48)
        monkeypatch.setattr(mod, "H", 32)


def test_synthetic_image_matches_jax():
    assert (benchsuite.W, benchsuite.H, benchsuite.LEVELS) == (jax_bs.W, jax_bs.H, jax_bs.LEVELS)
    assert np.array_equal(benchsuite.synthetic(benchsuite.W, benchsuite.H), jax_bs._synthetic())


def test_host_samples_times_each_call():
    calls = []
    ts = benchsuite.host_samples(lambda: calls.append(1), 4)
    assert len(ts) == len(calls) == 4 and all(t >= 0 for t in ts)


@pytest.mark.parametrize(
    "times,npix",
    [([0.001, 0.002, 0.004], 2073600), ([0.5, 0.0, -1.0, 0.25], 100),
     ([0.0, 0.0], 7), (np.random.default_rng(3).random(25), 16588800)],
    ids=["three", "non-positive", "none-left", "25-samples"],
)
def test_stat_matches_jax(times, npix):
    assert benchsuite._stat(times, npix) == jax_bs._stat(times, npix)


@pytest.mark.parametrize(
    "results",
    [
        {"memory": {"mpix_s": 123456.7, "mpix_s_min": 1.0, "mpix_s_max": 2e6},
         "crossed_nop_encode": {"mpix_s": 0.04, "mpix_s_min": 0.0, "mpix_s_max": 9.99}},
        {"decode": 1234.5, "compression": 0.5},
    ],
    ids=["stats", "medians"],
)
def test_format_suite_matches_jax(results):
    assert benchsuite.format_suite(results) == jax_bs.format_suite(results)


def test_suite_names_match_jax(small, monkeypatch):
    # The JAX suite's device rows need chained jit slopes; their timing is
    # not what is compared here, only the rows it yields.
    monkeypatch.setattr(jax_bs, "_device_step_samples", lambda *a, **k: [1e-3] * 3)
    want = list(jax_bs.run_suite_stats(batch=1, samples=1))
    ours = benchsuite.run_suite_stats(device="cpu", batch=1, samples=1)
    assert list(ours) == want == list(benchsuite.SUITE)


def test_nop_rows_pass_no_table_and_quanted_rows_pass_one(small, monkeypatch):
    calls = []
    real = cuda_codec.encode_plane

    def spy(image, levels, table=None, predictor="crossed"):
        calls.append((predictor, table))
        return real(image, levels, table, predictor)

    monkeypatch.setattr(cuda_codec, "encode_plane", spy)
    samples = 2
    benchsuite.run_suite_stats(device="cpu", batch=2, samples=samples)
    per_row = samples + 1  # the warm-up, then the timed calls
    rows = [calls[i * per_row:(i + 1) * per_row] for i in range(4)]
    for (pred, quanted), row in zip(
        [("left_top", False), ("left_top", True), ("crossed", False), ("crossed", True)], rows
    ):
        assert {p for p, _ in row} == {pred}
        if quanted:
            # The Lossless LUT: a real table, so K1's closed-loop template.
            assert all(t is not None and torch.equal(t, torch.arange(256, dtype=torch.int32))
                       for _, t in row)
        else:
            assert all(t is None for _, t in row)
    assert quantize_fn(QuantizationLevel.LOSSLESS, "lut").identity is False
    assert quantize_fn(QuantizationLevel.LOSSLESS, "noop").identity is True


def test_run_suite_stats_on_the_cpu_gives_positive_rates(small):
    stats = benchsuite.run_suite_stats(device="cpu", batch=2, samples=3)
    assert list(stats) == list(benchsuite.SUITE)
    for name, s in stats.items():
        assert 0 < s["mpix_s_min"] <= s["mpix_s"] <= s["mpix_s_max"], name
    medians = benchsuite.run_suite(device="cpu", batch=1)
    assert list(medians) == list(benchsuite.SUITE) and min(medians.values()) > 0


def test_cuda_without_a_card_raises(small, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        benchsuite.run_suite_stats(batch=1, samples=1)
