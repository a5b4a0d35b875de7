"""Port quantizers against rustyhgi_tpu.ops.quantizers, exactly."""

import numpy as np
import pytest
import torch

from rustyhgi_tpu.ops import quantizers as jq

from rustyhgi_tpu_torch.ops import quantizers as tq

PRESETS = list(tq.QuantizationLevel)
STRATEGIES = ["linear", "noop", "lut"]


@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("preset", PRESETS, ids=lambda p: p.name.lower())
def test_all_256_inputs_match(preset, strategy):
    diff = np.arange(256, dtype=np.int32)
    want = np.asarray(jq.quantize_fn(jq.QuantizationLevel(int(preset)), strategy)(diff))
    quant = tq.quantize_fn(preset, strategy)
    got = quant(torch.from_numpy(diff))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want.astype(np.int64))
    # The table the engines take is the same function.
    assert np.array_equal(quant.table.numpy(), want.astype(np.int64))
    ref = jq.quantize_fn(jq.QuantizationLevel(int(preset)), strategy)
    assert quant.error == ref.error
    assert quant.identity == ref.identity


@pytest.mark.parametrize("preset", PRESETS, ids=lambda p: p.name.lower())
def test_table_error_and_closed_form(preset):
    jpreset = jq.QuantizationLevel(int(preset))
    assert int(preset) == int(jpreset) and preset.name == jpreset.name
    assert tq.linear_error(preset) == jq.linear_error(jpreset)
    table = tq.linear_table(preset)
    assert table.dtype == np.uint8
    assert np.array_equal(table, jq.linear_table(jpreset))
    diff = np.arange(256, dtype=np.int32)
    got = tq.linear_quantize(torch.from_numpy(diff), tq.linear_error(preset))
    assert np.array_equal(got.numpy(), jq.linear_quantize(diff, jq.linear_error(jpreset)))


@pytest.mark.parametrize("name", ["lossless", "LOW", "MeDiUm", "high"])
def test_parse(name):
    assert int(tq.QuantizationLevel.parse(name)) == int(jq.QuantizationLevel.parse(name))


def test_parse_and_strategy_errors():
    with pytest.raises(ValueError) as ours:
        tq.QuantizationLevel.parse("nope")
    with pytest.raises(ValueError) as ref:
        jq.QuantizationLevel.parse("nope")
    assert str(ours.value) == str(ref.value)
    with pytest.raises(ValueError, match="unknown quantizer strategy"):
        tq.quantize_fn(tq.QuantizationLevel.MEDIUM, "bogus")
