"""The port's oracle against the JAX package's: bit for bit, name for name.

``rustyhgi_tpu_torch.oracle`` is a copy of ``rustyhgi_tpu.oracle`` that
the port's users read without JAX; the port's other tests keep holding
the port against the JAX package's oracle.
"""

import numpy as np
import pytest

from rustyhgi_tpu import oracle as jax_oracle
from rustyhgi_tpu.ops.quantizers import QuantizationLevel as JQL

from rustyhgi_tpu_torch import oracle
from rustyhgi_tpu_torch.ops.quantizers import QuantizationLevel

PRESETS = list(QuantizationLevel)
PREDICTORS = ["crossed", "left_top"]
SHAPES = [(1, 1), (2, 3), (17, 1), (1, 17), (37, 61), (40, 56)]
RAGGED = (45, 83)


def _plane(shape, seed=0):
    return np.random.default_rng([seed, *shape]).integers(0, 256, shape, dtype=np.uint8)


def _both(image, levels, preset, pred):
    """(ours, the JAX package's) grid of ``image``, each with its decode."""
    ours = oracle.oracle_encode(image, levels, preset, predictor=pred)
    ref = jax_oracle.oracle_encode(image, levels, JQL(int(preset)), predictor=pred)
    return (ours, oracle.oracle_decode(ours, levels, predictor=pred)), \
        (ref, jax_oracle.oracle_decode(ref, levels, predictor=pred))


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("preset", PRESETS, ids=lambda p: p.name.lower())
@pytest.mark.parametrize("pred", PREDICTORS)
def test_encode_and_decode_equal_the_jax_oracle(shape, preset, pred):
    image = _plane(shape)
    for levels in (0, 1, 2, 4):
        (grid, plane), (want_grid, want_plane) = _both(image, levels, preset, pred)
        assert grid.dtype == np.uint8 and grid.shape == shape
        assert np.array_equal(grid, want_grid), levels
        assert np.array_equal(plane, want_plane), levels
        if preset == QuantizationLevel.LOSSLESS:
            assert np.array_equal(plane, image), levels


@pytest.mark.parametrize("levels", range(9))
@pytest.mark.parametrize("preset", PRESETS, ids=lambda p: p.name.lower())
@pytest.mark.parametrize("pred", PREDICTORS)
def test_a_ragged_plane_at_every_depth(levels, preset, pred):
    image = _plane(RAGGED, 1)
    (grid, plane), (want_grid, want_plane) = _both(image, levels, preset, pred)
    assert np.array_equal(grid, want_grid)
    assert np.array_equal(plane, want_plane)
    err = np.abs(plane.astype(np.int64) - image).max()
    assert err <= oracle.oracle_max_error(preset)


@pytest.mark.parametrize("pred", PREDICTORS)
@pytest.mark.parametrize("levels", [1, 3, 5])
def test_decode_of_any_grid_equals_the_jax_oracle(pred, levels):
    # Every byte grid decodes, not only an encoder's output.
    grid = _plane(RAGGED, 2)
    assert np.array_equal(oracle.oracle_decode(grid, levels, predictor=pred),
                          jax_oracle.oracle_decode(grid, levels, predictor=pred))


@pytest.mark.parametrize("preset", PRESETS, ids=lambda p: p.name.lower())
def test_max_error_equals_the_jax_oracle(preset):
    assert oracle.oracle_max_error(preset) == jax_oracle.oracle_max_error(JQL(int(preset)))
    assert oracle.oracle_max_error(preset) == {0: 0, 1: 10, 2: 20, 3: 30}[int(preset)]


@pytest.mark.parametrize("levels", [1, 2, 3])
def test_traversal_and_predictions_equal_the_jax_oracle(levels):
    image = _plane((13, 22), 3)
    for level in range(levels):
        want = list(jax_oracle.traverse_level_coords(level, levels, 22, 13))
        assert list(oracle.traverse_level_coords(level, levels, 22, 13)) == want
        step = 1 << (levels - level)
        for x, y in want:
            assert oracle.crossed_prediction(image, x, y, step) == \
                jax_oracle.crossed_prediction(image, x, y, step)
            assert oracle.left_top_prediction(image, x, y, step) == \
                jax_oracle.left_top_prediction(image, x, y, step)


def test_names_and_signatures_are_the_jax_oracles():
    import inspect

    names = ("traverse_level_coords", "left_top_prediction", "crossed_prediction",
             "oracle_encode", "oracle_decode", "oracle_max_error")
    for name in names:
        ours = inspect.signature(getattr(oracle, name))
        ref = inspect.signature(getattr(jax_oracle, name))
        assert list(ours.parameters) == list(ref.parameters), name
        assert [p.default for p in ours.parameters.values()] == \
            [p.default for p in ref.parameters.values()], name
    assert oracle.__all__ == jax_oracle.__all__

