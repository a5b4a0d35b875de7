"""The port's plain engine against the JAX package's oracle and engines.

Inputs come from numpy seeds and go to both packages; the tolerance is
exact equality, since the codec is integer and its contract is
bit-exactness.  The JAX Pallas kernels run in interpret mode on the CPU,
as tests/test_pallas_codec.py runs them.
"""

import functools

import jax
import numpy as np
import pytest
import torch

from rustyhgi_tpu import dyadic as jdyadic
from rustyhgi_tpu.oracle import (
    crossed_prediction,
    left_top_prediction,
    oracle_decode,
    oracle_encode,
)
from rustyhgi_tpu.ops import predictors as jpredictors
from rustyhgi_tpu.ops import pyramid as jpyramid
from rustyhgi_tpu.ops.pallas_codec import decode_plane_pallas, encode_plane_pallas
from rustyhgi_tpu.ops.quantizers import QuantizationLevel as JQL
from rustyhgi_tpu.ops.quantizers import quantize_fn as jquantize_fn

from rustyhgi_tpu_torch import dyadic
from rustyhgi_tpu_torch.ops import cuda_codec, predictors, pyramid
from rustyhgi_tpu_torch.ops.quantizers import QuantizationLevel, quantize_fn

SHAPES = [(1, 1), (1, 7), (37, 53), (64, 64), (130, 68), (300, 52)]
LEVELS = [0, 1, 2, 3, 4, 8, 16]
PREDICTORS = ["crossed", "left_top"]


def _image(shape, seed=0):
    return np.random.default_rng([seed, *shape]).integers(0, 256, shape, dtype=np.uint8)


def _table(preset):
    q = quantize_fn(preset)
    return None if q.identity else q.table


@functools.lru_cache(maxsize=None)
def _oracle(shape, levels, preset, pred):
    grid = oracle_encode(_image(shape), levels, JQL(int(preset)), pred)
    return grid, oracle_decode(grid, levels, pred)


@pytest.mark.parametrize("pred", PREDICTORS)
@pytest.mark.parametrize("preset", list(QuantizationLevel), ids=lambda p: p.name.lower())
@pytest.mark.parametrize("levels", LEVELS)
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_plain_engine_matches_oracle(shape, levels, preset, pred):
    grid_o, dec_o = _oracle(shape, levels, preset, pred)
    img = torch.from_numpy(_image(shape))
    grid, recon = pyramid.encode_plane(img, levels, _table(preset), pred)
    assert grid.dtype == recon.dtype == torch.uint8
    assert np.array_equal(grid.numpy(), grid_o)
    assert np.array_equal(recon.numpy(), dec_o)
    dec = pyramid.decode_plane(torch.from_numpy(grid_o), levels, pred)
    assert np.array_equal(dec.numpy(), dec_o)


@pytest.mark.parametrize("pred", PREDICTORS)
@pytest.mark.parametrize(
    "preset", [QuantizationLevel.LOSSLESS, QuantizationLevel.HIGH], ids=["lossless", "high"]
)
def test_batch_matches_per_plane(preset, pred):
    imgs = np.stack([_image((37, 53), seed) for seed in range(3)])
    grid, recon = pyramid.encode_plane(torch.from_numpy(imgs), 4, _table(preset), pred)
    dec = pyramid.decode_plane(grid, 4, pred)
    for i in range(3):
        g1, r1 = pyramid.encode_plane(torch.from_numpy(imgs[i]), 4, _table(preset), pred)
        assert torch.equal(grid[i], g1)
        assert torch.equal(recon[i], r1)
        assert torch.equal(dec[i], pyramid.decode_plane(g1, 4, pred))


@pytest.mark.parametrize("shape", [(37, 53), (3, 37, 53), (0, 0)])
def test_wrappers_take_the_plain_version_on_cpu(shape):
    img = torch.from_numpy(_image(shape))
    table = _table(QuantizationLevel.MEDIUM)
    before = (cuda_codec.encode_launches, cuda_codec.decode_launches)
    grid, recon = cuda_codec.encode_plane(img, 4, table)
    want = pyramid.encode_plane(img, 4, table)
    assert torch.equal(grid, want[0]) and torch.equal(recon, want[1])
    assert torch.equal(cuda_codec.decode_plane(grid, 4), pyramid.decode_plane(grid, 4))
    assert (cuda_codec.encode_launches, cuda_codec.decode_launches) == before


_JAX_CASES = [
    ((37, 53), QuantizationLevel.LOSSLESS, "crossed"),
    ((37, 53), QuantizationLevel.MEDIUM, "left_top"),
    ((130, 68), QuantizationLevel.MEDIUM, "crossed"),
]


@pytest.mark.parametrize("shape,preset,pred", _JAX_CASES)
def test_matches_jax_dyadic_engine(shape, preset, pred):
    img = _image(shape)
    quant = jquantize_fn(JQL(int(preset)))
    jpred = jpredictors.predictor_fn(pred)
    grid_j, recon_j = jax.jit(lambda x: jpyramid.encode_plane(x, 3, quant, jpred))(img)
    dec_j = jax.jit(lambda g: jpyramid.decode_plane(g, 3, jpred))(grid_j)
    grid, recon = pyramid.encode_plane(torch.from_numpy(img), 3, _table(preset), pred)
    assert np.array_equal(grid.numpy(), np.asarray(grid_j))
    assert np.array_equal(recon.numpy(), np.asarray(recon_j))
    dec = pyramid.decode_plane(grid, 3, pred)
    assert np.array_equal(dec.numpy(), np.asarray(dec_j))


@pytest.mark.parametrize("shape,preset,pred", _JAX_CASES)
def test_matches_pallas_kernels_interpreted(shape, preset, pred):
    img = _image(shape)
    quant = jquantize_fn(JQL(int(preset)))
    grid_j, recon_j = encode_plane_pallas(img, 3, quant, pred)
    dec_j = decode_plane_pallas(np.asarray(grid_j), 3, pred)
    grid, recon = pyramid.encode_plane(torch.from_numpy(img), 3, _table(preset), pred)
    assert np.array_equal(grid.numpy(), np.asarray(grid_j))
    assert np.array_equal(recon.numpy(), np.asarray(recon_j))
    dec = pyramid.decode_plane(grid, 3, pred)
    assert np.array_equal(dec.numpy(), np.asarray(dec_j))


def test_dyadic_helpers_match():
    for h in range(0, 70):
        for w in (0, 1, 2, 3, 5, 8, 31, 64, 65, 1920):
            if (h == 0) != (w == 0):
                continue
            for levels in range(18):
                assert dyadic.effective_levels(levels, h, w) == jdyadic.effective_levels(
                    levels, h, w
                )
    for a in range(-5, 40):
        for b in (1, 2, 3, 7, 16):
            assert dyadic.cdiv(a, b) == jdyadic.cdiv(a, b)
    # levels=16 on a small plane clamps before any 1 << levels canvas.
    assert dyadic.effective_levels(16, 37, 53) == 6


def test_trees_match_the_oracle():
    rng = np.random.default_rng(5)
    corners = rng.integers(0, 256, (4, 2048)).astype(np.int32)
    corners[:, :4] = np.array([[255] * 4, [0] * 4, [255, 0, 255, 0], [1, 2, 3, 4]]).T
    got = predictors.tree_crossed(*(torch.from_numpy(c) for c in corners)).numpy()
    cell = np.zeros((3, 3), np.uint8)
    for k in range(corners.shape[1]):
        cell[0, 0], cell[0, 2], cell[2, 0], cell[2, 2] = corners[:, k]
        assert got[k] == crossed_prediction(cell, 1, 0, 2)
        assert left_top_prediction(cell, 1, 1, 2) == corners[0, k]
    tl = torch.from_numpy(corners[0])
    assert torch.equal(predictors.tree_left_top(tl, None, None, None), tl)


@pytest.mark.parametrize("name", PREDICTORS)
def test_predictor_tags_match(name):
    assert predictors.predictor_tag(name) == jpredictors.predictor_tag(name)
    for tag in range(4):
        assert predictors.predictor_name_for_tag(tag) == jpredictors.predictor_name_for_tag(tag)
    with pytest.raises(ValueError, match="unknown predictor"):
        predictors.check_predictor("bilinear")


@pytest.mark.parametrize(
    "bad", [torch.zeros(4, 4, dtype=torch.int32), torch.zeros(8, dtype=torch.uint8),
            torch.zeros(1, 1, 4, 4, dtype=torch.uint8)],
    ids=["int32", "rank1", "rank4"],
)
def test_plain_engine_rejects_bad_input(bad):
    with pytest.raises(ValueError):
        pyramid.encode_plane(bad, 2)
    with pytest.raises(ValueError):
        pyramid.decode_plane(bad, 2)
