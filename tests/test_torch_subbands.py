"""The port's subband layout against the JAX package's, bit for bit.

``encode_subbands``, ``decode_subbands``, ``decode_preview``,
``assemble_grid`` and ``split_grid`` of the port's plain engine
(``ops/pyramid.py``) and of ``HGICodec`` against the JAX engine
(``rustyhgi_tpu/ops/pyramid.py``) and its Pallas kernels K3-K5 in
interpret mode, as tests/test_pallas_codec.py runs them.  Inputs come
from numpy seeds; the tolerance is exact equality, the residuals in the
canvas padding included.  The CUDA kernels' own tests are in
test_torch_cuda.py.
"""

import functools

import numpy as np
import pytest
import torch

import rustyhgi_tpu as jhgi
from rustyhgi_tpu.ops import pyramid as jpyramid
from rustyhgi_tpu.ops.pallas_codec import (
    assemble_grid_pallas,
    decode_subbands_pallas,
    encode_subbands_pallas,
)
from rustyhgi_tpu.ops.predictors import predictor_fn
from rustyhgi_tpu.ops.quantizers import QuantizationLevel as JQL
from rustyhgi_tpu.ops.quantizers import quantize_fn as jquantize_fn

import rustyhgi_tpu_torch as hgi
from rustyhgi_tpu_torch.ops import cuda_codec, pyramid
from rustyhgi_tpu_torch.ops.quantizers import QuantizationLevel, quantize_fn
from rustyhgi_tpu_torch.utils.container import split_grid_np

SHAPES = [(37, 53), (17, 29), (1, 7), (7, 1), (0, 0), (3, 40, 56)]
LEVELS = [0, 1, 2, 4, 8]
PREDICTORS = ["crossed", "left_top"]
ids = functools.partial(map, lambda s: "x".join(map(str, s)))


def _image(shape, seed=0):
    return np.random.default_rng([seed, *shape]).integers(0, 256, shape, dtype=np.uint8)


def _table(preset):
    q = quantize_fn(preset)
    return None if q.identity else q.table


def _np_layout(anchors, subbands):
    return np.asarray(anchors), [tuple(np.asarray(q) for q in quads) for quads in subbands]


def _assert_layout_equal(ours, ref):
    (a1, s1), (a2, s2) = _np_layout(*ours), _np_layout(*ref)
    assert a1.dtype == a2.dtype == np.uint8
    assert np.array_equal(a1, a2), "anchors"
    assert len(s1) == len(s2), "levels"
    for level, (q1s, q2s) in enumerate(zip(s1, s2)):
        for k, (q1, q2) in enumerate(zip(q1s, q2s)):
            assert q1.shape == q2.shape and np.array_equal(q1, q2), ("quad", level, k)


@functools.lru_cache(maxsize=None)
def _jax_encode(shape, levels, preset, pred):
    a, s, r = jpyramid.encode_subbands(
        _image(shape), levels, jquantize_fn(JQL(int(preset))), predictor_fn(pred)
    )
    return _np_layout(a, s) + (np.asarray(r),)


def _layout_tensors(anchors, subbands):
    return torch.tensor(anchors), [tuple(map(torch.tensor, q)) for q in subbands]


@pytest.mark.parametrize("pred", PREDICTORS)
@pytest.mark.parametrize("shape", SHAPES, ids=list(ids(SHAPES)))
def test_encode_subbands_matches_jax(shape, pred):
    img = torch.from_numpy(_image(shape))
    for levels in LEVELS:
        for preset in QuantizationLevel:
            a, s, r = pyramid.encode_subbands(img, levels, _table(preset), pred)
            ja, js, jr = _jax_encode(shape, levels, preset, pred)
            _assert_layout_equal((a, s), (ja, js))
            assert np.array_equal(r.numpy(), jr), (levels, preset)
            a2, s2, none = pyramid.encode_subbands(img, levels, _table(preset), pred, False)
            assert none is None
            _assert_layout_equal((a2, s2), (ja, js))


@pytest.mark.parametrize("pred", PREDICTORS)
@pytest.mark.parametrize("shape", SHAPES, ids=list(ids(SHAPES)))
def test_decode_subbands_and_preview_match_jax(shape, pred):
    hw = shape[-2:]
    for levels in LEVELS:
        for preset in (QuantizationLevel.LOSSLESS, QuantizationLevel.HIGH):
            ja, js, jr = _jax_encode(shape, levels, preset, pred)
            a, s = _layout_tensors(ja, js)
            dec = pyramid.decode_subbands(a, s, hw, levels, pred)
            assert np.array_equal(dec.numpy(), jr)
            for upto in range(len(js) + 2):
                want = jpyramid.decode_preview(ja, js[:upto], hw, levels, upto, predictor_fn(pred))
                got = pyramid.decode_preview(a, s[:upto], hw, levels, upto, pred)
                assert np.array_equal(got.numpy(), np.asarray(want)), (levels, preset, upto)


@pytest.mark.parametrize("shape", SHAPES, ids=list(ids(SHAPES)))
def test_assemble_and_split_grid_match_jax(shape):
    hw = shape[-2:]
    for levels in LEVELS:
        ja, js, _ = _jax_encode(shape, levels, QuantizationLevel.MEDIUM, "crossed")
        a, s = _layout_tensors(ja, js)
        grid = pyramid.assemble_grid(a, s, hw)
        assert np.array_equal(grid.numpy(), np.asarray(jpyramid.assemble_grid(ja, js, hw)))
        want_grid, _ = pyramid.encode_plane(torch.from_numpy(_image(shape)), levels,
                                            _table(QuantizationLevel.MEDIUM))
        assert torch.equal(grid, want_grid)
        _assert_layout_equal(pyramid.split_grid(grid, levels),
                             jpyramid.split_grid(grid.numpy(), levels))


@pytest.mark.parametrize("preset", ["lossless", "medium"])
def test_padding_residuals_are_emitted(preset):
    """17x29 at L3: the canvas padding holds residuals code(0 - pred),
    not the zeros of the host split of the cropped grid."""
    img = torch.from_numpy(_image((17, 29)))
    anchors, subbands, _ = pyramid.encode_subbands(img, 3, _table(QuantizationLevel.parse(preset)))
    grid = pyramid.assemble_grid(anchors, subbands, (17, 29)).numpy()
    host_a, host_s = split_grid_np(grid, 3)
    assert np.array_equal(anchors.numpy(), host_a)
    differ = [int((q.numpy() != h).sum()) for quads, hq in zip(subbands, host_s)
              for q, h in zip(quads, hq)]
    assert differ == [0, 4, 4, 5, 8, 12, 9, 15, 23]


PALLAS_CASES = [
    ((37, 53), 2, QuantizationLevel.LOSSLESS, "crossed"),
    ((17, 29), 3, QuantizationLevel.MEDIUM, "crossed"),
    ((37, 53), 4, QuantizationLevel.HIGH, "left_top"),
    ((3, 40, 56), 4, QuantizationLevel.LOW, "crossed"),
]


@pytest.mark.parametrize("shape,levels,preset,pred", PALLAS_CASES,
                         ids=[f"{'x'.join(map(str, c[0]))}-l{c[1]}-{c[2].name.lower()}-{c[3]}"
                              for c in PALLAS_CASES])
def test_matches_pallas_kernels_in_interpret_mode(shape, levels, preset, pred):
    hw = shape[-2:]
    img = _image(shape)
    a, s, r = pyramid.encode_subbands(torch.from_numpy(img), levels, _table(preset), pred)
    pa, ps, pr = encode_subbands_pallas(img, levels, jquantize_fn(JQL(int(preset))), pred)
    _assert_layout_equal((a, s), (pa, ps))
    assert np.array_equal(r.numpy(), np.asarray(pr))
    grid = pyramid.assemble_grid(a, s, hw)
    assert np.array_equal(grid.numpy(), np.asarray(assemble_grid_pallas(pa, ps, hw, levels)))
    dec = pyramid.decode_subbands(a, s, hw, levels, pred)
    assert np.array_equal(dec.numpy(), np.asarray(decode_subbands_pallas(pa, ps, hw, levels, pred)))


def test_wrappers_take_the_plain_version_for_cpu_tensors():
    img = torch.from_numpy(_image((3, 17, 29)))
    table = _table(QuantizationLevel.MEDIUM)
    counts = (cuda_codec.encode_subbands_launches, cuda_codec.assemble_launches,
              cuda_codec.decode_subbands_launches)
    a, s, r = cuda_codec.encode_subbands(img, 3, table)
    want = pyramid.encode_subbands(img, 3, table)
    _assert_layout_equal((a, s), want[:2])
    assert torch.equal(r, want[2])
    assert torch.equal(cuda_codec.assemble_grid(a, s, (17, 29)), pyramid.assemble_grid(a, s, (17, 29)))
    assert torch.equal(cuda_codec.decode_subbands(a, s, (17, 29), 3), r)
    assert torch.equal(cuda_codec.decode_preview(a, s, (17, 29), 3, 1),
                       pyramid.decode_preview(a, s, (17, 29), 3, 1))
    assert counts == (cuda_codec.encode_subbands_launches, cuda_codec.assemble_launches,
                      cuda_codec.decode_subbands_launches)


def test_wrappers_raise_off_cpu_and_cuda():
    meta = torch.empty(8, 8, dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        cuda_codec.encode_subbands(meta, 2)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        cuda_codec.assemble_grid(meta, [], (8, 8))
    with pytest.raises(ValueError, match="CPU or CUDA"):
        cuda_codec.decode_preview(meta, [], (8, 8), 0, 0)


CODEC_CONFIGS = [
    dict(levels=4, quantization="medium", predictor="crossed"),
    dict(levels=3, quantization="lossless", predictor="left_top"),
    dict(levels=16, quantization="high", predictor="crossed"),
]


@pytest.mark.parametrize("cfg", CODEC_CONFIGS, ids=lambda c: "-".join(map(str, c.values())))
@pytest.mark.parametrize("backend", ["auto", "torch"])
def test_codec_subband_methods_match_jax(cfg, backend):
    ref = jhgi.HGICodec(**cfg)
    ours = hgi.HGICodec(**cfg, backend=backend, device="cpu")
    for img in (_image((37, 53)), _image((2, 17, 29))):
        hw = img.shape[-2:]
        ja, js, jr = ref.encode_subbands(img)
        a, s, r = ours.encode_subbands(img)
        _assert_layout_equal((a, s), (ja, js))
        assert np.array_equal(r.numpy(), np.asarray(jr))
        # The codec takes numpy arrays as the container hands them over.
        na, ns = _np_layout(ja, js)
        assert np.array_equal(ours.decode_subbands(na, ns, hw).numpy(),
                              np.asarray(ref.decode_subbands(ja, js, hw)))
        assert np.array_equal(ours.assemble_grid(na, ns, hw).numpy(),
                              np.asarray(jpyramid.assemble_grid(ja, js, hw)))
        for upto in (0, 2):
            assert np.array_equal(ours.decode_preview(na, ns[:upto], hw, upto).numpy(),
                                  np.asarray(ref.decode_preview(ja, js[:upto], hw, upto)))
