"""The design of the tiled decode kernels K2 and K5, as a plain model,
against the JAX package.

Both kernels run only on the card, where ``chip_smoke.py`` and
``tests/test_torch_cuda.py`` hold them against their plain versions.
What runs here is the decomposition they rest on, written out in NumPy
as their launches run it and held against ``rustyhgi_tpu`` with exact
tolerance: the levels coarser than ``2**F`` whole, one launch each, the
first also storing the anchors; then each ``cuda_codec.DECODE_TILES[1]`` tile
on its own over the tile and a right and bottom halo of one ``2**F``
cell, decoded in place from its residuals and the ``2**F`` lattice (the
coarse decode, or the anchors), keeping only the tile's own pixels.  K2
loads its region's residuals from the grid, K5 from the quads of the F
finest levels it decodes (every preview depth ``upto``).
"""

import functools

import numpy as np
import pytest
import torch

from rustyhgi_tpu.oracle import oracle_decode
from rustyhgi_tpu.ops import pyramid as jpyramid
from rustyhgi_tpu.ops.predictors import predictor_fn
from rustyhgi_tpu.ops.quantizers import QuantizationLevel as JQL
from rustyhgi_tpu.ops.quantizers import quantize_fn as jquantize_fn

from rustyhgi_tpu_torch.dyadic import cdiv, effective_levels
from rustyhgi_tpu_torch.ops import cuda_codec
from rustyhgi_tpu_torch.ops.quantizers import QuantizationLevel

TILE, FINE = cuda_codec.DECODE_TILES[1], cuda_codec.DECODE_FINE_LEVELS
# Ragged shapes over several tiles of DECODE_TILES[1], and 2**L > dim.
SHAPES = [(70, 133), (130, 68), (17, 200), (1, 7), (33, 1)]
PRESETS = [QuantizationLevel.LOSSLESS, QuantizationLevel.MEDIUM]
PREDICTORS = ["crossed", "left_top"]
OTHER_TILINGS = [((16, 16), 4), ((32, 32), 5), ((16, 48), 2), ((64, 128), 0),
                 (cuda_codec.DECODE_TILES[2], FINE), (cuda_codec.DECODE_TILES[0], FINE)]


def _tree(pred, tl, tr, bl, br):
    if pred == "left_top":
        return tl
    avg = lambda a, b: (a + b + 1) >> 1  # noqa: E731
    return (avg(tl, tr) + avg(bl, br) + avg(tl, bl) + avg(tr, br)) >> 2


def _predict(c, pred):
    """One prediction per cell of a corner lattice ``c``."""
    return _tree(pred, c[:-1, :-1], c[:-1, 1:], c[1:, :-1], c[1:, 1:])


def _window(a, y0, x0, nh, nw):
    """a[y0 : y0 + nh, x0 : x0 + nw] in int64, zero where it leaves ``a``."""
    out = np.zeros((nh, nw), np.int64)
    part = a[y0 : y0 + nh, x0 : x0 + nw]
    out[: part.shape[0], : part.shape[1]] = part
    return out


def _refined(step):
    sub = step >> 1
    return ((0, sub), (sub, 0), (sub, sub))


def _coarse_level(out, step, residual, pred):
    """One coarse launch over the whole plane: each cell of the ``step``
    lattice decodes its refined pixels, ``residual(which, oy, ox, nh, nw)``
    giving those of quad ``which``; a corner outside the plane reads 0."""
    h, w = out.shape
    c = _window(out, 0, 0, cdiv(h, step) * step + 1, cdiv(w, step) * step + 1)[::step, ::step]
    p = _predict(c, pred)
    for which, (oy, ox) in enumerate(_refined(step)):
        nh, nw = out[oy::step, ox::step].shape
        out[oy::step, ox::step] = (p[:nh, :nw] + residual(which, oy, ox, nh, nw)) & 255


def _tiles(out, f, tile, pred, region):
    """The tiled launch: each tile's region, rows and columns 0..rh and
    0..rw from ``region(y0, x0, rh, rw)`` (residuals off the ``2**f``
    lattice, the lattice decoded), decoded in place level by level, a
    pixel outside the plane left as it is; only the tile's own pixels
    are kept."""
    h, w = out.shape
    s = 1 << f
    th, tw = tile
    final = out.copy()
    for y0 in range(0, h, th):
        for x0 in range(0, w, tw):
            rh, rw = th + s, tw + s
            rc = region(y0, x0, rh, rw)
            inside = (np.arange(y0, y0 + rh + 1)[:, None] < h) & (np.arange(x0, x0 + rw + 1) < w)
            for step in (s >> i for i in range(f)):
                p = _predict(rc[::step, ::step], pred)
                for oy, ox in _refined(step):
                    sl = (slice(oy, rh, step), slice(ox, rw, step))
                    rc[sl] = np.where(inside[sl], (p + rc[sl]) & 255, rc[sl])
            hh, ww = min(th, h - y0), min(tw, w - x0)
            final[y0 : y0 + hh, x0 : x0 + ww] = rc[:hh, :ww]
    return final


def decode_grid_model(grid, levels, pred, tile=TILE, fine=FINE):
    """K2 as its launches decompose it; loader: the grid's window over the
    region, whose lattice points hold the anchors unless coarse levels
    ran, whose decode then replaces them."""
    h, w = grid.shape
    lv = effective_levels(levels, h, w)
    f = min(lv, fine)
    s = 1 << f
    g = grid.astype(np.int64)
    out = np.zeros_like(g)
    coarse = lv - f
    for level in range(coarse):
        step = 1 << (lv - level)
        if level == 0:
            out[::step, ::step] = g[::step, ::step]
        _coarse_level(out, step, lambda which, oy, ox, nh, nw: g[oy::step, ox::step], pred)
    if coarse and not f:
        return out.astype(np.uint8)

    def region(y0, x0, rh, rw):
        rc = _window(g, y0, x0, rh + 1, rw + 1)
        if coarse:
            rc[::s, ::s] = _window(out, y0, x0, rh + 1, rw + 1)[::s, ::s]
        return rc

    return _tiles(out, f, tile, pred, region).astype(np.uint8)


def decode_quads_model(anchors, subbands, shape, levels, upto, pred, tile=TILE, fine=FINE):
    """K5 stopped after ``upto`` levels, on the preview's plane; loader:
    level step ``2**k`` (k = 1..F) reads the archive's level ``upto - k``
    quads over the region, 0 where a pixel lies outside the plane, and
    the lattice is the coarse decode or the packed anchors."""
    h, w = shape
    lv = effective_levels(levels, h, w)
    upto = max(0, min(upto, lv))
    h, w = cdiv(h, 1 << (lv - upto)), cdiv(w, 1 << (lv - upto))
    f = min(upto, fine)
    s = 1 << f
    a = np.asarray(anchors).astype(np.int64)
    out = np.zeros((h, w), np.int64)
    coarse = upto - f
    for level in range(coarse):
        step = 1 << (upto - level)
        if level == 0:
            out[::step, ::step] = a
        quads = subbands[level]
        _coarse_level(out, step, lambda which, oy, ox, nh, nw: quads[which][:nh, :nw], pred)
    if coarse and not f:
        return out.astype(np.uint8)

    def region(y0, x0, rh, rw):
        rc = np.zeros((rh + 1, rw + 1), np.int64)
        inside = (np.arange(y0, y0 + rh + 1)[:, None] < h) & (np.arange(x0, x0 + rw + 1) < w)
        for k in range(1, f + 1):
            st = 1 << k
            for which, (oy, ox) in enumerate(_refined(st)):
                sl = (slice(oy, rh, st), slice(ox, rw, st))
                q = _window(subbands[upto - k][which], y0 // st, x0 // st, rh // st, rw // st)
                rc[sl] = np.where(inside[sl], q, 0)
        if coarse:
            lattice = _window(out, y0, x0, rh + 1, rw + 1)[::s, ::s]
        else:
            lattice = _window(a, y0 >> f, x0 >> f, rh // s + 1, rw // s + 1)
        rc[::s, ::s] = np.where(inside[::s, ::s], lattice, 0)
        return rc

    return _tiles(out, f, tile, pred, region).astype(np.uint8)


def _image(shape, seed=0):
    return np.random.default_rng([seed, *shape]).integers(0, 256, shape, dtype=np.uint8)


@functools.lru_cache(maxsize=None)
def _coded(shape, levels, preset, pred):
    """The JAX encode's subband layout and grid, and the oracle's decode
    of that grid."""
    a, s, _ = jpyramid.encode_subbands(
        _image(shape), levels, jquantize_fn(JQL(int(preset))), predictor_fn(pred)
    )
    grid = np.asarray(jpyramid.assemble_grid(a, s, shape))
    layout = np.asarray(a), [tuple(np.asarray(q) for q in quads) for quads in s]
    return layout, grid, oracle_decode(grid, levels, pred)


def _check_grid(shape, levels, preset, pred, tile=TILE, fine=FINE):
    _, grid, want = _coded(shape, levels, preset, pred)
    got = decode_grid_model(grid, levels, pred, tile, fine)
    assert np.array_equal(got, want), (preset, pred, "oracle")
    jax_out = np.asarray(jpyramid.decode_plane(grid, levels, predictor_fn(pred)))
    assert np.array_equal(got, jax_out), (preset, pred, "jax")


def _check_quads(shape, levels, preset, pred, tile=TILE, fine=FINE):
    (anchors, subbands), _, full = _coded(shape, levels, preset, pred)
    lv = effective_levels(levels, *shape)
    for upto in range(lv + 1):
        got = decode_quads_model(anchors, subbands, shape, levels, upto, pred, tile, fine)
        want = np.asarray(jpyramid.decode_preview(anchors, subbands[:upto], shape, levels, upto,
                                                  predictor_fn(pred)))
        assert np.array_equal(got, want), (preset, pred, upto)
    assert np.array_equal(got, full), (preset, pred, "oracle")


@pytest.mark.parametrize("levels", range(9))
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_tiled_grid_decode_equals_oracle_and_jax(shape, levels):
    for preset in PRESETS:
        for pred in PREDICTORS:
            _check_grid(shape, levels, preset, pred)


@pytest.mark.parametrize("levels", range(9))
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_tiled_quads_decode_equals_jax_at_every_preview(shape, levels):
    for preset in PRESETS:
        for pred in PREDICTORS:
            _check_quads(shape, levels, preset, pred)


@pytest.mark.parametrize("tile,fine", OTHER_TILINGS, ids=lambda v: str(v))
def test_tiled_decodes_hold_for_other_tilings(tile, fine):
    shape = (70, 133)
    for levels in (3, 6):
        _check_grid(shape, levels, QuantizationLevel.HIGH, "crossed", tile, fine)
        _check_quads(shape, levels, QuantizationLevel.HIGH, "left_top", tile, fine)


def test_decode_tile_constants_fit_the_kernel():
    assert 0 <= FINE <= 5
    for th, tw in cuda_codec.DECODE_TILES:
        for d in (th, tw):
            assert d > 0 and d % 16 == 0 and d % (1 << FINE) == 0


@pytest.mark.parametrize("b,h,w,want", [(1, 1080, 1920, 1), (8, 1080, 1920, 2), (1, 4096, 4096, 2),
                                        (4, 1080, 1920, 1), (1, 0, 0, 0), (1, 270, 480, 0),
                                        (8, 270, 480, 1), (1, 2614, 2368, 1)])
def test_decode_tile_grows_with_the_call(b, h, w, want):
    """On a card of 132 SMs: 1080x1920 is 255 tiles of 64x128, its
    preview at upto 2 (270x480) 20."""
    assert cuda_codec.decode_tile(b, h, w, 132) == cuda_codec.DECODE_TILES[want]


def test_decode_tile_follows_the_cards_sms():
    assert cuda_codec.decode_tile(1, 1080, 1920, 256) == cuda_codec.DECODE_TILES[0]
    assert cuda_codec.decode_tile(1, 1080, 1920, 255) == cuda_codec.DECODE_TILES[1]


# -- the wrappers on the CPU ---------------------------------------------------


@pytest.mark.parametrize("tile,fine", [((8, 64), 4), ((64, 72), 4), ((16, 16), 5), ((64, 64), 6)])
def test_tiled_decodes_refuse_tiles_the_kernel_does_not_take(tile, fine):
    grid = torch.zeros(2, 40, 40, dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="tile"):
        cuda_codec.decode_plane_tiled(grid, 4, "crossed", tile, fine)
    anchors = torch.zeros(2, 3, 3, dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="tile"):
        cuda_codec.decode_preview_tiled(anchors, [], (40, 40), 4, 0, "crossed", tile, fine)


def test_tiled_decodes_take_the_plain_version_on_the_cpu():
    img = torch.from_numpy(_image((3, 70, 133)))
    grid, recon = cuda_codec.encode_plane(img, 5, None, "left_top")
    got = cuda_codec.decode_plane_tiled(grid, 5, "left_top", (16, 32), 3)
    assert torch.equal(got, recon)
    anchors, subbands, _ = cuda_codec.encode_subbands(img, 5, None, "left_top")
    for upto in range(6):
        got = cuda_codec.decode_preview_tiled(anchors, subbands[:upto], (70, 133), 5, upto,
                                              "left_top", (16, 32), 3)
        s = 1 << (5 - upto)
        assert torch.equal(got, recon[:, ::s, ::s]), upto


def test_expected_layout_is_kept_per_shape():
    lead = (2,)
    first = cuda_codec._expected_layout(70, 133, 4, 2, lead, torch.device("cpu"))
    assert first == ((2, 5, 9), [(2, 5, 9)] * 3 + [(2, 10, 18)] * 3)
    assert cuda_codec._expected_layout(70, 133, 4, 2, lead, torch.device("cpu")) is first
    assert cuda_codec._expected_layout(70, 133, 4, 3, lead, torch.device("cpu")) is not first


def test_pointer_array_holds_each_tensor_once():
    tensors = [torch.zeros(4, dtype=torch.uint8) for _ in range(5)]
    arr = cuda_codec._ptrs(tensors)
    assert list(arr) == [t.data_ptr() for t in tensors]
