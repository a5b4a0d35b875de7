"""The design of the subband encode K3 and the grid assembly K4, as plain
models, against the JAX package.

Both kernels run only on the card, where ``chip_smoke.py`` and
``tests/test_torch_cuda.py`` hold them against their plain versions.
What runs here is the decomposition they rest on, written out in NumPy
as their launches run it and held against ``rustyhgi_tpu`` with exact
tolerance:

* lossy K3: the levels coarser than ``2**F`` one launch each over the
  canvas lattice (the first also storing the anchors), then tiles of
  ``cuda_codec.TILE`` cut on the canvas, each coded over the tile and a
  right and bottom halo of one ``2**F`` cell, every canvas position coded
  (the padding reads 0), the reconstruction kept only inside the plane,
  and the tile's canvas rows written out 16 bytes at a time, each run's
  residuals scattered to the quad rows of its row's class (K4's gather
  inverted), the positions of coarser launches left alone;
* lossless K3: one pass over the canvas, a run of 16 residuals of a row
  (lossless K1's, the padding reading 0) scattered the same way;
* K4: the grid row by row, each 16-byte run composed by byte interleaves
  from the ``k + 2`` quad rows of its row's class ``k``.
"""

import functools

import numpy as np
import pytest
import torch

from rustyhgi_tpu.oracle import oracle_encode
from rustyhgi_tpu.ops import pyramid as jpyramid
from rustyhgi_tpu.ops.predictors import predictor_fn
from rustyhgi_tpu.ops.quantizers import QuantizationLevel as JQL
from rustyhgi_tpu.ops.quantizers import quantize_fn as jquantize_fn

from rustyhgi_tpu_torch.dyadic import canvas_shapes, effective_levels
from rustyhgi_tpu_torch.ops import cuda_codec
from rustyhgi_tpu_torch.ops.quantizers import QuantizationLevel, quantize_fn

TILE, FINE = cuda_codec.TILE, cuda_codec.FINE_LEVELS
# Ragged shapes over several tiles, far from multiples of 2**L, and 2**L > dim.
SHAPES = [(70, 133), (130, 68), (17, 200), (1, 7), (33, 1)]
PRESETS = [QuantizationLevel.LOSSLESS, QuantizationLevel.MEDIUM]
PREDICTORS = ["crossed", "left_top"]
OTHER_TILINGS = [((16, 16), 4), ((32, 32), 5), ((16, 48), 2), ((64, 128), 0), ((16, 32), 1),
                 ((128, 128), 4), ((32, 64), 3)]


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


def _code(v, p, table):
    """The residual of v under prediction p, the overflow fixup included;
    table None is lossless."""
    diff = (v - p) & 255
    if table is None:
        return diff
    q = table[diff]
    return np.where((p + q > 255) != (p + diff > 255), diff, q)


def _table(preset):
    q = quantize_fn(preset)
    return None if q.identity else q.table.numpy().astype(np.int64)


def encode_tiles_model(image, levels, preset, pred, tile=TILE, fine=FINE, want_recon=True):
    """Lossy K3 as its launches decompose it: ``(anchors, subbands,
    recon)``, recon None when it is not wanted and no coarse level ran."""
    table = _table(preset)
    h, w = image.shape
    lv = effective_levels(levels, h, w)
    (ah, aw), q_shapes = canvas_shapes(h, w, lv)
    hp, wp = ah << lv, aw << lv
    f = min(lv, fine)
    coarse = lv - f
    src = image.astype(np.int64)
    anchors = np.full((ah, aw), -1, np.int64)
    quads = [[np.full(s, -1, np.int64) for _ in range(3)] for s in q_shapes]
    recon = np.zeros((h, w), np.int64)  # the device buffer, written inside the plane only
    ys, xs = np.arange(hp)[:, None], np.arange(wp)[None, :]
    canvas = _window(src, 0, 0, hp, wp)
    for level in range(coarse):  # one launch each, a thread a cell of the canvas lattice
        step = 1 << (lv - level)
        base = src if level == 0 else recon
        p = _predict(_window(base, 0, 0, hp + 1, wp + 1)[::step, ::step], pred)
        if level == 0:
            anchors[:] = canvas[::step, ::step]
            recon[::step, ::step] = src[::step, ::step]
        for which, (oy, ox) in enumerate(_refined(step)):
            g = _code(canvas[oy::step, ox::step], p, table)
            quads[level][which][:] = g
            inside = (ys[oy::step] < h) & (xs[:, ox::step] < w)
            nh, nw = recon[oy::step, ox::step].shape
            recon[oy::step, ox::step] = np.where(inside, (p + g) & 255, 0)[:nh, :nw]
    keep = want_recon or coarse > 0
    final = recon.copy() if keep else None
    s_ = 1 << f
    th, tw = tile
    for y0 in range(0, hp, th):  # the tiled launch, tiles cut on the canvas
        for x0 in range(0, wp, tw):
            rh, rw = th + s_, tw + s_
            sc = _window(src, y0, x0, rh + 1, rw + 1)
            inside = (np.arange(y0, y0 + rh + 1)[:, None] < h) & (np.arange(x0, x0 + rw + 1) < w)
            rc = np.zeros_like(sc)
            lattice = _window(recon, y0, x0, rh + 1, rw + 1) if coarse else sc
            rc[::s_, ::s_] = np.where(inside[::s_, ::s_], lattice[::s_, ::s_], 0)
            for step in (s_ >> i for i in range(f)):
                p = _predict(rc[::step, ::step], pred)
                for oy, ox in _refined(step):
                    sl = (slice(oy, rh, step), slice(ox, rw, step))
                    g = _code(sc[sl], p, table)
                    sc[sl] = g
                    rc[sl] = np.where(inside[sl], (p + g) & 255, rc[sl])
            for r in range(min(th, hp - y0)):  # the tile's canvas rows, 16 bytes a run
                for c in range(0, min(tw, wp - x0), 16):
                    run = sc[r, c : c + min(16, wp - x0 - c)]
                    _scatter(quads, anchors if not coarse else None, lv, f, y0 + r, x0 + c, run)
            if keep:
                nh, nw = max(0, min(th, h - y0)), max(0, min(tw, w - x0))
                final[y0 : y0 + nh, x0 : x0 + nw] = rc[:nh, :nw]
    subbands = [tuple(q.astype(np.uint8) for q in level) for level in quads]
    assert (anchors >= 0).all() and all((q >= 0).all() for level in quads for q in level), \
        "a byte of the layout was never written"
    return (anchors.astype(np.uint8), subbands,
            final.astype(np.uint8) if want_recon else None)


def _level(y, x, lv):
    """The level index t of canvas position (y, x): the lowest set bit of
    y | x, capped at lv (lv: an anchor)."""
    yx = y | x
    return lv if yx == 0 else min((yx & -yx).bit_length() - 1, lv)


def _scatter(quads, anchors, lv, fine, y, x0, run):
    """K3's writer (scatter_run): the residuals ``run`` of canvas row y
    from column x0 to the quads of levels t < fine (quads[lv - 1 - t]) and,
    where ``anchors`` is not None, the anchors.  A whole run is peeled by
    row class, its odd bytes the q01s finest first; a ragged one goes byte
    by byte."""
    def put_byte(x, v):
        t = _level(y, x, lv)
        if t >= lv:
            if anchors is not None:
                anchors[y >> lv, x >> lv] = v
        elif t < fine:
            which = ((y >> t) & 1) * 2 + ((x >> t) & 1) - 1
            quads[lv - 1 - t][which][y >> (t + 1), x >> (t + 1)] = v

    if run.size < 16:
        for j, v in enumerate(run):
            put_byte(x0 + j, v)
        return
    k = _level(y, 0, lv) if y else lv
    kk = min(k, 4)

    def put(t, which, part):
        if t < fine:
            c = x0 >> (t + 1)
            quads[lv - 1 - t][which][y >> (t + 1), c : c + part.size] = part

    e = run
    for j in range(kk):  # the odd bytes: q01 of level step 2**(j + 1)
        put(j, 0, e[1::2])
        e = e[0::2]
    if kk == 4:
        put_byte(x0, e[0])  # column x0 alone
    elif k < lv:  # q10 and q11 of level step 2**(k + 1)
        put(k, 1, e[0::2])
        put(k, 2, e[1::2])
    elif anchors is not None:  # k = lv <= 4: 16 >> lv anchors
        anchors[y >> lv, (x0 >> lv) : (x0 >> lv) + e.size] = e


def encode_lossless_model(image, levels, pred):
    """Lossless K3's one launch: each 16-byte run of each canvas row coded
    as lossless K1 codes it (corners from the source, 0 outside the plane)
    and scattered to the quads."""
    h, w = image.shape
    lv = effective_levels(levels, h, w)
    (ah, aw), q_shapes = canvas_shapes(h, w, lv)
    hp, wp = ah << lv, aw << lv
    canvas = _window(image.astype(np.int64), 0, 0, hp, wp)
    res = canvas.copy()  # the anchors stay raw
    padded = _window(canvas, 0, 0, hp + 1, wp + 1)
    for level in range(lv):
        step = 1 << (lv - level)
        p = _predict(padded[::step, ::step], pred)
        for oy, ox in _refined(step):
            res[oy::step, ox::step] = (canvas[oy::step, ox::step] - p) & 255
    anchors = np.full((ah, aw), -1, np.int64)
    quads = [[np.full(s, -1, np.int64) for _ in range(3)] for s in q_shapes]
    for y in range(hp):
        for x0 in range(0, wp, 16):
            _scatter(quads, anchors, lv, lv, y, x0, res[y, x0 : x0 + 16])
    assert (anchors >= 0).all() and all((q >= 0).all() for level in quads for q in level)
    return anchors.astype(np.uint8), [tuple(q.astype(np.uint8) for q in level) for level in quads]


def _zip(a, b):
    out = np.empty(2 * a.size, a.dtype)
    out[0::2], out[1::2] = a, b
    return out


def _layout_byte(anchors, subbands, y, x):
    lv = len(subbands)
    t = lv if (y | x) == 0 else min(((y | x) & -(y | x)).bit_length() - 1, lv)
    if t >= lv:
        return anchors[y >> lv, x >> lv]
    which = ((y >> t) & 1) * 2 + ((x >> t) & 1) - 1
    return subbands[lv - 1 - t][which][y >> (t + 1), x >> (t + 1)]


def assemble_rows_model(anchors, subbands, shape):
    """K4 as it runs: a 16-byte run of one row from the quad rows of its
    row's class k (capped at L; row 0: L), byte interleaves from the
    coarsest up; a row's ragged end byte by byte."""
    h, w = shape
    lv = len(subbands)
    grid = np.full((h, w), -1, np.int64)
    for y in range(h):
        k = lv if y == 0 else min((y & -y).bit_length() - 1, lv)
        kk = min(k, 4)
        for x0 in range(0, w, 16):
            if x0 + 16 > w:
                for x in range(x0, w):
                    grid[y, x] = _layout_byte(anchors, subbands, y, x)
                continue
            if kk == 4:  # column x0 alone
                e = np.array([_layout_byte(anchors, subbands, y, x0)])
            elif k == lv:  # 16 >> K anchors
                e = anchors[y >> lv, (x0 >> lv) : (x0 >> lv) + (16 >> kk)]
            else:  # q10 and q11 of level L - 1 - k, 8 >> k bytes each
                n, c = 8 >> k, x0 >> (k + 1)
                quads = subbands[lv - 1 - k]
                e = _zip(quads[1][y >> (k + 1), c : c + n], quads[2][y >> (k + 1), c : c + n])
            for j in reversed(range(kk)):  # q01 of level L - 1 - j, 8 >> j bytes
                n, c = 8 >> j, x0 >> (j + 1)
                e = _zip(e, subbands[lv - 1 - j][0][y >> (j + 1), c : c + n])
            assert e.size == 16
            grid[y, x0 : x0 + 16] = e
    assert (grid >= 0).all()
    return grid.astype(np.uint8)


def _image(shape, seed=0):
    return np.random.default_rng([seed, *shape]).integers(0, 256, shape, dtype=np.uint8)


@functools.lru_cache(maxsize=None)
def _jax_layout(shape, levels, preset, pred):
    """The JAX encode's subband layout, recon and assembled grid, and the
    oracle's grid."""
    img = _image(shape)
    a, s, r = jpyramid.encode_subbands(img, levels, jquantize_fn(JQL(int(preset))), predictor_fn(pred))
    grid = np.asarray(jpyramid.assemble_grid(a, s, shape))
    layout = np.asarray(a), [tuple(np.asarray(q) for q in quads) for quads in s]
    return layout, np.asarray(r), grid, oracle_encode(img, levels, JQL(int(preset)), pred)


def _assert_layout(got, want, tag):
    (ga, gs), (wa, ws) = got, want
    assert np.array_equal(ga, wa), (tag, "anchors")
    assert len(gs) == len(ws), tag
    for lv, (gq, wq) in enumerate(zip(gs, ws)):
        for which, (a, b) in enumerate(zip(gq, wq)):
            assert np.array_equal(a, b), (tag, lv, which)


def _check_tiles(shape, levels, preset, pred, tile=TILE, fine=FINE):
    want, want_recon, grid, oracle = _jax_layout(shape, levels, preset, pred)
    assert np.array_equal(grid, oracle), "the JAX grid differs from the oracle"
    anchors, subbands, recon = encode_tiles_model(_image(shape), levels, preset, pred, tile, fine)
    _assert_layout((anchors, subbands), want, (shape, levels, preset, pred, tile, fine))
    assert np.array_equal(recon, want_recon), (shape, levels, preset, pred, "recon")
    no_recon = encode_tiles_model(_image(shape), levels, preset, pred, tile, fine, False)
    _assert_layout(no_recon[:2], want, (shape, levels, "want_recon False"))
    assert no_recon[2] is None


@pytest.mark.parametrize("levels", range(9))
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_tiled_subband_encode_equals_jax_and_oracle(shape, levels):
    """Every split of the depth between coarse launches and tiled levels
    (F = 4: none below L5)."""
    for preset in PRESETS:
        for pred in PREDICTORS:
            _check_tiles(shape, levels, preset, pred)


@pytest.mark.parametrize("tile,fine", OTHER_TILINGS, ids=lambda v: str(v))
def test_tiled_subband_encode_holds_for_other_tilings(tile, fine):
    for shape, levels in (((70, 133), 3), ((70, 133), 6), ((130, 68), 8)):
        _check_tiles(shape, levels, QuantizationLevel.HIGH, "crossed", tile, fine)
        _check_tiles(shape, levels, QuantizationLevel.MEDIUM, "left_top", tile, fine)


@pytest.mark.parametrize("levels", range(9))
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_lossless_subband_pass_equals_jax(shape, levels):
    for pred in PREDICTORS:
        want, _, _, _ = _jax_layout(shape, levels, QuantizationLevel.LOSSLESS, pred)
        got = encode_lossless_model(_image(shape), levels, pred)
        _assert_layout(got, want, (shape, levels, pred))


@pytest.mark.parametrize("levels", range(9))
@pytest.mark.parametrize("shape", SHAPES + [(48, 80), (16, 16)], ids=lambda s: "x".join(map(str, s)))
def test_row_class_gather_equals_jax_assemble(shape, levels):
    """Rows of every class, whole 16-byte runs (48x80, 16x16) and ragged
    ones, depth 0 (a copy of the anchors) to 8."""
    for preset in PRESETS:
        (anchors, subbands), _, grid, oracle = _jax_layout(shape, levels, preset, "crossed")
        got = assemble_rows_model(anchors, subbands, shape)
        assert np.array_equal(got, grid), (shape, levels, preset)
        assert np.array_equal(got, oracle), (shape, levels, preset, "oracle")


# -- the wrappers on the CPU ---------------------------------------------------


@pytest.mark.parametrize("tile,fine", [((8, 64), 4), ((64, 72), 4), ((16, 16), 5), ((64, 64), 6)])
def test_tiled_subband_encode_refuses_tiles_the_kernel_does_not_take(tile, fine):
    image = torch.zeros(2, 40, 40, dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="tile"):
        cuda_codec.encode_subbands_tiled(image, 4, None, "crossed", True, tile, fine)


@pytest.mark.parametrize("want_recon", [True, False])
def test_tiled_subband_encode_takes_the_plain_version_on_the_cpu(want_recon):
    img = torch.from_numpy(_image((3, 70, 133)))
    table = quantize_fn(QuantizationLevel.MEDIUM).table
    got = cuda_codec.encode_subbands_tiled(img, 5, table, "left_top", want_recon, (16, 32), 3)
    want = cuda_codec.encode_subbands(img, 5, table, "left_top", want_recon)
    assert torch.equal(got[0], want[0])
    assert all(torch.equal(a, b) for qa, qb in zip(got[1], want[1]) for a, b in zip(qa, qb))
    assert (got[2] is None) == (not want_recon)
    if want_recon:
        assert torch.equal(got[2], want[2])


@pytest.mark.parametrize("lead", [(), (3,)])
@pytest.mark.parametrize("shape,levels", [((70, 133), 4), ((1080, 1920), 4), ((1, 7), 3),
                                          ((33, 1), 8), ((17, 200), 0)])
def test_subband_buffer_lays_out_aligned_contiguous_views(shape, levels, lead):
    h, w = shape
    lv = effective_levels(levels, h, w)
    layout = cuda_codec._subband_buffer(h, w, lv, lead)
    a_shape, q_shapes = canvas_shapes(h, w, lv)
    want = [lead + a_shape] + [lead + s for s in q_shapes for _ in range(3)]
    assert [v[0] for v in layout.views] == want
    end = 0
    for shape_, strides, off in layout.views:
        assert off % 16 == 0 and off >= end
        assert strides == torch.empty(shape_).stride()
        end = off + int(np.prod(shape_))
    assert end <= layout.size and layout.size % 16 == 0
    assert list(layout.quad_offsets) == [v[2] for v in layout.views[1:]]
    buf = torch.arange(layout.size).to(torch.uint8)
    for shape_, strides, off in layout.views:
        view = buf.as_strided(shape_, strides, off)
        assert view.is_contiguous() and view.data_ptr() == buf.data_ptr() + off


def test_subband_buffer_is_kept_per_shape():
    first = cuda_codec._subband_buffer(70, 133, 4, (2,))
    assert cuda_codec._subband_buffer(70, 133, 4, (2,)) is first
    assert cuda_codec._subband_buffer(70, 133, 4, (3,)) is not first
    assert cuda_codec._subband_buffer(70, 133, 3, (2,)) is not first
