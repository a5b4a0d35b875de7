"""The designs of the redesigned kernels K1 and X1, as plain models, against
the JAX package.

Each CUDA kernel runs only on the card, where ``chip_smoke.py`` and
``tests/test_torch_cuda.py`` hold it against its plain version.  What
runs here is the decomposition each kernel rests on, written out in
NumPy, held against ``rustyhgi_tpu`` with exact tolerance:

* X1's lanes divide by no variable: ``tpurans.reciprocal`` and
  ``tpurans.quotient`` against ``//`` for every frequency, and the lane
  step built on them against JAX ``encode_device``;
* lossless K1 codes every pixel from its level (the lowest set bit of
  ``y | x``) and corners read from the source, in one pass: against
  ``oracle_encode``;
* lossy K1 runs the coarse levels whole, then each ``cuda_codec.TILE``
  tile with a right and bottom halo of one ``2**F`` cell on its own,
  keeping only the tile's pixels: against ``oracle_encode``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rustyhgi_tpu.oracle import oracle_decode, oracle_encode
from rustyhgi_tpu.ops import tpurans as jt
from rustyhgi_tpu.ops.quantizers import QuantizationLevel as JQL

from rustyhgi_tpu_torch.dyadic import effective_levels
from rustyhgi_tpu_torch.ops import cuda_codec, tpurans
from rustyhgi_tpu_torch.ops.quantizers import QuantizationLevel, linear_table

M = 1 << 14

# -- X1: the reciprocal ------------------------------------------------------

F_CHUNKS = [(lo, min(lo + 1024, M)) for lo in range(1, M, 1024)]


def _xs(f: int, rng) -> np.ndarray:
    """The states a lane can hold and the edges of the quotient."""
    k = rng.integers(1, (1 << 32) // f, 8, dtype=np.uint64)
    fixed = [0, 1, f - 1, f, (f << 18) - 1, (1 << 32) - 1]
    xs = np.concatenate([np.array(fixed, np.uint64), k * np.uint64(f) - np.uint64(1),
                         k * np.uint64(f), rng.integers(0, 1 << 32, 16, dtype=np.uint64)])
    return xs[xs < np.uint64(1 << 32)]


@pytest.mark.parametrize("lo,hi", F_CHUNKS, ids=[f"f{lo}-{hi - 1}" for lo, hi in F_CHUNKS])
def test_reciprocal_quotient_equals_floor_division(lo, hi):
    rng = np.random.default_rng(lo)
    for f in range(lo, hi):
        m, extra = tpurans.reciprocal(f)
        assert 0 <= m < 1 << 64
        xs = _xs(f, rng)
        q = tpurans.quotient(xs, m).astype(object)
        want = xs.astype(object) // f
        if f == 1:  # m = 2**64 - 1 reads one less; `extra` restores the state
            want = np.maximum(want - 1, 0)
            assert extra == M - 1
        else:
            assert extra == 0
        assert np.array_equal(q, want), f
        # The lanes' step, x + q * (M - f) + cum + extra in u32, is rANS's,
        # here with the largest cum a table can give f.
        live = xs[(xs >= np.uint64(f << 2)) & (xs < np.uint64(f << 18))].astype(object)
        qs = tpurans.quotient(live.astype(np.uint64), m).astype(object)
        cum = M - f
        step = (live + qs * (M - f) + cum + extra) % (1 << 32)
        assert np.array_equal(step, (live // f) * M + live % f + cum), f


def test_reciprocal_refuses_what_no_table_holds():
    for f in (0, M, -1):
        with pytest.raises(ValueError, match="outside"):
            tpurans.reciprocal(f)


def _lanes_model(data: np.ndarray):
    """X1's lanes as the kernel runs them: the entries of the normalized
    table, the division-free step, each lane's words written from the end
    of its row backwards, then placed at the lanes' exclusive offsets."""
    n = data.size
    lanes = tpurans.lanes_for(n)
    rows = -(-n // lanes)
    sym = np.zeros(rows * lanes, np.int64)
    sym[:n] = data
    hist = np.bincount(sym, minlength=256)
    freq = tpurans._normalize(torch.from_numpy(hist)[None])[0].numpy()
    cum = np.cumsum(freq) - freq
    m = np.zeros(256, np.uint64)
    bias = np.zeros(256, np.uint64)
    for s in np.flatnonzero(freq):
        mm, extra = tpurans.reciprocal(int(freq[s]))
        m[s], bias[s] = mm, cum[s] + extra
    x = np.full(lanes, 1 << 16, np.uint64)
    scratch = np.zeros((lanes, rows), np.uint64)
    k = np.zeros(lanes, np.int64)
    grid = sym.reshape(rows, lanes)
    idx = np.arange(lanes)
    for t in range(rows - 1, -1, -1):
        s = grid[t]
        f = freq[s].astype(np.uint64)
        emit = x >= (f << np.uint64(18))
        scratch[idx[emit], rows - 1 - k[emit]] = x[emit] & np.uint64(0xFFFF)
        k += emit
        x = np.where(emit, x >> np.uint64(16), x)
        q = tpurans.quotient(x, m[s])
        x = (x + q * (np.uint64(M) - f) + bias[s]) & np.uint64(0xFFFFFFFF)
    offsets = np.cumsum(k) - k
    words = np.zeros(int(k.sum()), np.uint64)
    for lane in range(lanes):
        words[offsets[lane] : offsets[lane] + k[lane]] = scratch[lane, rows - k[lane] :]
    return freq, k, x.astype(np.uint32), words.astype(np.uint16)


def _lane_streams():
    rng = np.random.default_rng(41)
    odd = np.zeros(40000, np.uint8)
    odd[1234] = 9  # f = 1 beside f = 16383
    return {
        "uniform-70000": rng.integers(0, 256, 70000, dtype=np.uint8),
        "geometric-5000": (rng.geometric(0.3, 5000) % 256).astype(np.uint8),
        "one-odd-byte": odd,
        "all-256": np.tile(np.arange(256, dtype=np.uint8), 3),
        "single": np.array([200], np.uint8),
    }


LANE_STREAMS = _lane_streams()


@pytest.mark.parametrize("name", list(LANE_STREAMS))
def test_division_free_lanes_equal_jax_encode_device(name):
    data = LANE_STREAMS[name]
    freq, counts, states, words = _lanes_model(data)
    jf, jc, js, jw = (np.asarray(a) for a in jax.jit(jt.encode_device)(jnp.asarray(data)))
    assert np.array_equal(freq, jf) and np.array_equal(counts, jc)
    assert np.array_equal(states, js.astype(np.uint32))
    assert np.array_equal(words, jw.reshape(-1)[: int(jc.sum())].astype(np.uint16))
    if name == "one-odd-byte":
        assert sorted(freq[freq > 0]) == [1, M - 1]


# -- K1: the decompositions --------------------------------------------------


def _tree(pred, tl, tr, bl, br):
    if pred == "left_top":
        return tl
    avg = lambda a, b: (a + b + 1) >> 1  # noqa: E731
    return (avg(tl, tr) + avg(bl, br) + avg(tl, bl) + avg(tr, br)) >> 2


def _corner(img, y, x):
    """img[y, x] where (y, x) lies in the plane, else 0 (elementwise)."""
    h, w = img.shape
    inside = (y < h) & (x < w)
    return np.where(inside, img[np.minimum(y, h - 1), np.minimum(x, w - 1)], 0)


def lossless_model(img: np.ndarray, levels: int, pred: str) -> np.ndarray:
    """Lossless K1 in one pass: each pixel's level is the lowest set bit t
    of y | x (t >= L, or y = x = 0: an anchor, stored raw), and its cell of
    side 2**(t+1) reads its corners from the source."""
    h, w = img.shape
    lv = effective_levels(levels, h, w)
    src = img.astype(np.int64)
    y, x = np.mgrid[0:h, 0:w]
    yx = y | x
    low = np.log2(np.where(yx == 0, 1, yx & -yx)).astype(np.int64)
    t = np.where(yx == 0, lv, np.minimum(low, lv))
    step = np.left_shift(2, np.minimum(t, 40))
    y0, x0 = y & -step, x & -step
    p = _tree(pred, _corner(src, y0, x0), _corner(src, y0, x0 + step),
              _corner(src, y0 + step, x0), _corner(src, y0 + step, x0 + step))
    return np.where(t >= lv, src, (src - p) & 255).astype(np.uint8)


def _code(v, p, table):
    """The closed-loop residual with the overflow fixup."""
    diff = (v - p) & 255
    q = table[diff]
    return np.where((p + q > 255) != (p + diff > 255), diff, q)


def _window(a, y0, x0, nh, nw):
    """a[y0 : y0 + nh, x0 : x0 + nw], zero where it leaves the plane."""
    out = np.zeros((nh, nw), np.int64)
    part = a[y0 : y0 + nh, x0 : x0 + nw]
    out[: part.shape[0], : part.shape[1]] = part
    return out


def tiled_model(img, levels, table, pred, tile=cuda_codec.TILE, fine=cuda_codec.FINE_LEVELS):
    """Lossy K1 as its launches decompose it: the levels coarser than
    2**F whole (F = min(L, fine)), the first also storing the anchors;
    then every tile on its own, over the tile and a right and bottom halo
    of one 2**F cell, from the 2**F lattice of the coarse reconstruction
    (or the anchors), keeping only the tile's own pixels.  Returns
    ``(grid, recon)``."""
    h, w = img.shape
    lv = effective_levels(levels, h, w)
    f = min(lv, fine)
    s = 1 << f
    src = img.astype(np.int64)
    table = np.asarray(table, np.int64)
    grid, recon = src.copy(), src.copy()
    for level in range(lv - f):  # the coarse launches, each over the whole plane
        step = 1 << (lv - level)
        sub = step >> 1
        c = _window(recon, 0, 0, -(-h // step) * step + 1, -(-w // step) * step + 1)[::step, ::step]
        p = _tree(pred, c[:-1, :-1], c[:-1, 1:], c[1:, :-1], c[1:, 1:])
        for oy, ox in ((0, sub), (sub, 0), (sub, sub)):
            v = src[oy::step, ox::step]
            pp = p[: v.shape[0], : v.shape[1]]
            g = _code(v, pp, table)
            grid[oy::step, ox::step] = g
            recon[oy::step, ox::step] = (pp + g) & 255
    th, tw = tile
    out_grid, out_recon = grid.copy(), recon.copy()
    for y0 in range(0, h, th):
        for x0 in range(0, w, tw):
            rh, rw = th + s, tw + s  # the tile and its halo
            ys = np.arange(y0, y0 + rh + 1)[:, None]
            xs = np.arange(x0, x0 + rw + 1)[None, :]
            inside = (ys < h) & (xs < w)
            rc = np.zeros((rh + 1, rw + 1), np.int64)  # 0 until a level writes it
            rc[::s, ::s] = _window(recon, y0, x0, rh + 1, rw + 1)[::s, ::s]
            gc = _window(src, y0, x0, rh, rw)  # the source, then the residuals
            if lv > f:  # the coarse launches' grid on the lattice
                gc[::s, ::s] = _window(grid, y0, x0, rh, rw)[::s, ::s]
            sc = _window(src, y0, x0, rh, rw)
            for step in (s >> i for i in range(f)):
                sub = step >> 1
                c = rc[::step, ::step]
                p = _tree(pred, c[:-1, :-1], c[:-1, 1:], c[1:, :-1], c[1:, 1:])
                for oy, ox in ((0, sub), (sub, 0), (sub, sub)):
                    keep = inside[oy:-1:step, ox:-1:step]
                    g = _code(sc[oy::step, ox::step], p, table)
                    gc[oy::step, ox::step] = np.where(keep, g, gc[oy::step, ox::step])
                    rc[oy:-1:step, ox:-1:step] = np.where(keep, (p + g) & 255,
                                                          rc[oy:-1:step, ox:-1:step])
            hh, ww = min(th, h - y0), min(tw, w - x0)
            out_grid[y0 : y0 + hh, x0 : x0 + ww] = gc[:hh, :ww]
            out_recon[y0 : y0 + hh, x0 : x0 + ww] = rc[:hh, :ww]
    return out_grid.astype(np.uint8), out_recon.astype(np.uint8)


# Ragged shapes over several tiles of cuda_codec.TILE, and 2**L > dim.
K1_SHAPES = [(70, 133), (130, 68), (17, 200), (1, 7), (33, 1)]
PRESETS = list(QuantizationLevel)


def _image(shape, seed=0):
    return np.random.default_rng([seed, *shape]).integers(0, 256, shape, dtype=np.uint8)


@functools.lru_cache(maxsize=None)
def _oracle(shape, levels, preset, pred):
    grid = oracle_encode(_image(shape), levels, JQL(int(preset)), pred)
    return grid, oracle_decode(grid, levels, pred)


@pytest.mark.parametrize("levels", range(9))
@pytest.mark.parametrize("shape", K1_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_lossless_one_pass_equals_oracle(shape, levels):
    for pred in ("crossed", "left_top"):
        got = lossless_model(_image(shape), levels, pred)
        assert np.array_equal(got, _oracle(shape, levels, QuantizationLevel.LOSSLESS, pred)[0]), pred


@pytest.mark.parametrize("levels", range(9))
@pytest.mark.parametrize("shape", K1_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_tiled_closed_loop_equals_oracle(shape, levels):
    for preset in PRESETS:
        for pred in ("crossed", "left_top"):
            grid, recon = tiled_model(_image(shape), levels, linear_table(preset), pred)
            want_grid, want_recon = _oracle(shape, levels, preset, pred)
            assert np.array_equal(grid, want_grid), (preset, pred)
            assert np.array_equal(recon, want_recon), (preset, pred)


@pytest.mark.parametrize("tile,fine", [((16, 16), 4), ((32, 32), 5), ((16, 48), 2)])
def test_tiled_closed_loop_holds_for_other_tiles(tile, fine):
    shape = (70, 133)
    for levels in (3, 6):
        got = tiled_model(_image(shape), levels, linear_table(QuantizationLevel.HIGH),
                          "crossed", tile, fine)
        want = _oracle(shape, levels, QuantizationLevel.HIGH, "crossed")
        assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])


def test_tile_constants_fit_the_kernel():
    th, tw = cuda_codec.TILE
    assert 0 <= cuda_codec.FINE_LEVELS <= 5
    for d in (th, tw):
        assert d > 0 and d % 16 == 0 and d % (1 << cuda_codec.FINE_LEVELS) == 0


# -- the table by value (the wrapper's host work) -----------------------------


def test_table_arg_is_converted_once_per_table():
    table = torch.from_numpy(linear_table(QuantizationLevel.MEDIUM).astype(np.int32))
    arg = cuda_codec.table_arg(table)
    assert bytes(arg.v) == linear_table(QuantizationLevel.MEDIUM).tobytes()
    assert cuda_codec.table_arg(table) is arg  # no host work on the second call
    table[3] = 0  # an in-place change is seen
    changed = cuda_codec.table_arg(table)
    assert changed is not arg and changed.v[3] == 0
    other = table.clone()
    assert cuda_codec.table_arg(other) is not changed and bytes(cuda_codec.table_arg(other).v) == bytes(changed.v)


@pytest.mark.parametrize("bad", [torch.arange(255), torch.arange(256) - 1, torch.arange(256) + 1],
                         ids=["short", "negative", "above-255"])
def test_table_arg_refuses_what_is_no_table(bad):
    with pytest.raises(ValueError, match="256 values"):
        cuda_codec.table_arg(bad)


def test_table_arg_forgets_a_dead_table():
    table = torch.from_numpy(linear_table(QuantizationLevel.LOW).astype(np.int32))
    cuda_codec.table_arg(table)
    key = id(table)
    assert key in cuda_codec._tables
    del table
    assert key not in cuda_codec._tables


def test_codec_calls_convert_their_table_once(monkeypatch):
    """A codec's lossy calls reuse its one converted table."""
    from rustyhgi_tpu_torch import HGICodec

    codec = HGICodec(4, "medium", device="cpu")
    first = cuda_codec.table_arg(codec._table)
    calls = []
    monkeypatch.setattr(cuda_codec.QTable, "from_buffer_copy",
                        classmethod(lambda cls, b: calls.append(b) or first))
    for _ in range(3):
        assert cuda_codec.table_arg(codec._table) is first
    assert calls == []


@pytest.mark.parametrize("tile,fine", [((8, 64), 4), ((64, 72), 4), ((16, 16), 5), ((64, 64), 6)])
def test_encode_plane_tiled_refuses_tiles_the_kernel_does_not_take(tile, fine):
    img = torch.zeros(2, 40, 40, dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="tile"):
        cuda_codec.encode_plane_tiled(img, 4, None, "crossed", tile, fine)


def test_encode_plane_tiled_takes_the_plain_version_on_the_cpu():
    img = torch.from_numpy(_image((3, 70, 133)))
    table = torch.from_numpy(linear_table(QuantizationLevel.HIGH).astype(np.int32))
    got = cuda_codec.encode_plane_tiled(img, 5, table, "left_top", (16, 32), 3)
    want = cuda_codec.encode_plane(img, 5, table, "left_top")
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
