"""The CUDA kernels K1-K8 and X1 against their plain PyTorch versions, on the card.

Every test here needs a CUDA card and ``nvcc``, and skips without them.
This file imports nothing of JAX, so that it runs on a machine that has
no JAX; tests/conftest.py imports JAX, so run it there without conftest:

    python -m pytest tests/test_torch_cuda.py --noconftest -q

``chip_smoke.py`` makes the same comparison at the real sizes.
"""

import numpy as np
import pytest
import torch

from rustyhgi_tpu_torch import HGICodec
from rustyhgi_tpu_torch.ops import bitpack, cuda_codec, pyramid, tpurans, vpucal
from rustyhgi_tpu_torch.ops.quantizers import QuantizationLevel, quantize_fn

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _image(shape, seed=0):
    return np.random.default_rng([seed, *shape]).integers(0, 256, shape, dtype=np.uint8)


def _table(preset, strategy="linear"):
    q = quantize_fn(preset, strategy)
    return None if q.identity else q.table


@pytest.mark.parametrize("shape", [(37, 53), (1, 7), (9, 1), (3, 64, 96), (0, 0)])
@pytest.mark.parametrize("preset", list(QuantizationLevel), ids=lambda p: p.name.lower())
@pytest.mark.parametrize("pred", ["crossed", "left_top"])
def test_kernels_match_plain_version(cuda, shape, preset, pred):
    img = torch.from_numpy(_image(shape)).to(cuda)
    table = _table(preset)
    for levels in (0, 1, 2, 4, 8, 16):
        grid, recon = cuda_codec.encode_plane(img, levels, table, pred)
        want_grid, want_recon = pyramid.encode_plane(img, levels, table, pred)
        assert torch.equal(grid, want_grid)
        assert torch.equal(recon, want_recon)
        dec = cuda_codec.decode_plane(grid, levels, pred)
        assert torch.equal(dec, pyramid.decode_plane(grid, levels, pred))
        assert torch.equal(dec, recon)


@pytest.mark.parametrize("shape", [(3, 300, 517), (2614, 2368), (129, 65)],
                         ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("preset", [QuantizationLevel.LOSSLESS, QuantizationLevel.MEDIUM],
                         ids=["lossless", "medium"])
@pytest.mark.parametrize("pred", ["crossed", "left_top"])
def test_k1_over_many_ragged_tiles(cuda, shape, preset, pred):
    """Lossless K1's one launch, and lossy K1's tiles with every split of
    the depth between coarse launches and tiled levels."""
    img = torch.from_numpy(_image(shape)).to(cuda)
    table = _table(preset)
    for levels in range(1, 9):
        grid, recon = cuda_codec.encode_plane(img, levels, table, pred)
        want_grid, want_recon = pyramid.encode_plane(img, levels, table, pred)
        assert torch.equal(grid, want_grid), levels
        assert torch.equal(recon, want_recon), levels


@pytest.mark.parametrize("tile,fine", [((16, 16), 4), ((32, 32), 5), ((128, 128), 5),
                                       ((16, 48), 2), ((64, 128), 0)])
def test_k1_tiling_does_not_change_the_output(cuda, tile, fine):
    img = torch.from_numpy(_image((2, 150, 333))).to(cuda)
    table = _table(QuantizationLevel.HIGH)
    for levels in (0, 2, 5, 8):
        got = cuda_codec.encode_plane_tiled(img, levels, table, "crossed", tile, fine)
        want = pyramid.encode_plane(img, levels, table, "crossed")
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), levels


def test_tables_on_two_streams_at_once(cuda):
    """The table travels with each launch: lossy encodes with different
    tables on two streams do not race."""
    img = torch.from_numpy(_image((4, 540, 960))).to(cuda)
    low, high = _table(QuantizationLevel.LOW), _table(QuantizationLevel.HIGH)
    want = {t: pyramid.encode_plane(img, 6, tab) for t, tab in (("low", low), ("high", high))}
    streams = {"low": torch.cuda.Stream(), "high": torch.cuda.Stream()}
    got = {}
    for _ in range(5):
        for t, tab in (("low", low), ("high", high)):
            with torch.cuda.stream(streams[t]):
                got[t] = cuda_codec.encode_plane(img, 6, tab)
        torch.cuda.synchronize()
        for t in got:
            assert torch.equal(got[t][0], want[t][0]) and torch.equal(got[t][1], want[t][1])


def test_identity_table_through_the_lossy_template(cuda):
    img = torch.from_numpy(_image((37, 53))).to(cuda)
    table = _table(QuantizationLevel.LOSSLESS, "lut")
    assert table is not None
    grid, recon = cuda_codec.encode_plane(img, 4, table)
    assert torch.equal(grid, pyramid.encode_plane(img, 4, None)[0])
    assert torch.equal(recon, img)


def test_launch_counters(cuda):
    img = torch.from_numpy(_image((16, 16))).to(cuda)
    enc, dec = cuda_codec.encode_launches, cuda_codec.decode_launches
    grid, _ = cuda_codec.encode_plane(img, 3)
    cuda_codec.decode_plane(grid, 3)
    assert (cuda_codec.encode_launches, cuda_codec.decode_launches) == (enc + 1, dec + 1)
    # An empty plane launches nothing.
    cuda_codec.encode_plane(torch.empty(0, 0, dtype=torch.uint8, device=cuda), 3)
    assert cuda_codec.encode_launches == enc + 1


@pytest.mark.parametrize(
    "make,match",
    [
        (lambda d: torch.zeros(8, 8, dtype=torch.int32, device=d), "uint8"),
        (lambda d: torch.zeros(8, dtype=torch.uint8, device=d), r"\[H, W\]"),
        (lambda d: torch.zeros(8, 8, dtype=torch.uint8, device=d)[:, ::2], "contiguous"),
    ],
    ids=["dtype", "rank", "strided"],
)
def test_wrappers_reject_what_the_kernels_do_not_take(cuda, make, match):
    bad = make(cuda)
    with pytest.raises(ValueError, match=match):
        cuda_codec.encode_plane(bad, 2)
    with pytest.raises(ValueError, match=match):
        cuda_codec.decode_plane(bad, 2)


@pytest.mark.parametrize("preset", ["lossless", "medium"])
def test_codec_backends_agree(cuda, preset):
    img = _image((135, 240))
    kern = HGICodec(4, preset, backend="cuda")
    plain = HGICodec(4, preset, backend="torch")
    archive = kern.encode(img)
    assert np.array_equal(archive.grid, plain.encode(img).grid)
    assert np.array_equal(kern.decode(archive), plain.decode(archive))


# -- the subband layout: K3 (encode), K4 (assemble), K5 (decode, preview) ----


def _assert_layouts_equal(a, b):
    (anchors_a, subbands_a), (anchors_b, subbands_b) = a, b
    assert torch.equal(anchors_a, anchors_b)
    assert len(subbands_a) == len(subbands_b)
    for quads_a, quads_b in zip(subbands_a, subbands_b):
        for qa, qb in zip(quads_a, quads_b):
            assert torch.equal(qa, qb)


@pytest.mark.parametrize("shape", [(37, 53), (17, 29), (1, 7), (9, 1), (3, 40, 56), (0, 0)])
@pytest.mark.parametrize("preset", list(QuantizationLevel), ids=lambda p: p.name.lower())
@pytest.mark.parametrize("pred", ["crossed", "left_top"])
def test_subband_kernels_match_plain_version(cuda, shape, preset, pred):
    img = torch.from_numpy(_image(shape)).to(cuda)
    hw = img.shape[-2:]
    table = _table(preset)
    for levels in (0, 1, 2, 4, 8, 16):
        anchors, subbands, recon = cuda_codec.encode_subbands(img, levels, table, pred)
        want_a, want_s, want_r = pyramid.encode_subbands(img, levels, table, pred)
        _assert_layouts_equal((anchors, subbands), (want_a, want_s))  # padding included
        assert torch.equal(recon, want_r)
        grid, grid_recon = cuda_codec.encode_plane(img, levels, table, pred)
        assert torch.equal(recon, grid_recon)
        assembled = cuda_codec.assemble_grid(anchors, subbands, hw)
        assert torch.equal(assembled, pyramid.assemble_grid(anchors, subbands, hw))
        assert torch.equal(assembled, grid)
        dec = cuda_codec.decode_subbands(anchors, subbands, hw, levels, pred)
        assert torch.equal(dec, pyramid.decode_subbands(anchors, subbands, hw, levels, pred))
        assert torch.equal(dec, recon)
        for upto in range(len(subbands) + 2):
            got = cuda_codec.decode_preview(anchors, subbands[:upto], hw, levels, upto, pred)
            want = pyramid.decode_preview(anchors, subbands[:upto], hw, levels, upto, pred)
            assert torch.equal(got, want), upto
        _, no_recon_s, no_recon = cuda_codec.encode_subbands(img, levels, table, pred, False)
        assert no_recon is None
        _assert_layouts_equal((anchors, no_recon_s), (anchors, subbands))


DECODE_TILINGS = [((16, 16), 4), ((32, 32), 5), ((16, 48), 2), ((128, 128), 5), ((64, 128), 0),
                  ((64, 128), 3)]


@pytest.mark.parametrize("shape", [(3, 300, 517), (2614, 2368), (129, 65), (1, 1080, 1920)],
                         ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("preset", [QuantizationLevel.LOSSLESS, QuantizationLevel.MEDIUM],
                         ids=["lossless", "medium"])
@pytest.mark.parametrize("pred", ["crossed", "left_top"])
def test_tiled_decodes_over_many_ragged_tiles(cuda, shape, preset, pred):
    """K2's and K5's tiles, every preview included, at every split of the
    depth between coarse launches and tiled levels."""
    img = torch.from_numpy(_image(shape)).to(cuda)
    hw = img.shape[-2:]
    table = _table(preset)
    for levels in range(0, 9):
        grid, recon = cuda_codec.encode_plane(img, levels, table, pred)
        assert torch.equal(cuda_codec.decode_plane(grid, levels, pred),
                           pyramid.decode_plane(grid, levels, pred)), levels
        anchors, subbands, _ = cuda_codec.encode_subbands(img, levels, table, pred)
        assert torch.equal(cuda_codec.decode_subbands(anchors, subbands, hw, levels, pred), recon)
        for upto in range(len(subbands) + 1):
            got = cuda_codec.decode_preview(anchors, subbands[:upto], hw, levels, upto, pred)
            want = pyramid.decode_preview(anchors, subbands[:upto], hw, levels, upto, pred)
            assert torch.equal(got, want), (levels, upto)


@pytest.mark.parametrize("tile,fine", DECODE_TILINGS, ids=str)
@pytest.mark.parametrize("shape", [(2, 150, 333), (3, 96, 320)], ids=lambda s: "x".join(map(str, s)))
def test_decode_tiling_does_not_change_the_output(cuda, shape, tile, fine):
    """Every tiling, on rows of whole 16-byte pieces (320 columns) and
    not (333)."""
    img = torch.from_numpy(_image(shape)).to(cuda)
    hw = img.shape[-2:]
    table = _table(QuantizationLevel.HIGH)
    for levels in (0, 2, 5, 8):
        grid, recon = cuda_codec.encode_plane(img, levels, table, "left_top")
        got = cuda_codec.decode_plane_tiled(grid, levels, "left_top", tile, fine)
        assert torch.equal(got, recon), levels
        anchors, subbands, _ = cuda_codec.encode_subbands(img, levels, table, "left_top")
        for upto in range(len(subbands) + 1):
            got = cuda_codec.decode_preview_tiled(anchors, subbands[:upto], hw, levels, upto,
                                                  "left_top", tile, fine)
            want = pyramid.decode_preview(anchors, subbands[:upto], hw, levels, upto, "left_top")
            assert torch.equal(got, want), (levels, upto)


def test_decode_on_unaligned_buffers(cuda):
    """A grid one byte into its buffer, and quads that are views: the
    kernels take their unaligned paths."""
    img = torch.from_numpy(_image((3, 64, 96))).to(cuda)
    grid, recon = cuda_codec.encode_plane(img, 5)
    buf = torch.empty(1 + grid.numel(), dtype=torch.uint8, device=cuda)
    shifted = buf[1:].view(grid.shape)
    shifted.copy_(grid)
    assert torch.equal(cuda_codec.decode_plane(shifted, 5), recon)
    anchors, subbands, _ = cuda_codec.encode_subbands(img, 5)
    moved = []
    for quads in subbands:
        level = []
        for q in quads:
            b = torch.empty(3 + q.numel(), dtype=torch.uint8, device=cuda)
            v = b[3:].view(q.shape)
            v.copy_(q)
            level.append(v)
        moved.append(tuple(level))
    assert torch.equal(cuda_codec.decode_subbands(anchors, moved, (64, 96), 5), recon)


@pytest.mark.parametrize("tile,fine", [((8, 64), 4), ((64, 72), 4), ((16, 16), 5), ((64, 64), 6)])
def test_tiled_decodes_refuse_tiles_the_kernel_does_not_take(cuda, tile, fine):
    img = torch.from_numpy(_image((40, 40))).to(cuda)
    grid, _ = cuda_codec.encode_plane(img, 4)
    anchors, subbands, _ = cuda_codec.encode_subbands(img, 4)
    with pytest.raises(ValueError, match="tile"):
        cuda_codec.decode_plane_tiled(grid, 4, "crossed", tile, fine)
    with pytest.raises(ValueError, match="tile"):
        cuda_codec.decode_preview_tiled(anchors, subbands, (40, 40), 4, 4, "crossed", tile, fine)


def test_decode_launch_counters_count_one_a_call(cuda):
    img = torch.from_numpy(_image((2, 300, 517))).to(cuda)
    for levels in (0, 4, 8):
        grid, _ = cuda_codec.encode_plane(img, levels)
        anchors, subbands, _ = cuda_codec.encode_subbands(img, levels)
        before = (cuda_codec.decode_launches, cuda_codec.decode_subbands_launches)
        cuda_codec.decode_plane(grid, levels)
        cuda_codec.decode_plane_tiled(grid, levels, "crossed", (64, 128), 0)
        cuda_codec.decode_subbands(anchors, subbands, (300, 517), levels)
        cuda_codec.decode_preview(anchors, subbands[:1], (300, 517), levels, 1)
        after = (cuda_codec.decode_launches, cuda_codec.decode_subbands_launches)
        assert after == (before[0] + 2, before[1] + 2), levels


def test_subband_launch_counters(cuda):
    img = torch.from_numpy(_image((16, 24))).to(cuda)
    before = (cuda_codec.encode_subbands_launches, cuda_codec.assemble_launches,
              cuda_codec.decode_subbands_launches)
    anchors, subbands, _ = cuda_codec.encode_subbands(img, 3)
    cuda_codec.assemble_grid(anchors, subbands, (16, 24))
    cuda_codec.decode_subbands(anchors, subbands, (16, 24), 3)
    cuda_codec.decode_preview(anchors, subbands[:1], (16, 24), 3, 1)
    after = (cuda_codec.encode_subbands_launches, cuda_codec.assemble_launches,
             cuda_codec.decode_subbands_launches)
    assert after == (before[0] + 1, before[1] + 1, before[2] + 2)


def test_subband_wrappers_reject_a_wrong_layout(cuda):
    img = torch.from_numpy(_image((16, 24))).to(cuda)
    anchors, subbands, _ = cuda_codec.encode_subbands(img, 3)
    with pytest.raises(ValueError, match="anchors shape"):
        cuda_codec.decode_subbands(anchors, subbands, (40, 24), 3)
    bad = [subbands[0], (subbands[1][0], subbands[1][1], subbands[0][2])] + subbands[2:]
    with pytest.raises(ValueError, match="level 1 quad"):
        cuda_codec.assemble_grid(anchors, bad, (16, 24))
    with pytest.raises(ValueError, match="3 levels needed"):
        cuda_codec.decode_subbands(anchors, subbands[:2], (16, 24), 3)
    with pytest.raises(ValueError, match="uint8"):
        cuda_codec.decode_subbands(anchors.int(), subbands, (16, 24), 3)


SUBBAND_SHAPES = [(3, 300, 517), (2614, 2368), (129, 65), (1081, 1921), (70, 133), (130, 68),
                  (17, 200), (1, 7), (33, 1)]


@pytest.mark.parametrize("shape", SUBBAND_SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("preset", [QuantizationLevel.LOSSLESS, QuantizationLevel.MEDIUM],
                         ids=["lossless", "medium"])
@pytest.mark.parametrize("pred", ["crossed", "left_top"])
def test_subband_encode_and_assembly_over_many_ragged_tiles(cuda, shape, preset, pred):
    """K3's one lossless launch and its lossy tiles cut on the canvas, at
    every split of the depth between coarse launches and tiled levels,
    with and without recon; K4's row classes on whole and ragged runs."""
    img = torch.from_numpy(_image(shape)).to(cuda)
    hw = img.shape[-2:]
    table = _table(preset)
    for levels in range(0, 9):
        anchors, subbands, recon = cuda_codec.encode_subbands(img, levels, table, pred)
        want_a, want_s, want_r = pyramid.encode_subbands(img, levels, table, pred)
        _assert_layouts_equal((anchors, subbands), (want_a, want_s))
        assert torch.equal(recon, want_r), levels
        _, no_recon_s, no_recon = cuda_codec.encode_subbands(img, levels, table, pred, False)
        assert no_recon is None
        _assert_layouts_equal((anchors, no_recon_s), (want_a, want_s))
        grid = cuda_codec.assemble_grid(anchors, subbands, hw)
        assert torch.equal(grid, pyramid.assemble_grid(want_a, want_s, hw)), levels
        assert torch.equal(grid, cuda_codec.encode_plane(img, levels, table, pred)[0]), levels


@pytest.mark.parametrize("tile,fine", [((16, 16), 4), ((32, 32), 5), ((128, 128), 5),
                                       ((16, 48), 2), ((64, 128), 0), ((32, 64), 3)])
def test_subband_encode_tiling_does_not_change_the_output(cuda, tile, fine):
    img = torch.from_numpy(_image((2, 150, 333))).to(cuda)
    table = _table(QuantizationLevel.HIGH)
    for levels in (0, 2, 5, 8):
        want_a, want_s, want_r = pyramid.encode_subbands(img, levels, table, "crossed")
        for want_recon in (True, False):
            a, s, r = cuda_codec.encode_subbands_tiled(img, levels, table, "crossed", want_recon,
                                                       tile, fine)
            _assert_layouts_equal((a, s), (want_a, want_s))
            assert (r is None) != want_recon
            if want_recon:
                assert torch.equal(r, want_r), (levels, tile, fine)


def test_subband_encode_writes_one_aligned_buffer(cuda):
    """The anchors and every quad are contiguous views of one buffer, each
    on a 16-byte boundary, in the canvas shapes."""
    img = torch.from_numpy(_image((2, 135, 241))).to(cuda)
    anchors, subbands, _ = cuda_codec.encode_subbands(img, 4)
    tensors = [anchors] + [q for quads in subbands for q in quads]
    base = anchors.untyped_storage().data_ptr()
    for t in tensors:
        assert t.is_contiguous() and t.data_ptr() % 16 == 0
        assert t.untyped_storage().data_ptr() == base
    assert [tuple(t.shape) for t in tensors] == (
        [(2, 9, 16)] + [(2, 9 << lv, 16 << lv) for lv in range(4) for _ in range(3)])


@pytest.mark.parametrize("shape,levels", [((3, 64, 96), 5), ((2, 70, 133), 4), ((1, 7), 0),
                                          ((2, 1081, 1921), 6)])
def test_assembly_on_unaligned_quads(cuda, shape, levels):
    """Quads one byte into buffers of their own, as a reader may hand
    them over: K4 and K5 take their byte paths."""
    img = torch.from_numpy(_image(shape)).to(cuda)
    hw = img.shape[-2:]
    grid, recon = cuda_codec.encode_plane(img, levels)
    anchors, subbands, _ = cuda_codec.encode_subbands(img, levels)

    def shifted(t, by):
        buf = torch.empty(by + t.numel(), dtype=torch.uint8, device=cuda)
        v = buf[by:].view(t.shape)
        v.copy_(t)
        return v

    for by in (1, 3, 8):
        moved_a = shifted(anchors, by)
        moved = [tuple(shifted(q, by) for q in quads) for quads in subbands]
        assert torch.equal(cuda_codec.assemble_grid(moved_a, moved, hw), grid), by
        assert torch.equal(cuda_codec.decode_subbands(moved_a, moved, hw, levels), recon), by


@pytest.mark.parametrize("preset", ["lossless", "medium"])
def test_codec_subband_backends_agree(cuda, preset):
    img = _image((135, 240))
    kern = HGICodec(4, preset, backend="cuda")
    plain = HGICodec(4, preset, backend="torch")
    anchors, subbands, recon = kern.encode_subbands(img)
    want = plain.encode_subbands(img)
    _assert_layouts_equal((anchors, subbands), want[:2])
    assert torch.equal(kern.assemble_grid(anchors, subbands, img.shape),
                       plain.assemble_grid(anchors, subbands, img.shape))
    assert torch.equal(kern.decode_subbands(anchors, subbands, img.shape), recon)
    assert torch.equal(kern.decode_preview(anchors, subbands, img.shape, 2),
                       plain.decode_preview(anchors, subbands, img.shape, 2))


# -- the fast mode: X1 (device rANS), K6 (bit-plane pack), K7 (unpack) --------


def _streams():
    """Seeded streams of the sizes and degenerate contents that the rANS
    lanes and the pack blocks have edges at."""
    rng = np.random.default_rng(21)
    out = {}
    for n in (1, 127, 128, 129, 511, 512, 513, 1024, 1025, 65536):
        out[f"uniform-{n}"] = rng.integers(0, 256, n, dtype=np.uint8)
        out[f"geometric-{n}"] = (rng.geometric(0.3, n) % 256).astype(np.uint8)
    odd = np.zeros(1080 * 1920, np.uint8)
    odd[54321] = 200  # frequencies 1 and 16383: the reciprocal's extremes
    out["one-odd-byte"] = odd
    out["zeros"] = np.zeros(10000, np.uint8)
    out["one-symbol"] = np.full(3000, 255, np.uint8)
    out["two-symbols"] = np.tile(np.array([0, 255], np.uint8), 500)
    out["all-256"] = np.tile(np.arange(256, dtype=np.uint8), 4)
    return out


STREAMS = _streams()


def _assert_rans_equal(got, want):
    freq, counts, states, stream = got
    assert torch.equal(freq, want[0]) and torch.equal(counts, want[1])
    assert torch.equal(states, want[2])
    total = int(counts.sum())
    assert torch.equal(stream[:total], want[3][:total])


@pytest.mark.parametrize("name", list(STREAMS))
def test_rans_kernel_matches_plain_version(cuda, name):
    sym = torch.from_numpy(STREAMS[name]).to(cuda)[None]
    got = tpurans.encode_batch(sym)
    _assert_rans_equal(got, tpurans.encode_plain(sym))
    # The payload reads back through the host decoder.
    heads = tpurans.fetch_heads(*got[:3])
    payload = tpurans.frame_payloads(sym.shape[1], *heads, tpurans.fetch_words(got[3], heads[1]))[0]
    assert np.array_equal(tpurans.decode_bytes(payload, sym.shape[1]), STREAMS[name])


@pytest.mark.parametrize("lane_block", [32, 64, 128])
@pytest.mark.parametrize("name", ["uniform-65536", "geometric-1025", "one-odd-byte"])
def test_rans_kernel_lane_blocks_agree(cuda, name, lane_block):
    sym = torch.from_numpy(STREAMS[name]).to(cuda)[None]
    _assert_rans_equal(tpurans.encode_batch(sym, lane_block), tpurans.encode_plain(sym))


def test_rans_kernel_on_32_planes(cuda):
    rng = np.random.default_rng(23)
    planes = (rng.geometric(0.1, (32, 1080 * 1920)) % 256).astype(np.uint8)
    planes[5] = 0
    planes[5, 999] = 1  # one plane with frequencies 1 and 16383
    sym = torch.from_numpy(planes).to(cuda)
    _assert_rans_equal(tpurans.encode_batch(sym), tpurans.encode_plain(sym))


@pytest.mark.parametrize("shape", [(3, 61, 83), (2, 1, 1), (5, 300, 257)])
def test_rans_kernel_batch_matches_plain_and_per_plane(cuda, shape):
    rng = np.random.default_rng([22, *shape])
    planes = torch.from_numpy((rng.geometric(0.2, shape) % 256).astype(np.uint8)).to(cuda)
    sym = planes.reshape(shape[0], -1)
    got = tpurans.encode_batch(sym)
    _assert_rans_equal(got, tpurans.encode_plain(sym))
    pos = 0
    for i in range(shape[0]):
        one = tpurans.encode_batch(sym[i : i + 1])
        total = int(one[1].sum())
        assert torch.equal(got[0][i], one[0][0]) and torch.equal(got[1][i], one[1][0])
        assert torch.equal(got[3][pos : pos + total], one[3][:total])
        pos += total


def test_rans_kernel_rejects_what_it_does_not_take(cuda):
    with pytest.raises(ValueError, match="empty stream"):
        tpurans.encode_batch(torch.zeros(1, 0, dtype=torch.uint8, device=cuda))
    with pytest.raises(ValueError, match="uint8"):
        tpurans.encode_batch(torch.zeros(1, 8, dtype=torch.int32, device=cuda))
    with pytest.raises(ValueError, match="contiguous"):
        tpurans.encode_batch(torch.zeros(2, 16, dtype=torch.uint8, device=cuda)[:, ::2])


@pytest.mark.parametrize("name", list(STREAMS) + ["empty"])
def test_bitpack_kernels_match_plain_version(cuda, name):
    data = STREAMS.get(name, np.zeros(0, np.uint8))
    flat = torch.from_numpy(data).to(cuda)
    packed, widths, nb = bitpack.pack_blocks(flat)
    want = bitpack.pack_plain(flat)
    assert nb == want[2] and torch.equal(packed, want[0]) and torch.equal(widths, want[1])
    expanded = torch.from_numpy(bitpack.expand_packed(
        bitpack.finalize_packed(packed.cpu().numpy(), widths.cpu().numpy(), nb, data.size))[0]
    ).to(cuda)
    out = bitpack.unpack_blocks(expanded)
    assert torch.equal(out, bitpack.unpack_plain(expanded))
    assert np.array_equal(out[: data.size].cpu().numpy(), data)
    assert np.array_equal(bitpack.unpack_bytes(bitpack.pack_bytes(data, cuda), device=cuda), data)


def _bitpack_streams():
    """STREAMS and the compacting kernels' edges: every block keeping all 8
    planes (128 folds to 255), every block keeping none, and nb % 4 of 1
    and 2, where the body's planes start at an odd offset."""
    rng = np.random.default_rng(24)
    out = dict(STREAMS)
    wide = (rng.geometric(0.3, 9 * 1024 + 77) % 256).astype(np.uint8)
    wide[::1024] = 128
    out["all-8"] = wide
    out["all-0"] = np.zeros(7 * 1024 + 5, np.uint8)
    out["nb5"] = (rng.geometric(0.3, 4 * 1024 + 1) % 256).astype(np.uint8)
    out["nb6"] = (rng.geometric(0.3, 6000) % 256).astype(np.uint8)
    out["nb2025"] = (rng.geometric(0.2, 1080 * 1920) % 256).astype(np.uint8)
    return out


BITPACK_STREAMS = _bitpack_streams()


def _one_byte_in(t):
    buf = torch.empty(1 + t.numel(), dtype=torch.uint8, device=t.device)
    buf[1:].copy_(t)
    return buf[1:]


@pytest.mark.parametrize("name", list(BITPACK_STREAMS))
def test_compacting_bitpack_kernels_match_plain_version(cuda, name):
    data = BITPACK_STREAMS[name]
    n = data.size
    flat = torch.from_numpy(data).to(cuda)
    want = bitpack.pack_stream_plain(flat)
    assert torch.equal(bitpack.pack_stream(flat), want)
    assert torch.equal(bitpack.pack_stream(_one_byte_in(flat)), want)
    plain = bitpack.unpack_stream_plain(want, n)
    assert torch.equal(plain, flat)
    pad = -(8 + (-(-n // bitpack.BLOCK) + 1) // 2) % 16
    placed = torch.empty(pad + want.numel(), dtype=torch.uint8, device=cuda)
    placed[pad:].copy_(want)
    for body in (want, placed[pad:], _one_byte_in(want)):
        assert torch.equal(bitpack.unpack_stream(body, n), plain)


@pytest.mark.parametrize("per_warp", [1, 2, 4])
@pytest.mark.parametrize("name", ["all-8", "nb5", "nb2025", "uniform-65536"])
def test_compacting_kernels_every_way(cuda, name, per_warp):
    """Each number of blocks a warp, over calls one after another, each of
    compacting K6's with its look-back words zeroed anew."""
    data = BITPACK_STREAMS[name]
    n = data.size
    flat = torch.from_numpy(data).to(cuda)
    want = bitpack.pack_stream_plain(flat)
    expanded = torch.from_numpy(bitpack.expand_packed(want.cpu().numpy().tobytes(), n)[0]).to(cuda)
    for i in range(8):
        buf, head, start = bitpack.pack_compact(flat, per_warp)
        total = int(buf[:8].view(torch.int64).item())
        assert torch.equal(buf[head : start + 128 * total], want), i
        assert torch.equal(bitpack.unpack_stream(want, n, per_warp), flat), i
        assert torch.equal(bitpack.unpack_blocks(expanded, per_warp)[:n], flat), i
        assert torch.equal(bitpack.pack_blocks(flat, per_warp)[0], bitpack.pack_plain(flat)[0]), i
    with pytest.raises(ValueError, match="per must be one of"):
        bitpack.pack_compact(flat, 3)


@pytest.mark.parametrize("name", list(BITPACK_STREAMS) + ["empty"])
def test_bitpack_bytes_round_trip_on_the_card(cuda, name):
    data = BITPACK_STREAMS.get(name, np.zeros(0, np.uint8))
    bitpack.h2d_bytes = bitpack.d2h_bytes = 0
    blob = bitpack.pack_bytes(data, cuda)
    assert blob == bitpack.pack_bytes(data, "cpu")
    if data.size:
        assert bitpack.h2d_bytes == data.size and bitpack.d2h_bytes <= len(blob) + 64
    bitpack.h2d_bytes = bitpack.d2h_bytes = 0
    assert np.array_equal(bitpack.unpack_bytes(blob, data.size, cuda), data)
    if data.size:
        assert (bitpack.h2d_bytes, bitpack.d2h_bytes) == (len(blob), data.size)


def test_empty_stream_on_the_card_launches_nothing(cuda, monkeypatch):
    """An empty stream's body is the 8-byte header of zeros, made on the
    card without a kernel and without the plain versions."""
    def plain(*args):
        raise AssertionError("a plain version ran on the card's path")

    monkeypatch.setattr(bitpack, "pack_stream_plain", plain)
    monkeypatch.setattr(bitpack, "unpack_stream_plain", plain)
    before = (bitpack.pack_launches, bitpack.unpack_launches)
    body = bitpack.pack_stream(torch.zeros(0, dtype=torch.uint8, device=cuda))
    assert body.device.type == "cuda" and body.tolist() == [0] * 8
    assert bitpack.pack_bytes(np.zeros(0, np.uint8), cuda) == bytes(8)
    assert bitpack.unpack_stream(body, 0).numel() == 0
    assert bitpack.unpack_bytes(bytes(8), 0, cuda).size == 0
    assert (bitpack.pack_launches, bitpack.unpack_launches) == before


@pytest.mark.parametrize("cut", ["short-body", "wide", "declared-size"])
def test_bitpack_read_on_the_card_checks_the_body_first(cuda, cut):
    blob = bitpack.pack_bytes(BITPACK_STREAMS["nb5"], "cpu")
    wide = bytearray(blob)
    wide[8] = 0xF9
    data, n = {"short-body": (blob[:-1], 4097), "wide": (bytes(wide), 4097),
               "declared-size": (blob, 4096)}[cut]
    before = bitpack.unpack_launches
    with pytest.raises(ValueError) as on_card:
        bitpack.unpack_bytes(data, n, cuda)
    with pytest.raises(ValueError) as on_cpu:
        bitpack.unpack_bytes(data, n, "cpu")
    assert str(on_card.value) == str(on_cpu.value)
    assert bitpack.unpack_launches == before


def test_fast_launch_counters(cuda):
    before = (tpurans.rans_launches, bitpack.pack_launches, bitpack.unpack_launches)
    data = STREAMS["geometric-1025"]
    tpurans.encode_bytes(data.tobytes(), cuda)
    bitpack.unpack_bytes(bitpack.pack_bytes(data, cuda), device=cuda)
    after = (tpurans.rans_launches, bitpack.pack_launches, bitpack.unpack_launches)
    assert after == (before[0] + 1, before[1] + 1, before[2] + 1)


def test_traced_device_time_leaves_out_the_spans_ranges(cuda):
    # Inside trace() every span is also a range, marked on the card's row
    # with its whole length; the device time read there is the same work,
    # launch for launch, as under a bare profile, which enters no range.
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from rustyhgi_tpu_torch import bench
    from rustyhgi_tpu_torch.utils import profiling

    images = np.stack([_image((256, 256), seed=s) // 4 for s in range(32)])
    codec = HGICodec(4, "lossless", backend="cuda")
    fn = lambda: codec.write_fast_batch(images)  # noqa: E731
    traced = profiling.device_trace(fn, bench.REPEATS)
    with profiling.trace(None, "cuda") as prof:
        for _ in range(bench.REPEATS):
            fn()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as bare:
        for _ in range(bench.REPEATS):
            fn()
        torch.cuda.synchronize()
    plain = {e.key: e for e in bare.key_averages()
             if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0}
    assert any("rans_encode_lanes" in k for k in plain)  # keys are the kernels' signatures
    assert set(traced) == set(plain)
    assert {e.key: e.count for e in profiling.device_averages(prof)} == {
        k: e.count for k, e in plain.items()}
    want = sum(e.self_device_time_total for e in plain.values()) / bench.REPEATS / 1e6
    assert sum(r.seconds for r in traced.values()) == pytest.approx(want, rel=0.5)


@pytest.mark.parametrize("preset", ["lossless", "medium"])
def test_codec_write_fast_backends_agree(cuda, preset):
    images = np.stack([_image((135, 240), seed=s) // 4 for s in range(3)])
    kern = HGICodec(4, preset, backend="cuda")
    plain = HGICodec(4, preset, backend="torch")
    blobs = kern.write_fast_batch(images)
    assert blobs == plain.write_fast_batch(images)
    assert blobs == [kern.write_fast(img) for img in images]


# -- K8, the op-rate probe ---------------------------------------------------


@pytest.mark.parametrize("shape", [(1, 37, 53), (3, 7, 1), (2, 1, 7), (1, 17, 29),
                                   (2, 40, 64), (1, 5, 6)])
@pytest.mark.parametrize("kind", vpucal.KINDS)
def test_probe_kernel_matches_plain_version(cuda, shape, kind):
    img = torch.from_numpy(_image(shape)).to(cuda)
    for k in (0, 1, 2, 7, 40, 200):
        assert torch.equal(vpucal.vpucal_chain(img, kind, k), vpucal.vpucal_plain(img, kind, k))


@pytest.mark.parametrize("kind", vpucal.KINDS)
def test_probe_kernel_on_an_unaligned_buffer(cuda, kind):
    # W % 4 == 0 but the data starts one byte into its buffer: the kernel
    # takes its byte-wise path.
    buf = torch.from_numpy(_image((1 + 3 * 16 * 64,))).to(cuda)
    img = buf[1:].view(3, 16, 64)
    assert torch.equal(vpucal.vpucal_chain(img, kind, 9), vpucal.vpucal_plain(img, kind, 9))


def test_probe_kernel_launch_counter(cuda):
    img = torch.from_numpy(_image((2, 8, 12))).to(cuda)
    before = vpucal.vpucal_launches
    vpucal.vpucal_chain(img, "mix3", 3)
    vpucal.vpucal_chain(torch.empty(0, 4, 4, dtype=torch.uint8, device=cuda), "mix3", 3)
    assert vpucal.vpucal_launches == before + 1


@pytest.mark.parametrize("preset", ["lossless", "medium"])
@pytest.mark.parametrize("pred", ["crossed", "left_top"])
def test_color_on_the_card_writes_and_reads_the_cpu_bytes(cuda, preset, pred):
    from rustyhgi_tpu_torch.utils import color

    rgb = np.stack([_image((61, 77), seed=s) // (s + 1) for s in range(3)], 2)
    blobs = [color.encode_color(HGICodec(4, preset, predictor=pred, device=d), rgb, "thgi")
             for d in ("cpu", cuda)]
    assert blobs[0] == blobs[1]
    full = color.decode_color(blobs[1], device=cuda)
    assert np.array_equal(full, color.decode_color(blobs[1], device="cpu"))
    preview = color.decode_color_preview(blobs[1], 2, device=cuda)
    assert np.array_equal(preview, full[::4, ::4])


@pytest.mark.parametrize("preset", ["lossless", "medium"])
def test_batch_split_on_the_card_matches_the_cpu(cuda, preset):
    from rustyhgi_tpu_torch.parallel import (decode_batch_sharded, encode_batch_sharded,
                                             make_mesh)

    batch = _image((4, 40, 56))
    q = QuantizationLevel.parse(preset)
    on_card = encode_batch_sharded(batch, 4, q, mesh=make_mesh(), with_histogram=True)
    on_cpu = encode_batch_sharded(batch, 4, q, mesh=make_mesh(devices=["cpu"] * 2),
                                  with_histogram=True)
    for got, want in zip(on_card, on_cpu):
        assert got.device.type == "cuda" and torch.equal(got.cpu(), want)
    decoded = decode_batch_sharded(on_card[0], 4, mesh=make_mesh())
    assert torch.equal(decoded, on_card[1])


@pytest.mark.parametrize("preset", ["lossless", "medium"])
@pytest.mark.parametrize("pred", ["crossed", "left_top"])
def test_custom_ops_on_the_card_match_the_plain_version(cuda, preset, pred):
    from rustyhgi_tpu_torch.ops import library

    img = torch.from_numpy(_image((2, 67, 131))).to(cuda)
    table = _table(QuantizationLevel.parse(preset))
    lossless = table is None
    table_u8 = torch.zeros(256, dtype=torch.uint8) if lossless else table.to(torch.uint8)
    before = cuda_codec.encode_launches, cuda_codec.decode_launches
    grid, recon = library.encode_plane(img, table_u8.to(cuda), 4, pred, lossless)
    dec = library.decode_plane(grid, 4, pred)
    assert (cuda_codec.encode_launches, cuda_codec.decode_launches) == (before[0] + 1,
                                                                       before[1] + 1)
    want_grid, want_recon = pyramid.encode_plane(img.cpu(), 4, table, pred)
    assert grid.device.type == "cuda"
    assert torch.equal(grid.cpu(), want_grid) and torch.equal(recon.cpu(), want_recon)
    assert torch.equal(dec.cpu(), pyramid.decode_plane(want_grid, 4, pred))


@pytest.mark.parametrize("preset", ["lossless", "medium"])
def test_export_on_the_card_round_trips(cuda, preset):
    from rustyhgi_tpu_torch.models.codec import load_exported

    codec = HGICodec(4, preset, device=cuda).compile((90, 140))
    enc = load_exported(codec.export_encoder((90, 140)))
    dec = load_exported(codec.export_decoder((90, 140)))
    img = torch.from_numpy(_image((90, 140))).to(cuda)
    before = cuda_codec.encode_launches
    grid, recon = enc(img)
    assert cuda_codec.encode_launches == before + 1
    want_grid, want_recon = codec.encode_plane(img)
    assert grid.device.type == "cuda"
    assert torch.equal(grid, want_grid) and torch.equal(recon, want_recon)
    assert torch.equal(dec(grid), recon)


def test_dryrun_on_the_card(cuda):
    from rustyhgi_tpu_torch.dryrun import dryrun_multichip, entry

    dryrun_multichip(4)
    forward, (example,) = entry()
    grid, _ = forward(example)
    assert grid.device.type == "cuda"


def test_probe_validate_on_the_small_cases(cuda):
    """``chip_probe validate`` on the JAX probe's three small cases: K1, K2,
    K3, K5, the plain version and the C++ stand-in against the oracle."""
    from rustyhgi_tpu_torch.tools import chip_probe

    out = chip_probe.validate(chip_probe.VALIDATE_CASES[2:])
    assert out["ok"]
    for case, row in out["validate"].items():
        for column, ok in row.items():
            assert ok or (ok is None and column == "native" and case.endswith("left_top")), \
                (case, column)
    assert all(out["launches"][k] >= 3 for k in ("K1", "K2", "K3", "K5"))
