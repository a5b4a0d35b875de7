"""The racing scene cell on the CPU: the reference race (``reference/race.py``)
against the program's ``write_thgi`` byte for byte, its decoders, the
scene generator, the span readers, and whole small runs of the cell with
its two controls and a planted fault."""

import time
from types import SimpleNamespace

import numpy as np
import pytest

from hgibench import run, spans, spec
from hgibench.reference import ctx, hgi, hostrans, race
from hgibench.scenes import race_scenes

CELL = "ikonos-scene-race"
SMALL = {"config": {"codec": {"height": 300, "width": 530, "tile": 128}}}


def _program(grid, levels, preset, codecs=None):
    from rustyhgi_tpu_torch.ops.quantizers import QuantizationLevel
    from rustyhgi_tpu_torch.utils import container as tc

    meta = tc.Metadata(quantization_level=QuantizationLevel.parse(preset), interpolation=0,
                       width=grid.shape[1], height=grid.shape[0], scale_level=levels)
    return tc.write_thgi(tc.Archive(meta, grid), codecs=codecs)


def _native():
    from rustyhgi_tpu_torch.ops import native

    if not native.available():
        pytest.skip("the program races ctx only with its native coders")


def _planes(seed, count, h, w, noise):
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    base = (x * 3 + y * 2) // 2 % 200
    return (base + rng.normal(0, noise, (count, h, w))).clip(0, 255).astype(np.uint8)


@pytest.fixture(scope="module")
def scene_tiles():
    """The four 512 x 512 tiles of a 1024 x 1024 plane of the cell's
    generator, their reference race and the program's blocks."""
    cfg = spec.load_cell(CELL).config
    plane = race_scenes(2**31 + 5, 1, 1024, 1024, cfg["scene"]["sigma_lo"],
                        cfg["scene"]["sigma_hi"])[0].numpy()
    tiles = plane.reshape(2, 512, 2, 512).transpose(0, 2, 1, 3).reshape(4, 512, 512)
    blocks, wins = race.race_tiles(tiles, 4, "lossless")
    grids, _ = hgi.encode(tiles, 4, 0, "crossed")
    return tiles, blocks, wins, grids


def test_the_reference_race_is_the_programs_on_whole_tiles(scene_tiles):
    _native()
    _, blocks, _, grids = scene_tiles
    assert blocks == [_program(g, 4, "lossless") for g in grids]


def test_the_generator_makes_ctx_win_a_tile(scene_tiles):
    _, _, wins, _ = scene_tiles
    assert race.tally(wins).get("subband.ctx", 0) >= 1


@pytest.mark.parametrize("preset", ("lossless", "medium"))
@pytest.mark.parametrize("codecs", [None, ["deflate"], ["rans"], ["ctx"]],
                         ids=["race", "deflate", "rans", "ctx"])
@pytest.mark.parametrize("hw", [(96, 130), (64, 64)], ids=["ragged", "square"])
def test_the_reference_race_is_the_programs_byte_for_byte(hw, codecs, preset):
    if codecs is None or "ctx" in codecs:
        _native()
    tiles = _planes(7, 3, *hw, 6.0)
    grids, _ = hgi.encode(tiles, 4, hgi.ERRORS[preset], "crossed")
    ours, wins = race.race(grids, 4, preset, codecs=codecs or ("deflate", "rans", "ctx"))
    assert ours == [_program(g, 4, preset, codecs) for g in grids]
    assert race.decode_tiles(ours).tolist() == hgi.decode(grids, 4).tolist()
    if codecs is not None:
        assert {race.CODECS[c] for _, c in wins} == set(codecs)


def test_the_reference_decoders_round_trip(scene_tiles):
    tiles, blocks, wins, _ = scene_tiles
    picked = [i for i, (_, c) in enumerate(wins) if c == race.CTX][:1] + [3]
    assert race.decode_tiles([blocks[i] for i in picked]).tolist() == tiles[picked].tolist()
    data = _planes(3, 4, 40, 50, 30.0).reshape(4, -1)
    assert hostrans.decode(hostrans.encode(data), data.shape[1]).tolist() == data.tolist()
    pieces = race.subband_pieces(40, 50, 3)
    payload = race.subband_payload(data.reshape(4, 40, 50), 3)
    for shift in (4, 5):
        assert ctx.decode(ctx.encode(payload, pieces, shift), pieces, shift).tolist() == \
            payload.tolist()


@pytest.mark.parametrize("data", [np.zeros((1, 1 << 20), np.uint8)], ids=["1MiB"])
def test_the_reference_refuses_the_two_stream_framings(data):
    with pytest.raises(ValueError, match="two-stream"):
        race.race(data.reshape(1, 1024, 1024), 0, "lossless")


def test_a_tie_given_to_the_later_candidate_changes_the_archive():
    # A tile whose subband payload is its grid reordered, coded by rANS
    # alone: one order-0 table, so both layouts' streams come out alike.
    grids = np.full((2, 64, 64), 7, np.uint8)
    first, wins = race.race(grids, 4, "lossless", codecs=("rans",))
    last, late = race.race(grids, 4, "lossless", tie="last", codecs=("rans",))
    assert {w for w in wins} == {(race.ROWMAJOR, race.RANS)}
    assert {w for w in late} == {(race.SUBBAND, race.RANS)} and first != last
    assert race.decode_tiles(last).tolist() == hgi.decode(grids, 4).tolist()


def test_the_generator_is_seeded():
    a = race_scenes(11, 2, 64, 96, 10.0, 32.0)
    assert a.shape == (2, 64, 96) and (a == race_scenes(11, 2, 64, 96, 10.0, 32.0)).all()
    assert (a != race_scenes(12, 2, 64, 96, 10.0, 32.0)).any() and (a[0] != a[1]).any()


# -- the readers of the race's spans ---------------------------------------------


def _span(i, name, parent, request, a, b):
    return SimpleNamespace(id=i, name=name, parent=parent, request=request, start_ns=a, end_ns=b,
                           nbytes=None, depth=0)


def _ctx(records, monkeypatch, served=1, close_s=10.0):
    monkeypatch.setattr(spans, "window_spans", lambda ctx: records)
    window = SimpleNamespace(t0=0.0, seconds=close_s, requests=[])
    return SimpleNamespace(window=window, reading=object(), ok=[SimpleNamespace(info={}) for _ in range(served)])


def _scene(first, start, end):
    """A scene's spans: the command, two races and the coders' jobs."""
    ms = 1_000_000
    return [_span(first, "cli.encode_tiled", None, first, start, end),
            _span(first + 1, "tiles.race", first, first, start, start + 10 * ms),
            _span(first + 2, "tiles.race", first, first, start + 10 * ms, start + 30 * ms),
            _span(first + 3, "coder.ctx", first + 1, first, start, start + 8 * ms),
            _span(first + 4, "coder.deflate", first + 1, first, start, start + 6 * ms),
            _span(first + 5, "coder.rans", first + 2, first, start + 10 * ms, start + 12 * ms),
            _span(first + 6, "tiles.fetch", first, first, start, start + 4 * ms)]


def test_the_readers_count_every_scene_the_window_started_whole(monkeypatch):
    s = 1_000_000_000
    first = _scene(1, 1 * s, 5 * s)
    cut = _scene(100, 6 * s, 12 * s)  # the close at 10 s cuts it; it runs to its end
    ctx_ = _ctx(first + cut, monkeypatch, served=2)
    read = {name: spec.load_metric(name).read(ctx_) for name in
            ("race_ms.race", "ctx_ms.race", "deflate_ms.race", "rans_ms.race",
             "pool_busy_pct.race", "grid_fetch_ms.race")}
    assert read == {"race_ms.race": 30.0, "ctx_ms.race": 8.0, "deflate_ms.race": 6.0,
                    "rans_ms.race": 2.0, "pool_busy_pct.race": 100.0 * 16 / (4 * 30),
                    "grid_fetch_ms.race": 4.0}


@pytest.mark.parametrize("records", [None, [], "other"], ids=["untraced", "none", "other-spans"])
def test_the_readers_read_nothing_without_their_spans(records, monkeypatch):
    if records == "other":
        records = [_span(1, "cli.encode_tiled", None, 1, 0, 10), _span(2, "tiles.chunk", 1, 1, 0, 5)]
    ctx_ = _ctx(records, monkeypatch)
    for name in ("race_ms.race", "ctx_ms.race", "deflate_ms.race", "rans_ms.race",
                 "pool_busy_pct.race", "grid_fetch_ms.race", "ctx_wins_pct.race"):
        assert spec.load_metric(name).read(ctx_) is None


def test_the_win_share_reads_every_request_served():
    req = lambda wins: SimpleNamespace(info={"wins": wins} if wins else {})  # noqa: E731
    ok = [req({"1.4": 3, "0.0": 1}), req({"1.1": 4}), req({"1.4": 4}), req(None)]
    ctx_ = SimpleNamespace(window=SimpleNamespace(seconds=10.0), ok=ok)
    assert spec.load_metric("ctx_wins_pct.race").read(ctx_) == 100.0 * 7 / 12



SPAN_READERS = ("split_ms.encode", "h2d_ms.encode", "h2d_gb_s.encode", "frame_ms.encode",
                "out_ms.encode", "race_ms.race", "ctx_ms.race", "deflate_ms.race",
                "rans_ms.race", "pool_busy_pct.race", "grid_fetch_ms.race")


def test_every_span_reader_of_the_cell_reads_the_programs_racing_encode(tmp_path, monkeypatch):
    """The cell's span readers on the spans a small racing encode-tiled
    records, the coders' jobs on the pool's threads among them."""
    _native()
    from PIL import Image
    from rustyhgi_tpu_torch import cli
    from rustyhgi_tpu_torch.utils import profiling

    cell = spec.load_cell(CELL)
    assert {m["name"] for m in cell.per_layer} >= set(SPAN_READERS)
    Image.fromarray(race_scenes(7, 1, 96, 160, 9.0, 28.8)[0].numpy()).save(tmp_path / "s.tif")
    profiling.enable_spans(spans.CAPACITY)
    since = time.perf_counter_ns()
    rc = cli.main(["encode-tiled", "-i", str(tmp_path / "s.tif"), "-o", str(tmp_path / "s.thgit"),
                   "--tile", "64", "--format", "thgi", "--device", "cpu"])
    assert rc == 0
    ctx_ = _ctx(profiling.spans(since), monkeypatch)
    read = {name: spec.load_metric(name).read(ctx_) for name in SPAN_READERS}
    assert all(v is not None and v > 0 for v in read.values()), read
    assert read["pool_busy_pct.race"] <= 100.0

# -- whole small runs on the CPU ---------------------------------------------------


def _run(trace=False, control=False, overrides=SMALL, seconds=2.0):
    return run.run_cell(CELL, 2**31 + 11, seconds, trace, device="cpu", overrides=overrides,
                        control=control, t0=time.perf_counter())


def test_a_small_run_is_correct_and_prints_its_result_line():
    _native()
    r = _run()
    assert r["correct"] and r["failed"] == 0 and r["attempted"] > 0
    assert set(r["metrics"]) == {"bits_per_pixel", "setup_s"}
    assert all(v["value"] <= v["limit"] for v in r["checks"].values())
    traced = _run(trace=True)
    assert traced["correct"] and traced["metrics"]["ctx_wins_pct.race"]["value"] >= 0


@pytest.mark.parametrize("kind", ["tie", "lossy"])
def test_the_controls_are_not_correct(kind):
    overrides = {"config": dict(SMALL["config"], control=kind)}
    r = _run(control=True, overrides=overrides)
    assert not r["correct"] and r["checks"]["outputs_differing"]["value"] > 0
    if kind == "lossy":
        assert r["checks"]["max_abs_error"]["value"] > 0


def test_a_block_altered_by_the_program_is_not_correct(monkeypatch):
    _native()
    from rustyhgi_tpu_torch import cli

    write = cli.write_archive

    def altered(archive, fmt="hgi", freqs=None):
        blob = bytearray(write(archive, fmt, freqs=freqs))
        blob[-1] ^= 1
        return bytes(blob)

    monkeypatch.setattr(cli, "write_archive", altered)
    assert not _run()["correct"]
