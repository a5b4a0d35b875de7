"""What a scene cell's window counts, from hand-built requests: the
entry's ``count`` gives a scene cut by the close the blocks it had
written by then, and the scene readers read those; and every per-layer
metric moves an end-to-end metric that each of its cells reports."""

import json
import os
from types import SimpleNamespace

import pytest

from hgibench import run, spec
from hgibench.core import Request
from hgibench.entries import encode_tiled_fast

H, W, TILE = 1000, 1100, 512  # 2 x 3 tiles; the right and bottom ones cut
ENDS = [300, 500, 700, 900, 1100, 1300]  # each block's end in the output
LENS = [200, 188, 188, 188, 188, 188]  # each block's length; 12 bytes frame it
HEAD = ENDS[0] - 12 - LENS[0]  # the header's bytes, before the first block
TILE_PX = [512 * 512, 512 * 512, 512 * 76, 488 * 512, 488 * 512, 488 * 76]
with open(os.path.join(spec.PKG, "tests", "serving_cells.json")) as f:
    SERVING = json.load(f)  # the serving cells kept for later, added as a later PR would add them


def _counted(marks, seconds=10.0):
    """Requests, one a list of ``(host time, bytes drained)``, with the
    pixels and bytes the fast scene entry's ``count`` gives them."""
    s = SimpleNamespace(shape=(H, W), tile=TILE, expected={0: ("", ENDS, LENS)})
    s.outputs = [encode_tiled_fast._Output(0, "", m) for m in marks]
    requests = [Request(i, 0, 0.0, 0.0, m[-1][0], True) for i, m in enumerate(marks)]
    window = SimpleNamespace(requests=requests, seconds=seconds, t0=0.0)
    encode_tiled_fast.count(s, window)
    return requests


def _read(name, requests, seconds=10.0):
    window = SimpleNamespace(requests=requests, seconds=seconds, t0=0.0)
    return spec.load_metric(name).read(run.Ctx(SimpleNamespace(entry=None), None, window, 0.0))


def test_a_scene_cut_by_the_close_counts_the_blocks_it_wrote_before_it():
    whole = [(2.0, ENDS[-1])]
    cut = [(7.0, 450), (9.5, 850), (12.0, ENDS[-1])]  # 3 blocks by the close at 10 s
    requests = _counted([whole, cut])
    pixels = H * W + sum(TILE_PX[:3])
    assert [r.info for r in requests] == [{"pixels": H * W, "bytes": ENDS[-1]},
                                          {"pixels": sum(TILE_PX[:3]), "bytes": ENDS[2]}]
    assert _read("scene_mpix_s", requests) == pytest.approx(pixels / 10.0 / 1e6)
    assert _read("bits_per_pixel", requests) == pytest.approx(8 * (ENDS[-1] + ENDS[2]) / pixels)


@pytest.mark.parametrize("drained, nbytes", [(HEAD - 1, 0), (HEAD, HEAD), (ENDS[0] - 1, HEAD)])
def test_a_scene_cut_before_its_first_block_adds_no_pixel(drained, nbytes):
    requests = _counted([[(4.0, ENDS[-1])], [(9.0, drained), (15.0, ENDS[-1])]])
    assert requests[1].info == {"pixels": 0, "bytes": nbytes}
    assert _read("scene_mpix_s", requests) == pytest.approx(H * W / 10.0 / 1e6)


@pytest.mark.parametrize("with_serving", [False, True], ids=["file", "with-serving"])
def test_each_per_layer_metric_moves_a_metric_that_every_one_of_its_cells_reports(with_serving):
    b = spec.merge(spec.load_bench(), SERVING) if with_serving else spec.load_bench()

    def reported(cell):
        return {m["name"] for m in b["end_to_end"] if cell in m.get("workloads", [cell])}

    for m in b["per_layer"]:
        cells = m.get("workloads") or [w["name"] for w in b["workloads"]
                                       if m["moves"] in reported(w["name"])]
        assert cells and all(m["moves"] in reported(c) for c in cells), m["name"]
