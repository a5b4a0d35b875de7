"""The benchmark's arithmetic: percentiles, spreads, the union of device
intervals, the open loop's schedule, the closed loop's sample, the
end-to-end readers, the host timers, the work a roofline counts, and
what a profiled slice yields."""

import statistics
from types import SimpleNamespace

import numpy as np
import pytest

from hgibench import roofline, spec, stats
from hgibench.clock import Clock
from hgibench.core import Request
from hgibench.drivers import closed_loop, open_loop
from hgibench.run import Ctx
from hgibench.reference import formats
from hgibench.trace import Reading, short_name


@pytest.mark.parametrize("n, q, want", [(100, 95, 95), (20, 95, 19), (1, 95, 1), (7, 50, 4),
                                        (1000, 99, 990)])
def test_percentile_is_nearest_rank_over_every_value(n, q, want):
    values = list(range(n, 0, -1))  # order does not matter
    assert stats.percentile(values, q) == want


def test_quartile_spread_uses_statistics_quantiles():
    v = [10.0, 11.0, 12.5, 9.0, 10.5, 30.0]
    q1, q2, q3 = statistics.quantiles(v, n=4)
    assert stats.quartile_spread(v) == pytest.approx((q3 - q1) / q2)


def test_trimmed_spread_leaves_out_the_run_farthest_from_the_median():
    v = [10.0, 11.0, 12.5, 9.0, 10.5, 30.0]
    assert stats.trimmed_spread(v) == pytest.approx(stats.quartile_spread(v[:5]))
    assert stats.trimmed_spread(v) < stats.quartile_spread(v)


@pytest.mark.parametrize("intervals, lo, hi, busy, gaps", [
    ([(1, 2), (1.5, 3), (5, 6)], 0, 10, 3.0, [(0, 1), (3, 5), (6, 10)]),
    ([(0, 10), (2, 3)], 0, 10, 10.0, []),
    ([(-5, 1), (9, 20)], 0, 10, 2.0, [(1, 9)]),
    ([], 0, 4, 0.0, [(0, 4)]),
    ([(2, 4), (4, 5)], 0, 5, 3.0, [(0, 2)]),
])
def test_union_and_gaps_of_device_intervals(intervals, lo, hi, busy, gaps):
    assert stats.union_seconds(intervals, lo, hi) == pytest.approx(busy)
    assert stats.idle_gaps(intervals, lo, hi) == gaps


@pytest.mark.parametrize("seed", [0, 1, 2**31 + 7, 123456789012])
def test_schedule_gives_every_seed_the_same_gaps_in_another_order(seed):
    arr, items = open_loop.schedule(seed, 300.0, 10.0, 16)
    base, base_items = open_loop.schedule(5, 300.0, 10.0, 16)
    assert len(arr) == 3000 and arr[0] == 0.0 and (np.diff(arr) > 0).all() and arr[-1] < 10.0
    gaps = np.sort(np.diff(np.append(arr, 10.0)))
    assert np.allclose(gaps, np.sort(np.diff(np.append(base, 10.0))), rtol=0, atol=1e-9)
    assert sorted(items.tolist()) == sorted(base_items.tolist())
    assert np.bincount(items, minlength=16).min() >= 3000 // 16


def test_schedule_is_the_seeds_own():
    a, ia = open_loop.schedule(11, 50.0, 4.0, 4)
    b, ib = open_loop.schedule(11, 50.0, 4.0, 4)
    c, _ = open_loop.schedule(12, 50.0, 4.0, 4)
    assert np.array_equal(a, b) and np.array_equal(ia, ib) and not np.array_equal(a, c)


def _ctx(requests, seconds=10.0, **kw):
    window = SimpleNamespace(requests=requests, seconds=seconds)
    ctx = SimpleNamespace(window=window, seconds=seconds, ok=[r for r in requests if r.ok], **kw)
    return ctx


def test_rates_are_all_the_work_of_the_window_over_its_seconds():
    reqs = [Request(i, 0, i / 10, i / 10, i / 10 + 0.1, True,
                    {"pixels": 1_000_000, "bytes": 125_000}) for i in range(201)]
    ctx = _ctx(reqs, seconds=20.0)  # the last request ends after the window's close
    for name in ("write_mpix_s", "read_mpix_s"):
        assert spec.load_metric(name).read(ctx) == pytest.approx(200 / 20.0)
    assert spec.load_metric("scene_mpix_s").read(ctx) == pytest.approx(201 / 20.0)
    assert spec.load_metric("bits_per_pixel").read(ctx) == pytest.approx(1.0)
    assert spec.load_metric("write_mpix_s").read(_ctx([])) == 0.0


def test_setup_leaves_out_the_references_seconds():
    reader = spec.load_metric("setup_s")
    assert reader.read(SimpleNamespace(setup_s=12.5, state=SimpleNamespace())) == 12.5
    assert reader.read(SimpleNamespace(setup_s=12.5, state=SimpleNamespace(reference_s=3.0))) == 9.5


def test_warm_up_calls_stay_out_of_a_requests_host_time():
    class Owner:
        @staticmethod
        def work():
            return None

    clock = Clock({"work": [(Owner, "work")]}, lambda: None)
    reqs = [Request(i, 0, 0.0, 0.0, 0.001, True) for i in range(4)]

    def ctx(window_t0):
        window = SimpleNamespace(requests=reqs, seconds=1.0, t0=window_t0)
        return Ctx(SimpleNamespace(entry=None), None, window, 0.0, clock=clock)

    with clock:
        Owner.work()
    assert len(clock.calls["work"]) == 1
    warm_up = [(1.0, 1.5), (2.0, 2.5), (5.0, 9.9)]
    window = [(10.0, 10.5), (11.0, 11.5), (12.0, 12.5), (13.0, 13.5)]
    clock.calls["work"] = warm_up + window
    assert ctx(10.0).per_request_ms("work") == pytest.approx(500.0)
    assert ctx(0.0).per_request_ms("work") == pytest.approx(500.0 + 1e3 * 5.9 / 4)


@pytest.mark.parametrize("count", [3, 256, 1000, 70_000])
def test_the_closed_loops_sample_is_the_seeds_and_uniform(count):
    def kept(seed):
        r = closed_loop.Reservoir(256, seed)
        for i in range(count):
            r.offer(i, i)
        return r.kept

    a = kept(2**31 + 5)
    assert a == kept(2**31 + 5) and len(a) == min(count, 256)
    assert all(k == v and 0 <= k < count for k, v in a.items())
    if count > 1000:
        assert a != kept(6)
        # a uniform sample: about as many in each half
        assert abs(sum(k < count // 2 for k in a) - 128) < 40


def test_the_closed_loop_stops_at_the_window_and_accounts_each_request():
    entry = SimpleNamespace(request=lambda s, item: item,
                            account=lambda s, item, out: (10, 100))
    w = closed_loop.run(entry, None, {"pool": 3, "sample": 5}, 7, 0.05)
    assert w.attempted > 5 and w.failed == 0 and len(w.kept) == 5
    assert all(r.start < 0.05 for r in w.requests) and w.requests[-1].item == (w.attempted - 1) % 3
    assert all(r.info == {"bytes": 10, "pixels": 100} for r in w.requests)
    assert all(w.kept[i] == w.requests[i].item for i in w.kept)


def test_work_of_each_function_from_its_shapes():
    n = 1080 * 1920
    assert roofline.k1_work(1, n, True) == pytest.approx(3 * n / 3.35e12)
    assert roofline.k1_work(32, 512 * 512, False) == pytest.approx(2 * 32 * 512 * 512 / 3.35e12)
    assert roofline.k2_work(2, n) == pytest.approx(4 * n / 3.35e12)
    lanes, rows = 2048, -(-n // 2048)
    words = 100_000
    by_bytes = (n + 4 * (256 + 2 * lanes) + 2 * words) / 3.35e12
    by_ops = roofline.X1_OPS_PER_SYMBOL * lanes * rows / (132 * 128 * 1980e6)
    assert roofline.x1_work(1, n, words) == pytest.approx(max(by_bytes, by_ops))
    assert roofline.share(1.0, 4.0) == 25.0 and roofline.share(1.0, 0.0) is None


@pytest.mark.parametrize("h, w", [(64, 96), (40, 300)])
def test_coded_words_match_the_archive(h, w):
    planes = np.random.default_rng(0).integers(0, 256, (1, h, w), dtype=np.uint8)
    blob = formats.write_fast(planes, 4, "medium")[0]
    counts_at = 38 + 8 + 512
    lanes = int.from_bytes(blob[38 + 4 : 38 + 8], "little")
    counts = np.frombuffer(blob, "<u2", lanes, counts_at)
    assert formats.coded_words(len(blob), h * w) == int(counts.sum())


def test_a_slice_reading_checks_records_against_launches():
    device = [("void encode_tiles<0, true>(unsigned char const*)", 1.0, 1.1),
              ("rans_histogram(unsigned char const*, int*, long long)", 1.1, 1.2),
              ("rans_normalize", 1.2, 1.25), ("void rans_encode_lanes<32>(int)", 1.25, 1.5),
              ("Memcpy DtoH (Device -> Pageable)", 1.5, 1.6), ("Memset (Device)", 2.0, 2.1)]
    host = [("h2d", 0.9, 1.05), ("fetch", 1.45, 1.7), ("write_fast", 0.8, 1.9)]
    r = Reading(device, host, (0.9, 2.5), {"K1": 1, "X1": 1})
    k1 = (("encode_tiles", "encode_level", "encode_lossless"), 1)
    x1 = (("rans_histogram", "rans_normalize", "rans_encode_lanes"), 3)
    assert r.complete({"K1": k1, "X1": x1}) is None
    assert "X1" in Reading(device[:3], host, (0.5, 2.5), {"K1": 1, "X1": 1}).complete(
        {"K1": k1, "X1": x1})
    assert r.busy_s == pytest.approx(0.7) and r.window_s == pytest.approx(1.6)
    assert r.device_seconds(k1[0]) == pytest.approx(0.1)
    b = r.breakdown()
    assert b["device_ops"][0] == ["rans_encode_lanes", pytest.approx(0.25)]
    gaps = dict(b["idle_gaps"])
    assert gaps == pytest.approx({"h2d": 0.1, "write_fast": 0.4, "between requests": 0.4})
    assert short_name("void decode_tiles<1>(unsigned char const*, int)") == "decode_tiles"
