"""The port's device rANS (X1's plain version, framing, decoders) against
``rustyhgi_tpu.ops.tpurans``.

Inputs come from numpy seeds and go through both packages; the tolerance
is exact equality everywhere: the table, the counts, the states and the
stored words, the payload bytes, the decoded bytes and the error messages.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rustyhgi_tpu.ops import native as jnative
from rustyhgi_tpu.ops import tpurans as jt

from rustyhgi_tpu_torch.ops import native, tpurans


def _stream_cases():
    rng = np.random.default_rng(31)
    cases = {}
    for n in (1, 2, 127, 128, 129, 511, 512, 513, 65536):
        cases[f"uniform-{n}"] = rng.integers(0, 256, n, dtype=np.uint8)
        cases[f"geometric-{n}"] = (rng.geometric(0.3, n) % 256).astype(np.uint8)
    cases["zeros"] = np.zeros(10000, np.uint8)
    cases["one-symbol"] = np.full(3000, 255, np.uint8)
    cases["two-symbols"] = np.tile(np.array([0, 255], np.uint8), 500)
    cases["all-256"] = np.tile(np.arange(256, dtype=np.uint8), 4)
    cases["single-byte"] = np.array([7], np.uint8)
    return cases


STREAMS = _stream_cases()
_jax_encode = jax.jit(jt.encode_device)


def _jax_outputs(data):
    freq, counts, states, stream = (np.asarray(a) for a in _jax_encode(jnp.asarray(data)))
    return freq, counts, states, stream.reshape(-1)[: int(counts.sum())]


def _ours(out):
    """The port's outputs as numpy: (freq, counts, states u32, words u16)."""
    freq, counts, states, stream = out
    total = int(counts.sum())
    return (freq.numpy(), counts.numpy(), states.numpy().view(np.uint32),
            stream[:total].numpy().view(np.uint16))


@pytest.mark.parametrize("name", list(STREAMS))
def test_encode_plain_equals_jax_encode_device(name):
    data = STREAMS[name]
    want = _jax_outputs(data)
    got = _ours(tpurans.encode_device(torch.from_numpy(data)))
    for a, b in zip(got, want):
        assert np.array_equal(a, b.astype(a.dtype)), name
    assert got[1].shape == (tpurans.lanes_for(data.size),)


def test_batch_equals_jax_per_plane():
    """Each plane of a batch has its own table and lanes; the planes'
    words lie one after another."""
    rng = np.random.default_rng(32)
    planes = np.stack([np.zeros(4000, np.uint8), rng.integers(0, 256, 4000, dtype=np.uint8),
                       (rng.geometric(0.2, 4000) % 256).astype(np.uint8)])
    freq, counts, states, words = _ours(tpurans.encode_plain(torch.from_numpy(planes)))
    pos = 0
    for i, plane in enumerate(planes):
        f, c, s, w = _jax_outputs(plane)
        assert np.array_equal(freq[i], f) and np.array_equal(counts[i], c)
        assert np.array_equal(states[i], s)
        assert np.array_equal(words[pos : pos + w.size], w)
        pos += w.size
    assert pos == words.size


def _histograms(kind, rng, k=50):
    """[k, 256] counts of the given kind, each summing to the T * L of a
    random stream size, as the encoder counts them (padding included)."""
    out = []
    for _ in range(k):
        n = int(rng.integers(1, tpurans.MAX_SYMBOLS + 1))
        lanes = tpurans.lanes_for(n)
        total = -(-n // lanes) * lanes
        counts = np.zeros(256, np.int64)
        if kind == "ties":  # 2-5 symbols share the largest count
            sym = rng.choice(256, int(rng.integers(2, 6)), replace=False)
            counts[sym] = total // sym.size
            counts[np.setdiff1d(np.arange(256), sym)[0]] += total - int(counts.sum())
        else:
            p = {"dense": lambda: rng.random(256),
                 "sparse": lambda: np.where(rng.random(256) < 0.05, rng.random(256), 0.0),
                 "skewed": lambda: 0.5 ** np.arange(256) * rng.random(256)}[kind]()
            if p.sum() > 0:
                counts = np.floor(p / p.sum() * n).astype(np.int64)
            counts[int(rng.integers(0, 256))] += n - int(counts.sum())  # exactly n
            counts[0] += total - n  # the padding zeros, which are coded
        out.append(counts)
    return np.stack(out)


_jax_normalize = jax.jit(jt._normalize_device)


@pytest.mark.parametrize("kind", ["dense", "sparse", "skewed", "ties"])
def test_normalize_equals_jax(kind):
    hists = _histograms(kind, np.random.default_rng(["dense", "sparse", "skewed", "ties"].index(kind)))
    ours = tpurans._normalize(torch.from_numpy(hists)).numpy()
    for counts, freq in zip(hists, ours):
        want = np.asarray(_jax_normalize(jnp.asarray(counts, jnp.int32)))
        assert np.array_equal(freq, want)
        assert freq.sum() == 1 << 14 and np.all(freq[counts > 0] >= 1)


@pytest.mark.parametrize("name", ["empty"] + [k for k in STREAMS if "65536" not in k])
def test_encode_bytes_equal_jax(name):
    data = STREAMS.get(name, np.zeros(0, np.uint8)).tobytes()
    blob = tpurans.encode_bytes(data, "cpu")
    assert blob == jt.encode_bytes(data)
    assert tpurans.decode_bytes(blob, len(data)).tobytes() == data


def test_lanes_for_equals_jax():
    sizes = [1, 2, 511, 512, 65535, 65536, 65537, 1 << 20, 2_073_600, 6_190_352,
             tpurans.MAX_SYMBOLS, 10**9]
    sizes += [int(2 ** e) + d for e in np.linspace(0, 30, 61) for d in (-1, 0, 1) if 2 ** e + d >= 1]
    for n in sizes:
        assert tpurans.lanes_for(n) == jt.lanes_for(n), n


@pytest.fixture(params=["native", "numpy"])
def decoder(request, monkeypatch):
    """Each decoder of both packages: the native library, or the NumPy
    mirror with the library hidden."""
    if request.param == "numpy":
        monkeypatch.setattr(native, "available", lambda: False)
        monkeypatch.setattr(jnative, "available", lambda: False)
    else:
        assert native.available() and jnative.available()
    return request.param


@pytest.mark.parametrize("name", ["zeros", "all-256", "geometric-513", "uniform-65536"])
def test_decode_bytes_round_trips(decoder, name):
    data = STREAMS[name]
    blob = jt.encode_bytes(data.tobytes())
    assert np.array_equal(tpurans.decode_bytes(blob, data.size), data)
    assert np.array_equal(tpurans.decode_bytes(blob), data)
    assert tpurans.decode_bytes(jt.encode_bytes(b""), 0).size == 0


@functools.lru_cache(maxsize=None)
def _malformed():
    """Hostile payloads by name, built at first use (JAX encodes them)."""
    rng = np.random.default_rng(33)
    data = (rng.geometric(0.2, 20_000) % 256).astype(np.uint8).tobytes()
    enc = jt.encode_bytes(data)
    hostile_n = bytearray(enc)
    hostile_n[0:4] = (1 << 30).to_bytes(4, "little")
    lanes = bytearray(enc)
    lanes[4:8] = (77).to_bytes(4, "little")
    table = bytearray(enc)
    table[8:10] = (0xFFFF).to_bytes(2, "little")
    counts = bytearray(enc)
    counts[8 + 512 : 8 + 514] = (0xFFFF).to_bytes(2, "little")
    state = bytearray(enc)
    state[8 + 512 + 2 * 128] ^= 0x55
    empty_lanes = (0).to_bytes(4, "little") + (128).to_bytes(4, "little")
    return {
        "declared-size": (bytes(hostile_n), len(data)),
        "short-header": (enc[:6], len(data)),
        "short-counts": (enc[:600], len(data)),
        "short-body": (enc[:-10], len(data)),
        "lane-count": (bytes(lanes), len(data)),
        "table-sum": (bytes(table), len(data)),
        "counts-above-rows": (bytes(counts), len(data)),
        "state": (bytes(state), len(data)),
        "empty-with-lanes": (empty_lanes, 0),
    }


@pytest.mark.parametrize(
    "name",
    ["declared-size", "short-header", "short-counts", "short-body", "lane-count", "table-sum",
     "counts-above-rows", "state", "empty-with-lanes"],
)
def test_malformed_streams_rejected_like_jax(decoder, name):
    data, n = _malformed()[name]
    with pytest.raises(ValueError) as ours:
        tpurans.decode_bytes(data, expected_n=n)
    with pytest.raises(ValueError) as ref:
        jt.decode_bytes(data, expected_n=n)
    assert str(ours.value) == str(ref.value)


def test_corruption_fuzz_decodes_like_jax(decoder):
    rng = np.random.default_rng(34)
    data = (rng.geometric(0.2, 30_000) % 256).astype(np.uint8).tobytes()
    enc = jt.encode_bytes(data)
    for _ in range(40):
        b = bytearray(enc[: int(rng.integers(1, len(enc)))])
        if len(b) > 8:
            b[int(rng.integers(0, len(b)))] ^= 0xFF
        try:
            want = jt.decode_bytes(bytes(b), expected_n=len(data))
        except ValueError as e:
            with pytest.raises(ValueError, match=None) as ours:
                tpurans.decode_bytes(bytes(b), expected_n=len(data))
            assert str(ours.value) == str(e)
        else:
            assert np.array_equal(tpurans.decode_bytes(bytes(b), expected_n=len(data)), want)


def test_encode_refuses_like_jax(monkeypatch):
    with pytest.raises(ValueError, match="empty stream"):
        tpurans.encode_device(torch.zeros(0, dtype=torch.uint8))
    monkeypatch.setattr(tpurans, "MAX_SYMBOLS", 1000)
    monkeypatch.setattr(jt, "MAX_SYMBOLS", 1000)
    data = np.zeros(1001, np.uint8)
    with pytest.raises(ValueError) as ours:
        tpurans.encode_device(torch.from_numpy(data))
    with pytest.raises(ValueError) as ref:
        jt.encode_device(jnp.asarray(data))
    assert str(ours.value) == str(ref.value)
    with pytest.raises(ValueError, match="uint8"):
        tpurans.encode_batch(torch.zeros(1, 8, dtype=torch.int32))
    with pytest.raises(ValueError, match="CPU or CUDA"):
        tpurans.encode_batch(torch.zeros(1, 8, dtype=torch.uint8, device="meta"))


def test_finalize_stream_needs_every_word():
    freq, counts, states, stream = tpurans.encode_device(torch.from_numpy(STREAMS["uniform-513"]))
    total = int(counts.sum())
    with pytest.raises(ValueError, match="shorter than the word count"):
        tpurans.finalize_stream(513, freq.numpy(), counts.numpy(), states.numpy().view(np.uint32),
                                stream[: total - 1].numpy().view(np.uint16))
