"""The port's bit-plane pack (K6's and K7's plain versions, the host
framing) against ``rustyhgi_tpu.ops.pallas_kernels``, whose Pallas kernels
run here in interpret mode.

Inputs come from numpy seeds; the tolerance is exact equality: the
planes, the widths, the framed bytes, the unpacked bytes and the errors.
"""

import numpy as np
import pytest
import torch

from rustyhgi_tpu.ops import pallas_kernels as pk

from rustyhgi_tpu_torch.ops import bitpack


def _residual_like(rng, n):
    # Mostly small folded magnitudes with a uniform tail, as residuals are.
    small = rng.integers(-8, 9, n) % 256
    big = rng.integers(0, 256, n)
    return np.where(rng.random(n) < 0.95, small, big).astype(np.uint8)


def _stream(kind, n):
    rng = np.random.default_rng([41, n])
    if kind == "residual":
        return _residual_like(rng, n)
    if kind == "uniform":
        return rng.integers(0, 256, n, dtype=np.uint8)
    if kind == "all8":
        # Every block keeps all 8 planes: 128 folds to 255.
        data = _residual_like(rng, n)
        data[::bitpack.BLOCK] = 128
        return data
    return np.zeros(n, np.uint8)


SIZES = [1, 127, 1023, 1024, 1025, 5000, 65536]
KINDS = ["residual", "uniform", "zeros", "all8"]
# Streams of nb = 6, 9 and 10 blocks: with nb % 4 of 1 or 2 the planes
# start at an odd offset of the body (8 + ceil(nb / 2)), as they do at
# nb = 1, 2 and 5 above.
MISALIGNED = [6000, 9216, 10240]


def test_zigzag_equals_jax():
    v = torch.arange(256)
    z = bitpack.zigzag(v)
    assert np.array_equal(z.numpy(), np.asarray(pk.zigzag(np.arange(256, dtype=np.int32))))
    assert sorted(z.tolist()) == list(range(256))
    assert torch.equal(bitpack.unzigzag(z), v)
    assert np.array_equal(bitpack.unzigzag(torch.arange(256)).numpy(),
                          np.asarray(pk.unzigzag(np.arange(256, dtype=np.int32))))


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("n", SIZES)
def test_pack_plain_equals_jax_pack_blocks(kind, n):
    data = _stream(kind, n)
    packed, widths, nb = bitpack.pack_plain(torch.from_numpy(data))
    want_p, want_w, want_nb = pk.pack_blocks(data)
    assert nb == want_nb == -(-n // bitpack.BLOCK)
    assert packed.shape == (nb, 8, 128)
    assert np.array_equal(packed.numpy(), np.asarray(want_p)[:nb])
    assert np.array_equal(widths.numpy(), np.asarray(want_w)[:nb])


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("n", [0] + SIZES + MISALIGNED)
def test_pack_bytes_equal_jax(kind, n):
    data = _stream(kind, n)
    blob = bitpack.pack_bytes(data, "cpu")
    assert blob == pk.pack_bytes(data)
    assert np.array_equal(bitpack.unpack_bytes(blob, n, "cpu"), data)
    assert np.array_equal(bitpack.unpack_bytes(blob, device="cpu"), np.asarray(pk.unpack_bytes(blob)))
    if kind == "all8" and n:
        assert set(np.asarray(pk.pack_blocks(data)[1])[: -(-n // bitpack.BLOCK)]) == {8}


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("n", [0] + SIZES + MISALIGNED)
def test_stream_plain_versions_equal_jax_and_the_host_framing(kind, n):
    """The compacting K6's and K7's plain versions against JAX's
    pack_bytes and unpack_bytes, and against the host framing of the
    8-plane contract (finalize_packed, expand_packed)."""
    data = _stream(kind, n)
    flat = torch.from_numpy(data)
    body = bitpack.pack_stream_plain(flat)
    assert body.dtype == torch.uint8 and body.dim() == 1
    blob = body.numpy().tobytes()
    assert blob == pk.pack_bytes(data)
    assert blob == bitpack.finalize_packed(*(t.numpy() if torch.is_tensor(t) else t
                                             for t in bitpack.pack_plain(flat)), n)
    assert torch.equal(bitpack.pack_stream(flat), body)
    out = bitpack.unpack_stream_plain(body, n)
    assert out.shape == (n,) and np.array_equal(out.numpy(), np.asarray(pk.unpack_bytes(blob)))
    expanded = torch.from_numpy(bitpack.expand_packed(blob, n)[0])
    assert torch.equal(out, bitpack.unpack_plain(expanded)[:n])
    assert torch.equal(bitpack.unpack_stream(body, n), out)
    assert bitpack.check_body(blob, n) == n


@pytest.mark.parametrize("n", [1025, 65536])
def test_unpack_plain_equals_jax_unpack_blocks(n):
    rng = np.random.default_rng([42, n])
    nb = -(-n // bitpack.BLOCK)
    planes = rng.integers(0, 256, (nb, 8, 128), dtype=np.uint8)
    ours = bitpack.unpack_plain(torch.from_numpy(planes)).numpy()
    # The Pallas kernel runs whole chunks of 128 blocks; pad and cut.
    padded = np.zeros((-(-nb // 128) * 128, 8, 128), np.uint8)
    padded[:nb] = planes
    assert np.array_equal(ours, np.asarray(pk.unpack_blocks(padded))[: nb * bitpack.BLOCK])


def test_expand_packed_keeps_only_real_blocks():
    data = _stream("residual", 5000)
    blob = bitpack.pack_bytes(data, "cpu")
    expanded, n = bitpack.expand_packed(blob, 5000)
    want, want_n = pk.expand_packed(blob, 5000)
    assert n == want_n == 5000 and expanded.shape == (5, 8, 128)
    assert np.array_equal(expanded, want[:5]) and not want[5:].any()


def _hostile():
    blob = pk.pack_bytes(_stream("residual", 5000))
    wide = bytearray(blob)
    wide[8] = 0xF9  # a width nibble of 9 (and 15) planes
    return {
        "short-header": (blob[:6], 5000),
        "declared-size": (blob, 4999),
        "block-count": (blob[:4] + (7).to_bytes(4, "little") + blob[8:], 5000),
        "short-body": (blob[:-1], 5000),
        "short-nibbles": (blob[:9], 5000),
        "wide": (bytes(wide), 5000),
    }


@pytest.mark.parametrize(
    "name", ["short-header", "declared-size", "block-count", "short-body", "short-nibbles", "wide"]
)
def test_expand_packed_guards_equal_jax(name):
    data, n = _hostile()[name]
    with pytest.raises(ValueError) as ours:
        bitpack.unpack_bytes(data, n, "cpu")
    with pytest.raises(ValueError) as ref:
        pk.unpack_bytes(data, n)
    assert str(ours.value) == str(ref.value)
    # The card's read makes the same checks on the host, before any copy.
    with pytest.raises(ValueError) as checked:
        bitpack.check_body(data, n)
    assert str(checked.value) == str(ref.value)


def test_wrappers_refuse_what_they_do_not_take():
    with pytest.raises(ValueError, match="uint8"):
        bitpack.pack_blocks(torch.zeros(8, dtype=torch.int32))
    with pytest.raises(ValueError, match="rank 3"):
        bitpack.unpack_blocks(torch.zeros(8, dtype=torch.uint8))
    meta = torch.zeros(2048, dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        bitpack.pack_blocks(meta)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        bitpack.unpack_blocks(meta.reshape(2, 8, 128))
    with pytest.raises(ValueError, match="CPU or CUDA"):
        bitpack.pack_stream(meta)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        bitpack.unpack_stream(meta, 100)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        bitpack.pack_compact(meta)
    with pytest.raises(ValueError, match="rank 1"):
        bitpack.unpack_stream(torch.zeros(2, 8, dtype=torch.uint8), 100)


def test_blocks_a_warp_are_the_kernels_choices():
    for nb in (1, 2025, 8191, 8192, 16200, 1 << 22):
        for k6 in (False, True):
            assert bitpack.per_warp(nb, k6) in bitpack.PER_WARP
    assert bitpack.per_warp(2025, True) == 2 and bitpack.per_warp(16200) == 4
    flat = torch.zeros(2048, dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        bitpack.pack_compact(flat, 2)
    assert bitpack._per(None, 2025) == 1
    with pytest.raises(ValueError, match="per must be one of"):
        bitpack._per(3, 2025)


def test_pack_bytes_defaults_to_the_card():
    """No silent CPU fallback: without CUDA the default device raises."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present, so the default device works")
    with pytest.raises((AssertionError, RuntimeError)):
        bitpack.pack_bytes(_stream("residual", 100))
    blob = bitpack.pack_bytes(_stream("residual", 100), "cpu")
    with pytest.raises((AssertionError, RuntimeError)):
        bitpack.unpack_bytes(blob)
