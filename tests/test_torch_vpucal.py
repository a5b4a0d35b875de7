"""The op-rate probe K8's plain version against the TPU probe kernel.

The JAX kernel is nested inside ``tools/chip_probe.py`` ``cmd_vpucal``
(``build_mosaic.run``), out of reach; these tests rebuild its
``pallas_call`` from ``chip_probe.py:611-672`` with ``interpret=True``,
from the same ``pallas_codec`` helpers, and its ``build_xla`` form as a
``lax.fori_loop``.  Every comparison is exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax
from jax.experimental import pallas as pl

from rustyhgi_tpu.ops import pallas_codec as pc

from rustyhgi_tpu_torch.ops import vpucal


def _mk_round(kind):
    """chip_probe.py:611-632, letter for letter."""
    if kind == "mix3":
        return lambda i, p: ((p + (i + 1)) >> 1) ^ p, jnp.int32
    if kind == "add":
        return lambda i, p: ((p + (i | 1)) + p) + i, jnp.int32
    if kind == "shift":
        return lambda i, p: ((p >> 1) ^ p) >> 1, jnp.int32
    if kind == "csel":
        return lambda i, p: jnp.where(p > (i | 1), p + 1, p), jnp.int32
    if kind == "f32add":
        return (
            lambda i, p: (p + jnp.float32(1.5)) * jnp.float32(0.5) + jnp.float32(0.25),
            jnp.float32,
        )
    raise KeyError(kind)


def _k8_pallas(image: np.ndarray, kind: str, k_trip: int) -> np.ndarray:
    """The probe's ``build_mosaic(kind, k_trip)`` in interpret mode; its
    u32 output words as bytes, cropped to the image."""
    n, h, w = image.shape
    rnd, dt = _mk_round(kind)
    hp_t, wp, wc, th, halo, n_tiles = pc._plan(h, w, 4, 1, None)
    xw = lax.bitcast_convert_type(jnp.asarray(image).reshape(n, h, wc, 4), pc._U32)

    def kernel(main_ref, halo_ref, out_ref):
        t = pl.program_id(1) if n_tiles > 1 else 0
        xx = jnp.concatenate([main_ref[0], halo_ref[0]], axis=0)
        pc._CACHE = {}
        try:
            D = pc._bytes16_from_u32(xx, h - t * th)
            planes = [D[ry][rx].astype(dt) for ry in range(4) for rx in range(4)]

            def body(i, ps):
                return [rnd(i, p) for p in ps]

            planes = lax.fori_loop(0, k_trip, body, planes)
            for ry in range(4):
                for rx in range(4):
                    D[ry][rx] = planes[4 * ry + rx].astype(pc._PT) & 255
            out_ref[0] = pc._pack_u32(D, th // 4)
        finally:
            pc._CACHE = None

    out = pl.pallas_call(
        kernel,
        grid=(n, n_tiles),
        in_specs=pc._pair_specs(th, halo, wc),
        out_specs=pc._out_spec(th, wc),
        out_shape=jax.ShapeDtypeStruct((n, hp_t, wc), pc._U32),
        interpret=True,
    )(xw, xw)
    words = lax.bitcast_convert_type(out[..., None], pc._U8).reshape(n, hp_t, wc * 4)
    return np.asarray(words)[:, :h, :w]


def _k8_xla(image: np.ndarray, kind: str, k: int) -> np.ndarray:
    """The probe's ``build_xla(kind)`` (chip_probe.py:676-700), k dynamic."""
    n, h, w = image.shape
    rnd, dt = _mk_round(kind)

    @jax.jit
    def run(image, k):
        xw = lax.bitcast_convert_type(image.reshape(n, h, w // 4, 4), pc._U32)
        planes = [((xw >> pc._U32(8 * rx)).astype(pc._PT) & 255).astype(dt) for rx in range(4)]

        def body(i, ps):
            return [rnd(i, p) for p in ps]

        outs = lax.fori_loop(0, k, body, planes)
        outs = [o.astype(pc._PT) & 255 for o in outs]
        w32 = (outs[0].astype(pc._U32)
               | (outs[1].astype(pc._U32) << pc._U32(8))
               | (outs[2].astype(pc._U32) << pc._U32(16))
               | (outs[3].astype(pc._U32) << pc._U32(24)))
        return lax.bitcast_convert_type(w32[..., None], pc._U8).reshape(n, h, w)

    return np.asarray(run(jnp.asarray(image), jnp.int32(k)))


def _image(shape, seed=0):
    return np.random.default_rng([seed, *shape]).integers(0, 256, shape, dtype=np.uint8)


@pytest.mark.parametrize("k", [0, 1, 5, 40])
@pytest.mark.parametrize("kind", vpucal.KINDS)
def test_plain_matches_the_pallas_probe_kernel(kind, k):
    img = _image((2, 40, 64))
    want = _k8_pallas(img, kind, k)
    got = vpucal.vpucal_plain(torch.from_numpy(img), kind, k).numpy()
    assert np.array_equal(got, want)


@pytest.mark.parametrize("kind", vpucal.KINDS)
def test_plain_matches_the_xla_probe_chain(kind):
    img = _image((3, 24, 40), seed=1)
    for k in (0, 3, 33, 64):
        want = _k8_xla(img, kind, k)
        assert np.array_equal(vpucal.vpucal_plain(torch.from_numpy(img), kind, k).numpy(), want)


def test_add_wraps_like_int32():
    # `add` doubles p every round: past about 30 rounds it wraps, as in JAX.
    img = np.full((1, 1, 4), 255, np.uint8)
    p = np.full(4, 255, np.int64)
    for i in range(40):
        p = (((p + (i | 1)) + p) + i + 2**31) % 2**32 - 2**31
    got = vpucal.vpucal_plain(torch.from_numpy(img), "add", 40).numpy()
    assert np.array_equal(got[0, 0], (p & 255).astype(np.uint8))


@pytest.mark.parametrize("shape", [(1, 7, 1), (2, 5, 6), (1, 3, 13)])
def test_cpu_wrapper_takes_the_plain_version_and_launches_nothing(shape):
    img = torch.from_numpy(_image(shape, seed=2))
    before = vpucal.vpucal_launches
    for kind in vpucal.KINDS:
        assert torch.equal(vpucal.vpucal_chain(img, kind, 7), vpucal.vpucal_plain(img, kind, 7))
    assert vpucal.vpucal_launches == before


@pytest.mark.parametrize(
    "args,match",
    [
        ((torch.zeros(1, 4, 4, dtype=torch.uint8), "mul", 3), "kind"),
        ((torch.zeros(1, 4, 4, dtype=torch.uint8), "add", -1), "k must be"),
        ((torch.zeros(4, 4, dtype=torch.uint8), "add", 3), r"\[B, H, W\]"),
        ((torch.zeros(1, 4, 4, dtype=torch.int32), "add", 3), "uint8"),
    ],
    ids=["kind", "negative-k", "rank", "dtype"],
)
def test_wrapper_rejects_bad_arguments(args, match):
    with pytest.raises(ValueError, match=match):
        vpucal.vpucal_chain(*args)
