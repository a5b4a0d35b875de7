"""The port's compile and export surface against ``rustyhgi_tpu.models.codec`` on the CPU.

``export_encoder``/``export_decoder`` ship ``torch.export`` programs of
the ``rustyhgi::`` operators (K1, K2); loaded with ``load_exported`` they
must give JAX's exported programs' outputs bit for bit, on the same
seeded numpy input.
"""

import io

import numpy as np
import pytest
import torch

from rustyhgi_tpu.models.codec import HGICodec as JaxCodec
from rustyhgi_tpu.models.codec import load_exported as jax_load_exported

from rustyhgi_tpu_torch import HGICodec
from rustyhgi_tpu_torch.models import codec as codec_module
from rustyhgi_tpu_torch.models.codec import load_exported
from rustyhgi_tpu_torch.ops import library, pyramid
from rustyhgi_tpu_torch.ops.quantizers import QuantizationLevel, quantize_fn


def _image(shape, seed=0):
    return np.random.default_rng([seed, *shape]).integers(0, 256, shape, dtype=np.uint8)


def _table(preset):
    q = quantize_fn(QuantizationLevel.parse(preset))
    return None if q.identity else q.table


def test_compile_warms_up_and_returns_the_codec():
    codec = HGICodec(3, "medium", device="cpu")
    assert codec.compile((16, 16), (24, 40)) is codec
    img = torch.from_numpy(_image((24, 40)))
    grid, recon = codec.encode_plane(img)
    want_grid, want_recon = pyramid.encode_plane(img, 3, _table("medium"), "crossed")
    assert torch.equal(grid, want_grid) and torch.equal(recon, want_recon)
    assert HGICodec(2, "lossless", device="cpu").compile() is not None


@pytest.mark.parametrize("shape", [(32, 48), (37, 61)], ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("preset", ["lossless", "medium"])
@pytest.mark.parametrize("pred", ["crossed", "left_top"])
def test_exported_programs_match_jax(shape, preset, pred):
    codec = HGICodec(3, preset, predictor=pred, device="cpu")
    jcodec = JaxCodec(3, preset, predictor=pred)
    enc_blob, dec_blob = codec.export_encoder(shape), codec.export_decoder(shape)
    assert isinstance(enc_blob, bytes) and len(enc_blob) > 100 and len(dec_blob) > 100
    img = _image(shape)
    grid, recon = load_exported(enc_blob)(torch.from_numpy(img))
    jgrid, jrecon = jax_load_exported(jcodec.export_encoder(shape))(img)
    assert np.array_equal(grid.numpy(), np.asarray(jgrid))
    assert np.array_equal(recon.numpy(), np.asarray(jrecon))
    dec = load_exported(dec_blob)(grid)
    jdec = jax_load_exported(jcodec.export_decoder(shape))(np.asarray(jgrid))
    assert np.array_equal(dec.numpy(), np.asarray(jdec))
    assert np.array_equal(dec.numpy(), recon.numpy())


@pytest.mark.parametrize("which", ["encoder", "decoder"])
def test_exported_graph_calls_the_rustyhgi_ops(which):
    codec = HGICodec(3, "medium", device="cpu")
    blob = getattr(codec, f"export_{which}")((16, 24))
    program = torch.export.load(io.BytesIO(blob))
    calls = [n.target for n in program.graph.nodes if n.op == "call_function"]
    ops = [str(t) for t in calls if str(t).startswith("rustyhgi.")]
    assert ops == [f"rustyhgi.{'encode' if which == 'encoder' else 'decode'}_plane.default"]
    # Nothing of the plain version's arithmetic was traced beside the op.
    assert all(str(t) in ops or t.__name__ == "getitem" for t in calls)
    assert program.example_inputs is None


def test_exported_program_keeps_its_shape():
    enc = load_exported(HGICodec(3, "medium", device="cpu").export_encoder((16, 24)))
    with pytest.raises(Exception):
        enc(torch.zeros((16, 25), dtype=torch.uint8))


@pytest.mark.parametrize("preset", ["lossless", "low", "medium", "high"])
@pytest.mark.parametrize("shape", [(21, 35), (2, 17, 9)], ids=lambda s: "x".join(map(str, s)))
def test_ops_equal_the_plain_version(preset, shape):
    img = torch.from_numpy(_image(shape))
    table = _table(preset)
    lossless = table is None
    table_u8 = torch.zeros(256, dtype=torch.uint8) if lossless else table.to(torch.uint8)
    grid, recon = torch.ops.rustyhgi.encode_plane(img, table_u8, 3, "left_top", lossless)
    want_grid, want_recon = pyramid.encode_plane(img, 3, table, "left_top")
    assert torch.equal(grid, want_grid) and torch.equal(recon, want_recon)
    # An operator may not return its input: the lossless recon is a copy.
    assert recon.data_ptr() != img.data_ptr()
    assert torch.equal(torch.ops.rustyhgi.decode_plane(grid, 3, "left_top"),
                       pyramid.decode_plane(grid, 3, "left_top"))


@pytest.mark.parametrize("lossless", [True, False])
def test_ops_pass_opcheck(lossless):
    img = torch.from_numpy(_image((19, 26)))
    table = _table("medium").to(torch.uint8)
    torch.library.opcheck(library.encode_plane, (img, table, 2, "crossed", lossless))
    grid = library.encode_plane(img, table, 2, "crossed", lossless)[0]
    torch.library.opcheck(library.decode_plane, (grid, 2, "crossed"))


def test_load_exported_is_public():
    assert "load_exported" in codec_module.__all__
    for name in ("compile", "export_encoder", "export_decoder"):
        assert callable(getattr(HGICodec, name))
