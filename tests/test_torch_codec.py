"""The port's HGICodec against the JAX HGICodec, and its failure paths.

Exact equality throughout: archives byte for byte, planes bit for bit.
The kernels' own tests, which need a card, are in test_torch_cuda.py.
"""

import hashlib
import json
import os
import subprocess

import numpy as np
import pytest
import torch

import rustyhgi_tpu as jhgi

import rustyhgi_tpu_torch as hgi
from rustyhgi_tpu_torch.ops import _build, cuda_codec
from rustyhgi_tpu_torch.ops.quantizers import QuantizationLevel

from conftest import synthetic_image

BASELINE = os.path.join(os.path.dirname(__file__), "golden", "baseline")


def _image(shape, seed=0):
    return np.random.default_rng([seed, *shape]).integers(0, 256, shape, dtype=np.uint8)


@pytest.fixture(scope="module")
def manifest():
    with open(os.path.join(BASELINE, "manifest.json")) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def lena():
    """The LENA luma, recovered from its lossless golden on the CPU path."""
    with open(os.path.join(BASELINE, "lena_l4_lossless.hgi"), "rb") as f:
        archive = hgi.read_hgi(f.read())
    return hgi.HGICodec(4, "lossless", device="cpu").decode(archive)


def _sha(b: bytes) -> str:
    return hashlib.sha256(b).hexdigest()


def test_lena_recovered_exactly(lena, manifest):
    assert lena.shape == (256, 256)
    assert _sha(lena.tobytes()) == manifest["lena_l4_lossless"]["input_sha256"]


@pytest.mark.parametrize("preset", ["lossless", "medium"])
def test_lena_hgi_digest_on_cpu_path(lena, manifest, preset):
    entry = manifest[f"lena_l4_{preset}"]
    codec = hgi.HGICodec(4, preset, device="cpu")
    blob = hgi.write_archive(codec.encode(lena), "hgi")
    assert _sha(blob) == entry["hgi_sha256"]
    assert len(blob) == entry["hgi_bytes"]
    decoded = codec.decode(hgi.read_archive(blob))
    assert _sha(decoded.tobytes()) == entry["decoded_sha256"]
    assert int(np.abs(decoded.astype(np.int64) - lena).max()) == entry["max_abs_error"]


CONFIGS = [
    dict(levels=4, quantization="medium", predictor="crossed", quantizer="linear"),
    dict(levels=3, quantization="lossless", predictor="left_top", quantizer="linear"),
    dict(levels=4, quantization="high", predictor="crossed", quantizer="lut"),
    dict(levels=2, quantization="low", predictor="crossed", quantizer="noop"),
    dict(levels=16, quantization="low", predictor="left_top", quantizer="linear"),
    dict(levels=0, quantization="medium", predictor="crossed", quantizer="linear"),
]


@pytest.mark.parametrize("cfg", CONFIGS, ids=lambda c: "-".join(map(str, c.values())))
def test_from_reference_archives_byte_identical(cfg):
    ref = jhgi.HGICodec(**cfg)
    state = {k: getattr(ref, k) for k in ("levels", "quantization", "predictor", "quantizer")}
    ours = hgi.HGICodec.from_reference(state, jhgi.linear_table(ref.quantization), device="cpu")
    for img in (_image((37, 53)), synthetic_image(40, 24)):
        ref_archive = ref.encode(img)
        blob = jhgi.write_archive(ref_archive, "hgi")
        archive = ours.encode(img)
        assert hgi.write_archive(archive, "hgi") == blob
        assert np.array_equal(ours.decode(hgi.read_archive(blob)), ref.decode(ref_archive))


def test_from_reference_checks_the_table():
    cfg = dict(levels=4, quantization=jhgi.QuantizationLevel.MEDIUM, predictor="crossed",
               quantizer="linear")
    with pytest.raises(ValueError, match="medium preset"):
        hgi.HGICodec.from_reference(cfg, jhgi.linear_table(jhgi.QuantizationLevel.HIGH),
                                    device="cpu")
    codec = hgi.HGICodec.from_reference(cfg, None, device="cpu")
    assert codec.quantization == QuantizationLevel.MEDIUM and codec.levels == 4


@pytest.mark.parametrize("preset", ["lossless", "medium"])
def test_test_metrics_match_jax(preset):
    img = synthetic_image(40, 24)
    ref = jhgi.HGICodec(3, preset).test(img)
    ours = hgi.HGICodec(3, preset, device="cpu").test(img)
    for key in ("uncompressed", "compressed", "ratio", "sd", "psnr_db", "max_error",
                "error_bound"):
        assert ours[key] == ref[key], key
    assert str(ours) == str(ref)
    assert ours["archive_bytes"] == ref["archive_bytes"]
    assert np.array_equal(ours["decoded"], np.asarray(ref["decoded"]))


def test_left_top_archive_decodes_by_tag():
    img = _image((37, 53))
    archive = hgi.HGICodec(3, "medium", predictor="left_top", device="cpu").encode(img)
    assert archive.metadata.interpolation == hgi.Interpolation.PREVIOUS
    # A crossed codec of another depth still decodes it by its tag and depth.
    decoded = hgi.HGICodec(5, "low", device="cpu").decode(archive)
    ref = jhgi.HGICodec(3, "medium", predictor="left_top").decode(
        jhgi.read_archive(hgi.write_hgi(archive))
    )
    assert np.array_equal(decoded, np.asarray(ref))


@pytest.mark.parametrize("backend", ["auto", "torch"])
def test_batch_encode_plane_matches_per_plane(backend):
    imgs = np.stack([_image((37, 53), s) for s in range(3)])
    codec = hgi.HGICodec(4, "high", backend=backend, device="cpu")
    grid, recon = codec.encode_plane(imgs)
    assert grid.shape == recon.shape == (3, 37, 53)
    for i in range(3):
        g, r = codec.encode_plane(imgs[i])
        assert torch.equal(grid[i], g) and torch.equal(recon[i], r)
    assert torch.equal(codec.decode_plane(grid), recon)


def test_codec_argument_errors():
    with pytest.raises(ValueError, match="levels"):
        hgi.HGICodec(17, device="cpu")
    with pytest.raises(ValueError, match="backend"):
        hgi.HGICodec(4, backend="pallas", device="cpu")
    with pytest.raises(ValueError, match="unknown predictor"):
        hgi.HGICodec(4, predictor="line", device="cpu")
    with pytest.raises(ValueError, match="device"):
        hgi.HGICodec(4, device="meta")
    with pytest.raises(ValueError, match=r"\[H, W\]"):
        hgi.HGICodec(4, device="cpu").encode(_image((2, 3, 4)))


def test_cuda_backend_on_cpu_device_raises():
    with pytest.raises(ValueError, match="needs a CUDA device"):
        hgi.HGICodec(4, backend="cuda", device="cpu")


def test_cuda_device_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        hgi.HGICodec(4)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        hgi.HGICodec(4, device="cuda:0", backend="torch")


def test_wrapper_raises_off_cpu_and_cuda():
    meta = torch.empty(8, 8, dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        cuda_codec.encode_plane(meta, 2)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        cuda_codec.decode_plane(meta, 2)


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "find_nvcc", lambda: None)
    with pytest.raises(RuntimeError, match="no nvcc"):
        _build.build(build_dir=tmp_path)
    with pytest.raises(RuntimeError, match="cannot run"):
        _build.build(nvcc=str(tmp_path / "missing-nvcc"), build_dir=tmp_path)


def test_build_raises_with_the_compiler_output(monkeypatch, tmp_path):
    def failing_nvcc(cmd, **kwargs):
        return subprocess.CompletedProcess(cmd, 2, "", "hgi_codec.cu(1): error: boom\n")

    monkeypatch.setattr(_build.subprocess, "run", failing_nvcc)
    with pytest.raises(RuntimeError, match="boom") as err:
        _build.build(nvcc="nvcc", build_dir=tmp_path)
    assert "exit code 2" in str(err.value)
    assert not list(tmp_path.glob("*.so"))


def test_raise_on_names_the_entry_and_the_cuda_error(monkeypatch):
    class Lib:
        @staticmethod
        def hgi_error_string(rc):
            return {700: b"an illegal memory access was encountered"}[rc]

    monkeypatch.setattr(_build, "_lib", Lib())
    assert _build.raise_on(0, "hgi_encode") is None
    with pytest.raises(RuntimeError) as err:
        _build.raise_on(700, "rans_tpu_encode")
    assert str(err.value) == (
        "rans_tpu_encode failed: CUDA error 700 (an illegal memory access was encountered)")


def test_build_here_raises_when_no_nvcc_is_installed(monkeypatch):
    if _build.find_nvcc() is not None:
        pytest.skip("an nvcc is installed here; the build would succeed")
    monkeypatch.setattr(_build, "_lib", None)
    with pytest.raises(RuntimeError, match="no nvcc"):
        _build.load()
