"""The port's CLI against ``python -m rustyhgi_tpu``: same bytes, same printout."""

import os

import numpy as np
import pytest
import torch

from rustyhgi_tpu.cli import main as jax_main

from rustyhgi_tpu_torch.cli import main
from rustyhgi_tpu_torch.utils.imageio import load_luma, save_gray

from conftest import synthetic_image

CPU = ["--device", "cpu"]


@pytest.fixture
def workdir(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    return tmp_path


@pytest.fixture
def png(workdir):
    rng = np.random.default_rng(11)
    img = synthetic_image(61, 37) // 2 + rng.integers(0, 16, (37, 61), dtype=np.uint8)
    save_gray("img.png", img)
    return "img.png"


@pytest.mark.parametrize(
    "flags",
    [[], ["-q", "lossless"], ["-q", "HIGH", "-l", "2"], ["--predictor", "left_top", "-l", "3"],
     ["-l", "16", "-q", "low"]],
    ids=["defaults", "lossless", "high-l2", "left_top", "l16"],
)
def test_encode_bytes_and_decode_pixels_match_jax_cli(png, flags):
    assert jax_main(["encode", "-i", png, "-o", "ref.hgi", *flags]) == 0
    assert main(["encode", "-i", png, "-o", "ours.hgi", *flags, *CPU]) == 0
    with open("ref.hgi", "rb") as a, open("ours.hgi", "rb") as b:
        assert a.read() == b.read()
    assert jax_main(["decode", "-i", "ref.hgi", "-o", "ref.png"]) == 0
    assert main(["decode", "-i", "ref.hgi", "-o", "ours.png", *CPU]) == 0
    assert np.array_equal(load_luma("ours.png"), load_luma("ref.png"))


# `test` writes <stem><suffix>.png beside the input, so a suffix keeps the
# input from being overwritten between the two runs.
@pytest.mark.parametrize("flags", [["-q", "lossless"], ["-q", "medium", "-l", "3"],
                                   ["--predictor", "left_top", "-q", "high"]])
@pytest.mark.parametrize("engine", ["auto", "torch"])
def test_test_printout_matches_jax_cli(png, capsys, flags, engine):
    flags = [*flags, "-s", "_t"]
    assert jax_main(["test", png, *flags]) == 0
    ref = capsys.readouterr().out
    stem = "img_t"
    with open(stem + ".hgi", "rb") as f:
        ref_blob = f.read()
    ref_png = load_luma(stem + ".png")
    assert main(["test", png, *flags, "--engine", engine, *CPU]) == 0
    assert capsys.readouterr().out == ref
    assert "SD:" in ref
    with open(stem + ".hgi", "rb") as f:
        assert f.read() == ref_blob
    assert np.array_equal(load_luma(stem + ".png"), ref_png)


@pytest.mark.parametrize(
    "argv,out",
    [
        (["encode", "-i", "img.png", "-o", "x.thgi", "--format", "thgi", "--fast"], "x.thgi"),
        # As in the JAX CLI, `test` ignores --fast and writes write_archive's bytes.
        (["test", "img.png", "--format", "thgi", "--fast", "-s", "_t"], "img_t.thgi"),
    ],
    ids=["fast", "test-fast"],
)
def test_fast_flag_matches_jax_cli(png, capsys, argv, out):
    assert jax_main(argv) == 0
    ref = capsys.readouterr().out
    with open(out, "rb") as f:
        want = f.read()
    assert main([*argv, *CPU]) == 0
    assert capsys.readouterr().out == ref
    with open(out, "rb") as f:
        assert f.read() == want
    assert (want[29] == 7) == (argv[0] == "encode")  # codec 7: the device rANS


@pytest.mark.parametrize("flags", [[], ["--batch", "2", "--samples", "2"]],
                         ids=["defaults", "batch-samples"])
def test_bench_on_the_cpu_prints_the_eight_criterion_rows(capsys, monkeypatch, flags):
    from rustyhgi_tpu.utils.benchsuite import format_suite as jax_format

    from rustyhgi_tpu_torch.utils import benchsuite

    # The defaults time 8 planes 25 times each: keep the planes small.
    monkeypatch.setattr(benchsuite, "W", 40 if flags else 16)
    monkeypatch.setattr(benchsuite, "H", 24 if flags else 8)
    shown = {}
    real = benchsuite.run_suite_stats

    def keep(**kw):
        shown["args"] = kw
        shown["results"] = real(**kw)
        return shown["results"]

    monkeypatch.setattr(benchsuite, "run_suite_stats", keep)
    assert main(["bench", *flags, *CPU]) == 0
    out = capsys.readouterr().out
    assert [line.split()[0] for line in out.splitlines()] == list(benchsuite.SUITE)
    assert out == jax_format(shown["results"]) + "\n"
    want = {"device": "cpu", "batch": 8, "samples": 25} if not flags else \
        {"device": "cpu", "batch": 2, "samples": 2}
    assert shown["args"] == want


def test_bench_without_a_card_exits_1(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert main(["bench", "--batch", "1", "--samples", "1"]) == 1
    assert "CUDA is not available" in capsys.readouterr().err


def test_error_paths(png, capsys):
    with open("junk.bin", "wb") as f:
        f.write(b"not an archive at all")
    assert main(["decode", "-i", "junk.bin", "-o", "x.png", *CPU]) == 1
    assert "An error occured: incorrect magic number" in capsys.readouterr().err
    assert main(["encode", "-i", png, "-o", "x.hgi", "-q", "nope", *CPU]) == 1
    assert "unknown quantization level" in capsys.readouterr().err
    assert main(["encode", "-i", png, "-o", "x.hgi", "--engine", "cuda", *CPU]) == 1
    assert "needs a CUDA device" in capsys.readouterr().err
    with pytest.raises(SystemExit) as exc:
        main(["encode", "-i", png, "-o", "x.hgi", "--bogus", *CPU])
    assert exc.value.code == 2


def test_default_device_is_cuda(png, capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert main(["encode", "-i", png, "-o", "x.hgi"]) == 1
    assert "CUDA is not available" in capsys.readouterr().err


# --backend: the counterpart of the JAX CLI's test_backend_parity.
BACKENDS = [("torch", "jax"), ("oracle", "oracle"), ("native", "native")]


def _ours(backend):
    """The port's flags for a backend: the device only for torch, so that
    the host backends run at the default --device."""
    return ["--backend", backend, *(CPU if backend == "torch" else [])]


@pytest.mark.parametrize("backend,jax_backend", BACKENDS, ids=[b for b, _ in BACKENDS])
@pytest.mark.parametrize("fmt", ["hgi", "thgi"])
@pytest.mark.parametrize("preset", ["lossless", "low", "medium"])
@pytest.mark.parametrize("pred", ["crossed", "left_top"])
def test_backends_write_and_read_the_jax_clis_bytes(png, backend, jax_backend, fmt, preset,
                                                      pred):
    flags = ["-q", preset, "--format", fmt, "--predictor", pred]
    assert jax_main(["encode", "-i", png, "-o", "ref.bin", *flags,
                     "--backend", jax_backend]) == 0
    assert main(["encode", "-i", png, "-o", "ours.bin", *flags, *_ours(backend)]) == 0
    with open("ref.bin", "rb") as a, open("ours.bin", "rb") as b:
        assert a.read() == b.read()
    assert jax_main(["decode", "-i", "ref.bin", "-o", "ref.png", "--backend", jax_backend]) == 0
    assert main(["decode", "-i", "ref.bin", "-o", "ours.png", *_ours(backend)]) == 0
    assert np.array_equal(load_luma("ours.png"), load_luma("ref.png"))


@pytest.mark.parametrize("backend,jax_backend", BACKENDS, ids=[b for b, _ in BACKENDS])
@pytest.mark.parametrize("flags", [["-q", "lossless"], ["-q", "medium", "-l", "3"],
                                   ["--predictor", "left_top", "-q", "high", "--format", "thgi"],
                                   ["-q", "low", "-l", "16"]],
                         ids=["lossless", "medium-l3", "left_top-thgi", "l16"])
def test_backends_test_printout_matches_jax_cli(png, capsys, backend, jax_backend, flags):
    flags = [*flags, "-s", "_t"]
    ext = "thgi" if "thgi" in flags else "hgi"
    assert jax_main(["test", png, *flags, "--backend", jax_backend]) == 0
    ref = capsys.readouterr().out
    with open(f"img_t.{ext}", "rb") as f:
        ref_blob = f.read()
    ref_png = load_luma("img_t.png")
    assert main(["test", png, *flags, *_ours(backend)]) == 0
    assert capsys.readouterr().out == ref
    with open(f"img_t.{ext}", "rb") as f:
        assert f.read() == ref_blob
    assert np.array_equal(load_luma("img_t.png"), ref_png)


@pytest.mark.parametrize("backend", ["oracle", "native"])
@pytest.mark.parametrize("pred", ["crossed", "left_top"])
def test_fast_under_a_host_backend_matches_jax_cli(png, backend, pred):
    # The JAX CLI's _serialize: the host grid coded as the fast .thgi.
    argv = ["encode", "-i", png, "-o", "f.thgi", "--format", "thgi", "--fast",
            "--predictor", pred, "--backend", backend]
    assert jax_main(argv) == 0
    with open("f.thgi", "rb") as f:
        want = f.read()
    assert main(argv) == 0
    with open("f.thgi", "rb") as f:
        got = f.read()
    assert got == want and got[29] == 7  # codec 7: the device rANS


@pytest.mark.parametrize("backend", ["oracle", "native"])
@pytest.mark.parametrize("preset", ["lossless", "medium"])
def test_color_under_a_host_backend_goes_through_the_codec(workdir, backend, preset):
    from rustyhgi_tpu_torch.utils.color import load_rgb, save_rgb

    rng = np.random.default_rng(5)
    save_rgb("rgb.png", rng.integers(0, 256, (21, 34, 3), dtype=np.uint8))
    argv = ["encode", "-i", "rgb.png", "-o", "c.thgic", "--color", "-q", preset,
            "--format", "thgi"]
    assert jax_main([*argv, "--backend", backend]) == 0
    with open("c.thgic", "rb") as f:
        want = f.read()
    assert main([*argv, "--backend", backend, *CPU]) == 0
    with open("c.thgic", "rb") as f:
        assert f.read() == want
    assert jax_main(["decode", "-i", "c.thgic", "-o", "ref.png", "--backend", backend]) == 0
    assert main(["decode", "-i", "c.thgic", "-o", "ours.png", "--backend", backend, *CPU]) == 0
    assert np.array_equal(load_rgb("ours.png"), load_rgb("ref.png"))


@pytest.mark.parametrize("backend", ["oracle", "native"])
def test_decode_preview_under_a_host_backend_goes_through_the_codec(png, backend):
    assert main(["encode", "-i", png, "-o", "x.thgi", "--format", "thgi", *CPU]) == 0
    assert jax_main(["decode", "-i", "x.thgi", "-o", "ref.png", "--preview", "2",
                     "--backend", backend]) == 0
    assert main(["decode", "-i", "x.thgi", "-o", "ours.png", "--preview", "2",
                 "--backend", backend, *CPU]) == 0
    assert np.array_equal(load_luma("ours.png"), load_luma("ref.png"))


@pytest.mark.parametrize("backend", ["oracle", "native"])
@pytest.mark.parametrize("pred", ["crossed", "left_top"])
def test_host_backends_need_no_card_at_the_default_device(png, capsys, monkeypatch, backend,
                                                          pred):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    flags = ["-q", "medium", "--predictor", pred, "--backend", backend]
    assert main(["encode", "-i", png, "-o", "x.hgi", *flags]) == 0
    assert main(["decode", "-i", "x.hgi", "-o", "x.png", "--backend", backend]) == 0
    assert main(["test", png, *flags, "-s", "_t"]) == 0
    assert "SD:" in capsys.readouterr().out
    # The default backend is the codec, which still needs the card.
    assert main(["test", png, "-s", "_t"]) == 1
    assert "CUDA is not available" in capsys.readouterr().err
    assert main(["decode", "-i", "x.hgi", "-o", "x.png"]) == 1
    assert "CUDA is not available" in capsys.readouterr().err


def test_native_without_its_library_raises_and_never_takes_the_oracle(png, capsys,
                                                                     monkeypatch):
    from rustyhgi_tpu_torch.ops import native

    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_load_failed", True)
    assert main(["encode", "-i", png, "-o", "x.hgi", "--backend", "native"]) == 1
    assert "native library unavailable" in capsys.readouterr().err
    assert not os.path.exists("x.hgi")
    assert main(["encode", "-i", png, "-o", "x.hgi", "--backend", "oracle"]) == 0
    assert main(["decode", "-i", "x.hgi", "-o", "x.png", "--backend", "native"]) == 1
    assert "native library unavailable" in capsys.readouterr().err
    # left_top never reaches the stand-in, in JAX as here: the oracle codes it.
    assert main(["encode", "-i", png, "-o", "lt.hgi", "--predictor", "left_top",
                 "--backend", "native"]) == 0

