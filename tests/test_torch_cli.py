"""The port's CLI against ``python -m rustyhgi_tpu``: same bytes, same printout."""

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
