"""The port's worked examples (``rustyhgi_tpu_torch/examples/serving.py``) on the CPU."""

import os
import subprocess
import sys

import rustyhgi_tpu_torch

ROOT = os.path.dirname(os.path.dirname(rustyhgi_tpu_torch.__file__))


def test_serving_example_runs_every_section_on_the_cpu():
    out = subprocess.run(
        [sys.executable, "-m", "rustyhgi_tpu_torch.examples.serving", "--device", "cpu"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr[-3000:]
    text = out.stdout
    assert [line.split(".")[0] for line in text.splitlines() if line.startswith("=== ")] == [
        f"=== {i}" for i in range(1, 8)]
    assert "max err 20 (bound 20)" in text
    assert "subband roundtrip max err: 20" in text
    assert "equal to encode: True" in text
    assert "== full[::4, ::4]: True" in text
    assert "grid matches: True" in text
    assert "lossless exact: True" in text
    assert "lossless exact = True" in text
    assert "False" not in text


def test_serving_example_defaults_to_the_card():
    code = ("import torch; torch.cuda.is_available = lambda: False\n"
            "from rustyhgi_tpu_torch.examples import serving\n"
            "serving.main([])\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode != 0
    assert "CUDA is not available" in out.stderr
