"""The PyTorch port imports without JAX and without the JAX package."""

import ast
import os
import subprocess
import sys

import pytest

import rustyhgi_tpu_torch

PKG = os.path.dirname(rustyhgi_tpu_torch.__file__)
ROOT = os.path.dirname(PKG)
FORBIDDEN = {"jax", "jaxlib", "rustyhgi_tpu"}

MODULES = [
    "rustyhgi_tpu_torch",
    "rustyhgi_tpu_torch.__main__",
    "rustyhgi_tpu_torch.bench",
    "rustyhgi_tpu_torch.cli",
    "rustyhgi_tpu_torch.dryrun",
    "rustyhgi_tpu_torch.dyadic",
    "rustyhgi_tpu_torch.examples.serving",
    "rustyhgi_tpu_torch.models.codec",
    "rustyhgi_tpu_torch.ops._build",
    "rustyhgi_tpu_torch.ops.bitpack",
    "rustyhgi_tpu_torch.ops.ctxcoder",
    "rustyhgi_tpu_torch.ops.cuda_codec",
    "rustyhgi_tpu_torch.ops.entropy",
    "rustyhgi_tpu_torch.ops.library",
    "rustyhgi_tpu_torch.ops.native",
    "rustyhgi_tpu_torch.ops.predictors",
    "rustyhgi_tpu_torch.ops.pyramid",
    "rustyhgi_tpu_torch.ops.quantizers",
    "rustyhgi_tpu_torch.ops.tpurans",
    "rustyhgi_tpu_torch.ops.vpucal",
    "rustyhgi_tpu_torch.oracle",
    "rustyhgi_tpu_torch.parallel",
    "rustyhgi_tpu_torch.parallel.mesh",
    "rustyhgi_tpu_torch.parallel.multihost",
    "rustyhgi_tpu_torch.parallel.sharded",
    "rustyhgi_tpu_torch.tools",
    "rustyhgi_tpu_torch.tools.chip_probe",
    "rustyhgi_tpu_torch.tools.multihost_run",
    "rustyhgi_tpu_torch.utils.benchsuite",
    "rustyhgi_tpu_torch.utils.color",
    "rustyhgi_tpu_torch.utils.container",
    "rustyhgi_tpu_torch.utils.imageio",
    "rustyhgi_tpu_torch.utils.profiling",
]


def _sources():
    for dirpath, _, files in os.walk(PKG):
        for name in files:
            if name.endswith(".py"):
                yield os.path.join(dirpath, name)


def test_imports_with_jax_blocked():
    code = (
        "import importlib, sys\n"
        "for name in ('jax', 'jaxlib', 'rustyhgi_tpu'):\n"
        "    sys.modules[name] = None\n"
        f"for mod in {MODULES!r}:\n"
        "    importlib.import_module(mod)\n"
        "import chip_smoke\n"
        "print('ok')\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
        timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


@pytest.mark.parametrize(
    "module",
    ["rustyhgi_tpu_torch.utils.color", "rustyhgi_tpu_torch.parallel",
     "rustyhgi_tpu_torch.parallel.multihost", "rustyhgi_tpu_torch.dryrun",
     "rustyhgi_tpu_torch.ops.library", "rustyhgi_tpu_torch.models.codec",
     "rustyhgi_tpu_torch.oracle"],
)
def test_color_and_parallel_load_neither_jax_nor_the_jax_package(module):
    code = (
        "import importlib, sys\n"
        f"importlib.import_module({module!r})\n"
        "print(sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'rustyhgi_tpu')))\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
        timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_oracle_source_imports_neither_torch_nor_jax():
    # The trusted model is pure NumPy: its own code imports numpy and the
    # port's quantizer tables, nothing else (the package's __init__ loads
    # torch for the rest of the port).
    path = os.path.join(PKG, "oracle.py")
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    imported = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            imported.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            imported.add("." * node.level + (node.module or ""))
    assert imported == {"__future__", "numpy", ".ops.quantizers"}
    assert "torch" not in open(path).read().replace("rustyhgi_tpu_torch", "")


def test_multihost_names_are_ported_and_cover_jax_all():
    # The multi-process tier is ported: no name of the package refuses any
    # more, and its __all__ covers the JAX package's.
    import rustyhgi_tpu.parallel as jpar
    import rustyhgi_tpu_torch.parallel as par
    from rustyhgi_tpu_torch.parallel import multihost

    assert set(jpar.__all__) <= set(par.__all__)
    for name in par.__all__:
        assert hasattr(par, name), name
    for name in ("MultiHostConfig", "TiledEncodeResult", "encode_tiled_multihost",
                 "decode_tiled_multihost", "write_thgit_multihost", "TileCodingError",
                 "initialize"):
        assert getattr(par, name) is getattr(multihost, name)
    assert par.MultiHostConfig().num_processes is None


@pytest.mark.parametrize(
    "path", sorted(_sources()), ids=lambda p: os.path.relpath(p, ROOT)
)
def test_source_never_imports_jax_or_the_jax_package(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        elif isinstance(node, ast.Name):
            names = [node.id]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, (path, node.lineno, name)


def test_public_api():
    for name in rustyhgi_tpu_torch.__all__:
        assert hasattr(rustyhgi_tpu_torch, name), name
    assert {"HGICodec", "read_archive", "write_archive", "QuantizationLevel"} <= set(
        rustyhgi_tpu_torch.__all__
    )
