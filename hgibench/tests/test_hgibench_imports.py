"""No module of the benchmark imports JAX or the JAX package, compared by
whole top-level names, and the reference imports nothing of the
program."""

import ast
import os
import sys

import pytest

from hgibench import run, spec

FORBIDDEN = {"jax", "jaxlib", "flax", "rustyhgi_tpu"}
PROGRAM = "rustyhgi_tpu_torch"


def _sources(folder):
    for dirpath, _, files in os.walk(folder):
        for name in files:
            if name.endswith(".py"):
                yield os.path.join(dirpath, name)


def _imported(path):
    """Top-level names of every module a file imports, its own package's
    relative imports as ``hgibench``."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            names.add("hgibench" if node.level else node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "import_module":
            arg = node.args[0]
            if isinstance(arg, ast.Constant):
                names.add(arg.value.split(".")[0])
            elif isinstance(arg, ast.JoinedStr) and isinstance(arg.values[0], ast.Constant):
                names.add(arg.values[0].value.split(".")[0])
    return names


@pytest.mark.parametrize("path", sorted(_sources(spec.PKG)), ids=lambda p: os.path.relpath(p, spec.PKG))
def test_no_module_imports_jax_or_the_jax_package(path):
    assert not _imported(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted(_sources(os.path.join(spec.PKG, "reference"))),
                         ids=os.path.basename)
def test_the_reference_imports_nothing_of_the_program(path):
    names = _imported(path)
    assert PROGRAM not in names and "torch" not in names
    assert names <= {"hgibench", "numpy", "struct", "zlib", "typing", "__future__"}


def test_the_run_module_imports_only_the_standard_library_at_its_top():
    with open(os.path.join(spec.PKG, "run.py")) as f:
        tree = ast.parse(f.read())
    top = {a.name.split(".")[0] for node in tree.body if isinstance(node, ast.Import)
           for a in node.names}
    top |= {node.module.split(".")[0] for node in tree.body
            if isinstance(node, ast.ImportFrom) and not node.level}
    assert top <= set(sys.stdlib_module_names)


def test_the_check_of_loaded_modules_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "rustyhgi_tpu_torch_fake", sys)
    for name in FORBIDDEN:
        monkeypatch.delitem(sys.modules, name, raising=False)
    assert run.jax_loaded() == []
    monkeypatch.setitem(sys.modules, "rustyhgi_tpu.models", sys)
    assert run.jax_loaded() == ["rustyhgi_tpu"]
