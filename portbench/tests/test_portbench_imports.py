"""No module of the benchmark imports JAX or the JAX package, and the
reference imports nothing of the program. Names are compared whole by
their part before the first dot: ``repro_torch`` is the port, ``repro``
the JAX package."""
import ast
import pathlib

import pytest

from portbench import harness

PKG = pathlib.Path(__file__).resolve().parents[1]
MODULES = sorted(PKG.rglob("*.py"))
NEVER = {"jax", "jaxlib", "flax", "repro"}


def top_level_imports(path: pathlib.Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            names.add(str(node.args[0].value).split(".")[0])
    return names


def test_walk_finds_the_modules():
    rel = {p.relative_to(PKG).as_posix() for p in MODULES}
    assert {"run.py", "harness.py", "drivers/free_run.py",
            "reference/free_run_ref.py"} <= rel


@pytest.mark.parametrize("path", MODULES,
                         ids=lambda p: p.relative_to(PKG).as_posix())
def test_no_jax_and_no_jax_package(path):
    assert not top_level_imports(path) & NEVER


@pytest.mark.parametrize(
    "path", sorted((PKG / "reference").rglob("*.py")),
    ids=lambda p: p.relative_to(PKG).as_posix())
def test_reference_imports_nothing_of_the_program(path):
    assert "repro_torch" not in top_level_imports(path)
    assert top_level_imports(path) <= {"__future__", "gzip", "hashlib",
                                       "json", "zlib", "bisect", "math",
                                       "numpy", "torch"}


def test_the_walk_catches_what_it_must(tmp_path):
    bad = tmp_path / "bad.py"
    bad.write_text("import jax.numpy as jnp\nfrom repro.core import x\n"
                   "import repro_torch\nimportlib.import_module('flax')\n")
    assert top_level_imports(bad) == {"jax", "repro", "repro_torch", "flax"}


def test_loaded_modules_are_judged_by_their_top_level_name():
    assert harness.forbidden_modules(
        ["repro_torch", "repro_torch.core", "portbench", "reprox",
         "jaxtyping"]) == []
    assert harness.forbidden_modules(
        ["repro", "repro.core.cache", "jax._src", "jaxlib", "flax.linen",
         "numpy"]) == ["flax.linen", "jax._src", "jaxlib", "repro",
                       "repro.core.cache"]
