"""Nothing the benchmark runs imports JAX or the JAX package, and the
references import nothing of the program.  Top-level module names are
compared whole: the port's name begins with the JAX package's."""

import ast
import os

import pytest

from robchar_bench import harness, run

SOURCES = sorted(
    os.path.join(d, f) for d, _, fs in os.walk(harness.PACKAGE)
    for f in fs if f.endswith(".py"))


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and \
                node.level == 0:
            names.add(node.module)
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", None) == "import_module" and \
                node.args and isinstance(node.args[0], ast.Constant):
            names.add(node.args[0].value)
    return {n.split(".")[0] for n in names}


@pytest.mark.parametrize("path", SOURCES,
                         ids=lambda p: os.path.relpath(p, harness.ROOT))
def test_no_jax_import(path):
    assert not _imports(path) & set(run.FORBIDDEN)


@pytest.mark.parametrize(
    "path", [p for p in SOURCES if os.sep + "reference" + os.sep in p],
    ids=os.path.basename)
def test_reference_imports_nothing_of_the_program(path):
    assert not _imports(path) & {"code_robchar_tpu_torch",
                                 *run.FORBIDDEN}


def test_forbidden_names_are_compared_whole():
    found = harness.forbidden_modules(
        ["code_robchar_tpu_torch", "code_robchar_tpu_torch.ops", "jaxtyping",
         "numpy"], run.FORBIDDEN)
    assert found == []
    assert harness.forbidden_modules(
        ["code_robchar_tpu.ops", "jax", "flax.linen"], run.FORBIDDEN) == \
        ["code_robchar_tpu", "flax", "jax"]
