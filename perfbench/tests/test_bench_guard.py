"""Nothing the benchmark runs loads the JAX stack or the JAX package, and
the reference loads nothing of the program."""
import ast

import pytest

from perfbench.harness import guard
from perfbench.tests.conftest import ROOT

PERFBENCH = ROOT / "perfbench"
# the reference side: plain numpy and torch, nothing of the program
REFERENCE = ["reference.py", "harness/control.py", *(
    f"datasets/{p.name}" for p in (PERFBENCH / "datasets").glob("*.py"))]


def imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_top_level_names_compared_whole():
    assert guard.banned_modules({"jax": 1, "jax.numpy": 1, "repro.core": 1, "flax": 1}) == [
        "flax", "jax", "jax.numpy", "repro.core"]
    assert guard.banned_modules({"repro_torch": 1, "repro_torch.core": 1, "jaxtyping": 1,
                                 "reprox": 1}) == []


@pytest.mark.parametrize("path", sorted(p.relative_to(PERFBENCH).as_posix()
                                        for p in PERFBENCH.rglob("*.py")))
def test_no_file_imports_jax_or_the_jax_package(path):
    for name in imports(PERFBENCH / path):
        top = name.split(".")[0]
        assert top not in guard.BANNED and top != "benchmarks", (path, name)


@pytest.mark.parametrize("path", REFERENCE)
def test_reference_imports_nothing_of_the_program(path):
    for name in imports(PERFBENCH / path):
        top = name.split(".")[0]
        assert top != "repro_torch" and not (top == "perfbench" and "program" in name), (path, name)
