"""What the benchmark may import: never JAX, Flax or the JAX package
(top-level names compared whole: the port's name begins with the JAX
package's), and in the reference nothing of the program either."""

import ast

import pytest

from gpubench import core

FILES = sorted(p for p in core.ROOT.rglob("*.py") if "tests" not in p.parts)


def imported(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(
    p.relative_to(core.ROOT)))
def test_no_jax_and_a_plain_reference(path):
    names = imported(path)
    assert not names & {"jax", "jaxlib", "flax", "tinyknn_tpu"}
    if "reference" in path.parts:
        assert names <= {"__future__", "math", "typing", "numpy", "torch"}


def test_the_whole_name_is_compared():
    assert core.forbidden_modules(["tinyknn_tpu_torch.models", "numpy"]) == []
    assert core.forbidden_modules(["tinyknn_tpu.ops.kernels"]) == [
        "tinyknn_tpu"]
    assert core.forbidden_modules(["jax._src.core", "flax"]) == ["flax",
                                                                 "jax"]
