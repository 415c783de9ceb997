"""No module of the benchmark imports JAX or the JAX package, and the reference imports
nothing of the program. Top-level names are compared whole: the port's name, tpupt_torch,
starts with the JAX package's."""

import ast
import os

import pytest

from ptbench.core import spec

FORBIDDEN = {"jax", "jaxlib", "flax", "tpupt"}


def _modules():
    for base, _, files in os.walk(spec.HERE):
        if "_work" in base:
            continue
        for fn in files:
            if fn.endswith(".py"):
                yield os.path.join(base, fn)


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(_modules()), ids=lambda p: os.path.relpath(p, spec.HERE))
def test_no_jax(path):
    assert not set(_imports(path)) & FORBIDDEN


def test_the_reference_imports_nothing_of_the_program():
    ref = os.path.join(spec.HERE, "reference")
    for fn in os.listdir(ref):
        if fn.endswith(".py"):
            names = set(_imports(os.path.join(ref, fn)))
            assert not names & ({"tpupt_torch", "ptbench"} | FORBIDDEN), fn


def test_the_top_level_names_are_compared_whole():
    from ptbench.core import device

    assert "tpupt_torch" not in device.FORBIDDEN and "tpupt" in device.FORBIDDEN
    assert device.forbidden_modules() == []
