"""Nothing under benchmark/ imports JAX or the JAX package (top-level
module names compared whole: the port's name begins with the JAX
package's), and the plain reference imports nothing of the port."""

import ast
import os
import subprocess
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = {"jax", "jaxlib", "flax", "hybridgl_tpu"}


def imported(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def sources(sub=""):
    for root, _, files in os.walk(os.path.join(BENCH, sub)):
        yield from (os.path.join(root, f) for f in files if f.endswith(".py"))


@pytest.mark.parametrize("path", sorted(sources()), ids=lambda p: os.path.relpath(p, BENCH))
def test_no_jax(path):
    assert not set(imported(path)) & FORBIDDEN


@pytest.mark.parametrize("path", sorted(sources("benchref")), ids=lambda p: os.path.relpath(p, BENCH))
def test_reference_imports_nothing_of_the_port(path):
    assert "hybridgl_tpu_torch" not in set(imported(path))


def test_run_refuses_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    done = subprocess.run([sys.executable, os.path.join(BENCH, "run.py"), "--workload", "refcoco-occupancy", "--seed",
                           "3000000017", "--seconds", "1", "--trace", "0"], capture_output=True, text=True, env=env,
                          timeout=300)
    assert done.returncode != 0 and done.stdout.strip() == ""
