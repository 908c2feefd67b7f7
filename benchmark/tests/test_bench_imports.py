"""What the harness and the reference load: never jax, jaxlib, flax or
the JAX package (compared by the whole top-level name: the port's name
begins with the JAX package's), and the reference nothing of the
program."""

from __future__ import annotations

import ast
import os
import subprocess
import sys

import pytest

from conftest import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "street_gaussians_tpu"}
BENCH = os.path.join(ROOT, "benchmark")


def _imports(path: str) -> set:
    with open(path) as f:
        tree = ast.parse(f.read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def _sources(sub: str = ""):
    for d, _, fs in os.walk(os.path.join(BENCH, sub)):
        if "tests" in os.path.relpath(d, BENCH).split(os.sep):
            continue
        yield from (os.path.join(d, f) for f in fs if f.endswith(".py"))


def test_no_source_of_the_benchmark_imports_jax_or_the_jax_package():
    for path in _sources():
        assert not (_imports(path) & FORBIDDEN), path


def test_the_reference_imports_nothing_of_the_program():
    for path in _sources("reference"):
        assert "street_gaussians_torch" not in _imports(path), path


_RUN = """
import sys, time, torch
sys.path.insert(0, {root!r}); sys.path.insert(0, {tests!r})
from conftest import toy_cell
from benchmark.harness import loops
{body}
print(" ".join(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


@pytest.mark.parametrize("what,body", [
    ("harness", "loops.run_train(toy_cell('waymo_train_002', 'train_objgate'), 9, 0.2, True, torch.device('cpu'), "
                "time.perf_counter()); loops.run_serve(toy_cell('waymo_train_002', 'serve_trajectory'), 9, 0.5, "
                "False, torch.device('cpu'), time.perf_counter())"),
    ("reference", "import benchmark.reference.train, benchmark.reference.render"),
])
def test_loaded_modules(what, body):
    if what == "reference":
        code = (f"import sys; sys.path.insert(0, {ROOT!r}); import benchmark.reference.train, "
                "benchmark.reference.render; print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))")
    else:
        code = _RUN.format(root=ROOT, tests=os.path.dirname(os.path.abspath(__file__)), body=body)
    env = dict(os.environ, USE_FLAX="0")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=600, env=env, cwd=ROOT)
    assert r.returncode == 0, r.stderr[-3000:]
    loaded = set(r.stdout.strip().splitlines()[-1].split())
    assert not (loaded & FORBIDDEN), loaded & FORBIDDEN
    if what == "reference":
        assert "street_gaussians_torch" not in loaded
    else:
        assert "street_gaussians_torch" in loaded
