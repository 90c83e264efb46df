"""Nothing of the benchmark imports JAX or the JAX package; the reference
imports nothing of the program either."""
from __future__ import annotations

import ast
import pathlib

import pytest
import smoke_cell  # noqa: F401

import run as bench_run

BENCH = pathlib.Path(__file__).resolve().parents[1]
OLD_BENCHMARKS = "bench" + "marks/"  # the JAX package's benchmarks, which nothing here reads


@pytest.mark.parametrize("names, found", [
    (["repro_torch", "repro_torch.models.moe", "torch", "numpy"], []),
    (["repro", "repro_torch"], ["repro"]),
    (["repro.core.gf"], ["repro"]),
    (["jax.numpy", "jaxlib.xla_client", "flax.linen"], ["flax", "jax", "jaxlib"]),
    (["jaxtyping", "reprolib", "flaxen"], []),
])
def test_forbidden_modules_compare_whole_top_level_names(names, found):
    assert bench_run.forbidden_modules(names) == found


def _imports(path: pathlib.Path) -> set[str]:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            out.add(node.module.split(".")[0])
    return out


def test_no_file_of_the_benchmark_imports_jax_or_the_jax_package():
    files = sorted(BENCH.rglob("*.py"))
    assert len(files) > 10
    for path in files:
        assert not _imports(path) & set(bench_run.FORBIDDEN), path
        assert OLD_BENCHMARKS not in path.read_text(), path


def test_the_reference_imports_nothing_of_the_program():
    for path in sorted((BENCH / "reference").glob("*.py")):
        assert _imports(path) <= {"__future__", "dataclasses", "math", "torch"}, path
