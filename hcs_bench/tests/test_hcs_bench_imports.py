"""Nothing under hcs_bench/ imports JAX or the JAX package (top-level
module names compared whole), the reference imports nothing of the
program, and nothing reads the TPU benchmark's files."""

from __future__ import annotations

import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
FILES = sorted(BENCH.rglob("*.py"))
FORBIDDEN = {"jax", "jaxlib", "flax", "saguaro_tpu"}


def top_level_imports(path: Path) -> set[str]:
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and isinstance(node.args[0], ast.Constant):
            out.add(str(node.args[0].value).split(".")[0])
    return out


def test_the_name_check_compares_whole_names():
    assert "saguaro_tpu_torch".split(".")[0] not in FORBIDDEN
    assert "saguaro_tpu.kernels".split(".")[0] in FORBIDDEN


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", [p for p in FILES if "reference" in p.parts],
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_reference_is_independent(path):
    assert "saguaro_tpu_torch" not in top_level_imports(path)


@pytest.mark.parametrize("path", [p for p in FILES if p != Path(__file__).resolve()],
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_reads_no_tpu_benchmark_file(path):
    text = path.read_text()
    for name in ("bench.py", "benchmarks/", "BENCH_r", "MULTICHIP_", "BASELINE"):
        assert name not in text


def test_only_program_module_imports_the_program():
    users = {p.relative_to(BENCH).as_posix() for p in FILES if "saguaro_tpu_torch" in top_level_imports(p)}
    assert users <= {"program.py"}


def module_imports(path: Path) -> set[str]:
    """Every module a file imports, by its full dotted name."""
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module)
    return out


@pytest.mark.parametrize("name", ["cellpose_ref.py", "cp_measure.py"])
def test_own_references_share_no_code_with_the_plain_copy(name):
    """The references written from cellpose's and CellProfiler's
    definitions use nothing of the frozen copy of the program's plain
    forms, nor of the benchmark's other modules."""
    used = module_imports(BENCH / "reference" / name)
    assert not [m for m in used if m.startswith("hcs_bench")]
