"""Nothing under hcs_bench/ imports JAX or the JAX package (top-level
module names compared whole), the reference imports nothing of the
program, and nothing reads the TPU benchmark's files. The plug-ins
(``networks/``, ``pipelines/``) import nothing of the program, and the
harness's own modules name no network and branch on no pipeline, so that a
new network or pipeline comes as new files."""

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


@pytest.mark.parametrize("path", [p for p in FILES if p.parent.name in ("networks", "pipelines")],
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_plugins_import_nothing_of_the_program(path):
    """A plug-in reaches the program through ``program.py`` (its calls, or
    ``program.resolve`` of a dotted path), never by an import."""
    assert "saguaro_tpu_torch" not in top_level_imports(path)


HARNESS = ["run.py", "program.py", "compare.py", "calibrate.py", "weights.py", "yardstick.py"]


@pytest.mark.parametrize("name", HARNESS)
def test_harness_names_no_network(name):
    text = (BENCH / name).read_text()
    for word in ("gradient_cpnet", "EffNetV2", "CellposeConfig", "cpnet_", "effnet", "CPnet"):
        assert word not in text, word


@pytest.mark.parametrize("name", HARNESS)
def test_harness_branches_on_no_pipeline(name):
    """No comparison with a pipeline's or a network's name."""
    names = {p.stem for d in ("networks", "pipelines") for p in (BENCH / d).glob("*.py")}
    for node in ast.walk(ast.parse((BENCH / name).read_text())):
        if isinstance(node, ast.Compare):
            consts = [c.value for c in [node.left, *node.comparators] if isinstance(c, ast.Constant)]
            assert not set(consts) & names, ast.unparse(node)


def test_cpnet_shares_no_code_with_the_plain_copy():
    """CPnet's forward pass, written from cellpose's definitions, uses
    nothing of the frozen copy of the program's plain forms but its switch
    to full float32 (``plain/device.full_f32``)."""
    used = module_imports(BENCH / "networks" / "cpnet.py")
    assert {m for m in used if m.startswith("hcs_bench.reference.plain")} <= {"hcs_bench.reference.plain.device"}


def test_job_reaches_the_program_by_dotted_path():
    """The job pipeline names the program's job and its stage timer by
    dotted paths into the port, which ``program.resolve`` finds."""
    from hcs_bench import program
    from hcs_bench.pipelines import job

    for path in (job.JOB, job.TIMER):
        assert path.startswith("saguaro_tpu_torch.") and callable(program.resolve(path))
