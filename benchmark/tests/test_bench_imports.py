"""What the benchmark's modules may import: nothing of JAX, Flax or the JAX
package (top-level names compared whole: the port's name begins with the
JAX package's), nor bench.py or chip_smoke.py; and the reference nothing of
the program either."""

import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
FILES = sorted(p for p in BENCH.rglob("*.py") if "__pycache__" not in p.parts)
BANNED = {"jax", "jaxlib", "flax", "audio_analysis_tpu", "bench", "chip_smoke"}


def top_level_imports(path: Path) -> set:
    tree = ast.parse(path.read_text(), str(path))
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module" and node.args:
            arg = node.args[0]
            if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
                names.add(arg.value.split(".")[0])
    return names


def test_whole_name_comparison():
    src = "import audio_analysis_tpu_torch.io\nfrom audio_analysis_tpu.ops import x\nimport jaxtyping\n"
    p = BENCH / "tests" / "_probe_imports.txt"
    try:
        p.write_text(src)
        assert top_level_imports(p) == {"audio_analysis_tpu_torch", "audio_analysis_tpu", "jaxtyping"}
    finally:
        p.unlink()
    assert "audio_analysis_tpu_torch" not in BANNED and "jaxtyping" not in BANNED


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_and_no_jax_package(path):
    assert not (top_level_imports(path) & BANNED)


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")), ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert "audio_analysis_tpu_torch" not in top_level_imports(path)
    assert top_level_imports(path) <= {"__future__", "math", "dataclasses", "typing", "numpy", "torch", "reference"}


def test_no_file_names_the_smoke_script_or_the_jax_benchmark():
    for path in FILES:
        text = path.read_text()
        if path.name == "test_bench_imports.py":
            continue
        assert "chip_smoke" not in text and "bench.py" not in text, path
