"""Nothing the harness runs loads JAX or the JAX package, compared by whole
top-level name; the references load nothing of the program."""
import ast
from pathlib import Path

import pytest

from benchmark import harness

BENCH = harness.BENCH_DIR
FORBIDDEN = {"jax", "jaxlib", "flax", "pyfft_tpu"}
# what computes the yardstick: the inputs, references, controls, checks,
# the frozen arithmetic, the traffic and the readers
YARDSTICK = ([BENCH / n for n in ("plain.py", "work.py", "traffic.py",
                                  "tracing.py", "faults.py")]
             + sorted((BENCH / "configs").glob("*.py"))
             + sorted((BENCH / "metrics").glob("*.py")))


def top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", sorted(BENCH.rglob("*.py")),
                         ids=lambda p: p.relative_to(BENCH).as_posix())
def test_no_module_imports_jax_or_the_jax_package(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", YARDSTICK, ids=lambda p: p.name)
def test_the_yardstick_imports_nothing_of_the_program(path):
    assert "pyfft_tpu_torch" not in top_level_imports(path)


def test_the_whole_name_is_compared():
    import sys
    sys.modules.setdefault("pyfft_tpu_torch_probe_", sys)
    try:
        assert "pyfft_tpu" not in harness.forbidden_modules()
    finally:
        del sys.modules["pyfft_tpu_torch_probe_"]
