"""No module under ``wfbench/`` imports JAX or the JAX package ``repro``
(top-level names compared whole: ``repro_torch`` is the port), and the
reference imports nothing of the program."""
import ast
from pathlib import Path

import pytest

WFBENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


MODULES = sorted(WFBENCH.rglob("*.py"))


@pytest.mark.parametrize("path", MODULES,
                         ids=[str(p.relative_to(WFBENCH)) for p in MODULES])
def test_no_jax_and_a_reference_apart_from_the_program(path):
    names = top_level_imports(path)
    assert not names & FORBIDDEN, (path, names & FORBIDDEN)
    if "reference" in path.relative_to(WFBENCH).parts:
        assert "repro_torch" not in names and "wfbench" not in names


def test_the_check_compares_whole_names(tmp_path):
    bad = tmp_path / "m.py"
    bad.write_text("import repro.core\nfrom repro_torch import table_api\n"
                   "from jax import numpy\n")
    assert top_level_imports(bad) == {"repro", "repro_torch", "jax"}
    assert top_level_imports(bad) & FORBIDDEN == {"repro", "jax"}
