"""What the benchmark imports: nothing of JAX or the JAX package anywhere
under portbench/ (top-level module names compared whole: the port's
name begins with the JAX package's), and nothing of the port in the
reference."""

from __future__ import annotations

import ast
from pathlib import Path

import pytest

from portbench.common import FORBIDDEN

ROOT = Path(__file__).resolve().parents[1]
FILES = sorted(ROOT.rglob("*.py"))


def top_level_imports(path: Path) -> set:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            if node.args and isinstance(node.args[0], ast.Constant):
                names.add(str(node.args[0].value).split(".")[0])
    return names


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_anywhere(path):
    assert not top_level_imports(path) & set(FORBIDDEN)


@pytest.mark.parametrize("path", sorted((ROOT / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port(path):
    assert "transfusion_tpu_torch" not in top_level_imports(path)


def test_whole_names_are_compared():
    forbidden = set(FORBIDDEN)
    assert "transfusion_tpu_torch" not in forbidden and "transfusion_tpu" in forbidden
    assert {"transfusion_tpu_torch.models"} and "transfusion_tpu_torch".split(".")[0] \
        not in forbidden
