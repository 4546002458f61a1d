"""No module of the benchmark imports the JAX stack or the JAX package
`repro` (top-level names compared whole: `repro_torch` starts with
`repro`), and the reference imports nothing of the program."""
import ast

import pytest

import benchpath
from benchpath import one_torch_thread  # noqa: F401

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
SOURCES = sorted(p for p in benchpath.BENCH.rglob("*.py")
                 if "__pycache__" not in p.parts)


def top_level_imports(path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".", 1)[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".", 1)[0])
    return names


def test_sources_are_found():
    assert any(p.name == "run.py" for p in SOURCES)
    assert any(p.parent.name == "reference" for p in SOURCES)


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(benchpath.BENCH)) for p in SOURCES])
def test_no_jax_anywhere(path):
    assert not top_level_imports(path) & FORBIDDEN


def test_reference_imports_nothing_of_the_program():
    for p in (benchpath.BENCH / "reference").rglob("*.py"):
        assert not top_level_imports(p) & (FORBIDDEN | {"repro_torch",
                                                        "torch"}), p


def test_whole_name_comparison(tmp_path):
    p = tmp_path / "m.py"
    p.write_text("import repro_torch.core\nfrom reprox import y\n"
                 "from . import z\n")
    assert top_level_imports(p) == {"repro_torch", "reprox"}
    p.write_text("import jax.numpy as jnp\nfrom repro.core import x\n")
    assert top_level_imports(p) == {"jax", "repro"}
