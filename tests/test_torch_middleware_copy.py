"""Drift guard: the port's middleware copy stays the reference's code.

``repro_torch/{api,core,runtime}`` is a mechanical copy of the JAX
package's framework-neutral middleware, imports rewritten; a fix to one copy
must be made in the other.  Every module of the copy, other than the
ported touchpoints (tensor serialization in ``core/serialize.py``, array
spoofing in ``core/proxy.py``, and ``runtime/serving.py``, whose server
stamps its requests on the port's tracer and records its spans), must parse
to the same AST as the reference's once ``repro_torch`` reads ``repro`` and
docstrings are dropped (comments never reach the AST).  The port's tracer
(``runtime/trace.py``) has no counterpart in the reference.
"""

from __future__ import annotations

import ast
from pathlib import Path

import pytest

SRC = Path(__file__).resolve().parents[1] / "src"
PARTS = ("api", "core", "runtime")
TOUCHPOINTS = {"core/serialize.py", "core/proxy.py", "runtime/serving.py"}
#: modules of the port alone
PORT_ONLY = {"runtime/trace.py"}


def _modules(package: str) -> set[str]:
    root = SRC / package
    return {p.relative_to(root).as_posix() for part in PARTS for p in (root / part).rglob("*.py")}


PORT = _modules("repro_torch")
COPIED = sorted(PORT - TOUCHPOINTS - PORT_ONLY)


def _code(path: Path, rename: bool) -> str:
    text = path.read_text()
    if rename:
        text = text.replace("repro_torch", "repro")
    tree = ast.parse(text)
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef, ast.AsyncFunctionDef)):
            body = node.body
            if body and isinstance(body[0], ast.Expr) and isinstance(body[0].value, ast.Constant) \
                    and isinstance(body[0].value.value, str):
                node.body = body[1:] or [ast.Pass()]
    return ast.dump(tree)


def test_the_copy_has_the_reference_modules():
    assert PORT - PORT_ONLY == _modules("repro")
    assert TOUCHPOINTS <= PORT and len(COPIED) > 30


@pytest.mark.parametrize("module", COPIED)
def test_copied_module_equals_the_reference(module):
    assert _code(SRC / "repro_torch" / module, True) == _code(SRC / "repro" / module, False)


@pytest.mark.parametrize("module", sorted(TOUCHPOINTS))
def test_touchpoints_are_ported(module):
    """The touchpoints differ from the reference (else they belong above)."""
    assert _code(SRC / "repro_torch" / module, True) != _code(SRC / "repro" / module, False)
