"""The port stands alone: no module of ``production_stack_tpu_torch``,
and not ``chip_smoke.py``, imports JAX or the JAX package.

The port's package name starts with the JAX package's, so a module
counts as the JAX package only when its name is
``production_stack_tpu`` exactly or starts with
``production_stack_tpu.``.
"""

import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "production_stack_tpu")


def _sources():
    files = sorted((ROOT / "production_stack_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    return files


def _imported_modules(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value)


def _forbidden(module: str) -> bool:
    return any(module == name or module.startswith(name + ".")
               for name in FORBIDDEN)


def test_forbidden_matcher_handles_the_prefix():
    assert _forbidden("production_stack_tpu")
    assert _forbidden("production_stack_tpu.engine.config")
    assert _forbidden("jax.numpy") and _forbidden("jaxlib")
    assert not _forbidden("production_stack_tpu_torch.engine.config")
    assert not _forbidden("jaxtyping")


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_import(path):
    assert path.exists(), path
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = [m for m in _imported_modules(tree) if _forbidden(m)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"
