"""The port stands alone: no module of ``production_stack_tpu_torch``,
and not ``chip_smoke.py``, imports JAX or the JAX package, nor a
package a CUDA serving host need not have that the offload tier and
the fleet routes might reach for (aiohttp, requests, msgpack,
ml_dtypes, fastapi: the port speaks HTTP through the standard library
and frames KV pages with its own msgpack codec).

The port's package name starts with the JAX package's, so a module
counts as the JAX package only when its name is
``production_stack_tpu`` exactly or starts with
``production_stack_tpu.``.
"""

import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "production_stack_tpu", "aiohttp",
             "requests", "msgpack", "ml_dtypes", "fastapi")
# Module directories of the port: each must exist and hold sources the
# scan below covers.
PACKAGE_DIRS = ("engine", "ops", "models", "utils", "tools", "qos",
                "kvecon")


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
    assert _forbidden("msgpack") and _forbidden("requests.adapters")
    assert _forbidden("aiohttp.web") and _forbidden("ml_dtypes")
    assert not _forbidden("requests_cache")


@pytest.mark.parametrize("name", PACKAGE_DIRS)
def test_package_dirs_are_scanned(name):
    """Each module directory of the port (the fleet slice's ``qos/`` and
    ``kvecon/`` among them) is a package whose files the import scan
    covers."""
    folder = ROOT / "production_stack_tpu_torch" / name
    assert (folder / "__init__.py").exists(), folder
    scanned = set(_sources())
    files = sorted(folder.glob("*.py"))
    assert files and all(f in scanned for f in files)


def test_forbidden_import_is_caught(tmp_path):
    """The scan finds a forbidden import in every form it is written."""
    src = ("import msgpack\n"
           "from requests import Session\n"
           "import importlib\n"
           "importlib.import_module('aiohttp')\n")
    tree = ast.parse(src)
    assert [m for m in _imported_modules(tree) if _forbidden(m)] == [
        "msgpack", "requests", "aiohttp"]


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_import(path):
    assert path.exists(), path
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = [m for m in _imported_modules(tree) if _forbidden(m)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"
