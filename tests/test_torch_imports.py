"""Import hygiene of the PyTorch port: robotoc_tpu_torch and chip_smoke.py
import neither JAX, flax nor anything of the JAX package robotoc_tpu.

Every module of the port, and chip_smoke.py itself, is imported in a fresh
interpreter where `jax`, `flax` and `robotoc_tpu` are blocked in
sys.modules, and the sources are checked by AST for any import of them."""
import ast
import os
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
PKG = ROOT / "robotoc_tpu_torch"
BLOCKED = ("jax", "flax", "robotoc_tpu")


def _port_files():
    return sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _modules():
    mods = []
    for f in sorted(PKG.rglob("*.py")):
        rel = f.relative_to(ROOT).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        mods.append(".".join(parts))
    return mods


def test_port_modules_import_without_jax():
    code = ("import sys\n"
            + "".join(f"sys.modules[{m!r}] = None\n" for m in BLOCKED)
            + "import importlib\n"
            + f"for m in {_modules()!r}:\n"
            + "    importlib.import_module(m)\n"
            + "import chip_smoke\n"
            + "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            + f"{BLOCKED!r} and sys.modules[m] is not None)\n"
            + "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_import_in_source(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Name):
            assert node.id not in BLOCKED, (path, node.id)
            continue
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            # module names handed to importlib or __import__
            v = node.value
            assert v not in BLOCKED and not v.startswith(
                ("jax.", "flax.", "robotoc_tpu.")), (path, v)
            continue
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            if node.level:          # relative import inside the port
                continue
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in BLOCKED, (path, name)
