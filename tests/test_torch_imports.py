"""The port, its examples (``examples/*_torch.py``) and chip_smoke.py
import neither JAX nor the JAX package."""
import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + sorted(
    (ROOT / "examples").glob("*_torch.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported_modules(tree: ast.AST):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                yield "."                      # relative: inside the package
            else:
                yield node.module
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              == "import_module" and node.args
              and isinstance(node.args[0], (ast.Constant, ast.JoinedStr))):
            arg = node.args[0]
            text = (arg.value if isinstance(arg, ast.Constant)
                    else "".join(v.value for v in arg.values
                                 if isinstance(v, ast.Constant)))
            yield text


def test_files_exist():
    assert len(FILES) > 20 and (ROOT / "chip_smoke.py").is_file()


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_import(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for mod in _imported_modules(tree):
        top = mod.split(".")[0]
        assert top not in FORBIDDEN, f"{path.name} imports {mod!r}"


NEW_MODULES = ["repro_torch.launch.mesh", "repro_torch.launch.sharding",
               "repro_torch.configs.mistral_large_123b",
               "repro_torch.bridge", "repro_torch.serving.scheduler"]


def test_mesh_modules_are_checked():
    names = {str(p.relative_to(ROOT)) for p in FILES}
    for mod in NEW_MODULES:
        assert "src/" + mod.replace(".", "/") + ".py" in names


@pytest.mark.parametrize("module", NEW_MODULES)
def test_importing_loads_neither_jax_nor_the_reference(module):
    """Run time, not only the source: importing the module (and all it
    imports) leaves JAX and the JAX package unloaded."""
    import subprocess
    import sys
    code = (f"import sys, {module}; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]; assert not bad, bad")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, cwd=ROOT,
                          env={"PYTHONPATH": str(ROOT / "src"),
                               "PATH": "/usr/bin:/bin"}, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
