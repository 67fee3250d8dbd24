"""The PyTorch port stands alone: it imports neither JAX nor the JAX package.

Checked twice: by importing every ``repro_torch`` module (and
``chip_smoke.py``) in a fresh interpreter where ``import jax`` fails, and by
scanning the sources for such imports.
"""
import ast
import json
import os
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
SOURCES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]

_PROBE = r"""
import importlib, json, pkgutil, sys
sys.modules["jax"] = None           # any `import jax` now raises
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    importlib.import_module(name)
sys.path.insert(0, sys.argv[1])
import chip_smoke                    # defines, runs nothing at import
bad = sorted(m for m in sys.modules
             if m == "repro" or m.startswith("repro.") or m == "jaxlib"
             or m.startswith("jax."))
print(json.dumps({"modules": len(names), "loaded": bad}))
"""


def test_every_module_imports_with_jax_blocked():
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    out = subprocess.run([sys.executable, "-c", _PROBE, str(ROOT)], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["loaded"] == [], res
    assert res["modules"] >= 32


_ISOLATED = r"""
import importlib, json, sys
importlib.import_module(sys.argv[1])
print(json.dumps(sorted(m for m in sys.modules
                        if m.split(".")[0] in ("jax", "jaxlib", "repro"))))
"""


@pytest.mark.parametrize("module", [
    "repro_torch.serve", "repro_torch.serve.config",
    "repro_torch.serve.request", "repro_torch.serve.metrics",
    "repro_torch.dist", "repro_torch.dist.sampling",
    "repro_torch.core.scale_bank", "repro_torch.train.serve",
    "repro_torch.optim.adamw", "repro_torch.optim.compression",
    "repro_torch.data.pipeline", "repro_torch.ckpt.checkpoint",
    "repro_torch.train.step", "repro_torch.train.loop",
    "repro_torch.train.quickstart", "repro_torch.serve.traffic",
    "repro_torch.serve.telemetry", "repro_torch.serve.driver",
    "repro_torch.launch.serve", "repro_torch.launch.train",
    "repro_torch.train.instruction_tune",
    "repro_torch.train.serve_multitask"])
def test_serving_modules_pull_in_no_jax_nor_reference(module):
    """Imported alone, in a fresh interpreter with JAX importable, none of
    the serving and training modules loads ``jax`` or ``repro``."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    out = subprocess.run([sys.executable, "-c", _ISOLATED, module], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def _imports(path: pathlib.Path):
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_sources_import_no_jax_nor_reference(path):
    bad = [m for m in _imports(path)
           if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, f"{path}: imports {bad}"
