"""The port stands alone: `repro_torch` and ``chip_smoke.py`` import neither
JAX nor the reference package, and the chip smoke run refuses to run (and
prints no result) where there is no GPU or no repository beside it."""

import ast
import os
import pathlib
import shutil
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
SMOKE = ROOT / "chip_smoke.py"

_IMPORT_ALL = """
import importlib, pkgutil, sys
sys.modules["jax"] = None          # any `import jax` now raises ImportError
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
loaded = [m for m, mod in sys.modules.items() if mod is not None]
bad = sorted(m for m in loaded if m.split(".")[0] in ("repro", "jax", "jaxlib"))
assert not bad, bad
print(" ".join(names))
"""


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    return env


def test_port_imports_without_jax_or_repro():
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], env=_env(),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    names = set(out.stdout.split())
    assert len(names) >= 15                   # every module was imported
    assert {"repro_torch.check", "repro_torch.check.passes",
            "repro_torch.check.kernels", "repro_torch.check.dataflow",
            "repro_torch.check.__main__", "repro_torch.core.amc",
            "repro_torch.core.planner", "repro_torch.obs",
            "repro_torch.obs.trace", "repro_torch.obs.metrics",
            "repro_torch.obs.export", "repro_torch.obs.__main__",
            "repro_torch.launch.planserve", "repro_torch.data",
            "repro_torch.data.pipeline"} <= names


def test_chip_smoke_imports_nothing_of_jax_or_repro():
    tree = ast.parse(SMOKE.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module)
    assert not {n for n in names if n.split(".")[0] in ("repro", "jax", "jaxlib")}
    assert "repro_torch" in {n.split(".")[0] for n in names}


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_gpu_or_repo(alone, tmp_path):
    if torch.cuda.is_available() and not alone:
        pytest.skip("a CUDA device is present")
    script = SMOKE
    if alone:
        script = tmp_path / "chip_smoke.py"
        shutil.copy(SMOKE, script)
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, str(script)], cwd=script.parent,
                         env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    assert "FAIL" in out.stderr
