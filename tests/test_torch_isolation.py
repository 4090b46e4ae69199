"""The port stands alone: tlxcv_tpu_torch and chip_smoke.py import neither
JAX nor anything of the tlxcv_tpu package."""
import ast
import json
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "tlxcv_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]

_PROBE = """
import importlib, json, pkgutil, sys
import tlxcv_tpu_torch
names = [m.name for m in pkgutil.walk_packages(tlxcv_tpu_torch.__path__,
                                               "tlxcv_tpu_torch.")]
for name in names:
    importlib.import_module(name)
bad = [m for m in sys.modules
       if m == "jax" or m.startswith(("jax.", "jaxlib"))
       or m == "tlxcv_tpu" or m.startswith("tlxcv_tpu.")]
print(json.dumps({"imported": names, "bad": bad}))
"""


def test_importing_every_port_module_pulls_in_no_jax():
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert "tlxcv_tpu_torch.ops.cuda.attention" in got["imported"]
    assert "tlxcv_tpu_torch.utils.bridge" in got["imported"]
    for name in ("train.trainer", "train.optimizers", "data.loader",
                 "data.shapes_det", "ops.losses"):
        assert f"tlxcv_tpu_torch.{name}" in got["imported"]
    assert got["bad"] == []


def _imported_roots(path):
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_no_jax_import_in_source(path):
    assert not _imported_roots(path) & {"jax", "jaxlib", "tlxcv_tpu"}
