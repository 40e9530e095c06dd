"""The port stands alone: nums_tpu_torch and chip_smoke.py import neither
jax nor nums_tpu, and chip_smoke.py refuses to run without a CUDA card.
"""

import ast
import os
import pathlib
import shutil
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parents[1]
PACKAGE = REPO / "nums_tpu_torch"

# Import every module of the port with jax and nums_tpu blocked; fail if
# any of them is in sys.modules afterwards.
_PROBE = r"""
import importlib, pkgutil, sys

class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "nums_tpu"):
            raise ImportError("blocked: " + name)
        return None

for name in [m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "nums_tpu")]:
    del sys.modules[name]
sys.meta_path.insert(0, Block())
import nums_tpu_torch
for mod in pkgutil.walk_packages(nums_tpu_torch.__path__, "nums_tpu_torch."):
    importlib.import_module(mod.name)
app = nums_tpu_torch.init()
print(app.backend.device.type)
bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "nums_tpu")]
assert not bad, bad
"""


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO)
    env["CUDA_VISIBLE_DEVICES"] = ""
    return env


def test_port_imports_no_jax():
    out = subprocess.run(
        [sys.executable, "-c", _PROBE], cwd=REPO, env=_env(),
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "cpu"


@pytest.mark.parametrize(
    "path",
    sorted(str(p.relative_to(REPO)) for p in PACKAGE.rglob("*.py"))
    + ["chip_smoke.py"],
)
def test_no_jax_import_statements(path):
    tree = ast.parse((REPO / path).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in ("jax", "jaxlib", "nums_tpu"), (
                path, name,
            )


def test_chip_smoke_needs_a_card():
    out = subprocess.run(
        [sys.executable, str(REPO / "chip_smoke.py")], cwd=REPO,
        env=_env(), capture_output=True, text=True, timeout=120,
    )
    assert out.returncode != 0
    assert "no CUDA device" in out.stderr
    assert '"ok"' not in out.stdout


def test_chip_smoke_alone_fails(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = _env()
    env.pop("PYTHONPATH")
    out = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=tmp_path, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
