"""The port stands alone: nums_tpu_torch and chip_smoke.py import none of
jax, optax and nums_tpu, and chip_smoke.py refuses to run without a CUDA card.
``nums_tpu_torch.init()`` runs on the card: without one it raises, and
``init(device="cpu")`` is how a caller asks for the CPU.
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
        if name.split(".")[0] in ("jax", "jaxlib", "nums_tpu", "optax"):
            raise ImportError("blocked: " + name)
        return None

for name in [m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "nums_tpu", "optax")]:
    del sys.modules[name]
sys.meta_path.insert(0, Block())
import nums_tpu_torch
for mod in pkgutil.walk_packages(nums_tpu_torch.__path__, "nums_tpu_torch."):
    importlib.import_module(mod.name)
app = nums_tpu_torch.init(device="cpu")
print(app.backend.device.type)
bad = [m for m in sys.modules
       if m.split(".")[0] in ("jax", "jaxlib", "nums_tpu", "optax")]
assert not bad, bad
# The optional dependencies of the I/O layer load inside the functions
# that need them, not when a module is imported.
bad = [m for m in ("pyarrow", "pandas", "boto3", "modin") if m in sys.modules]
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


def test_init_needs_a_card_unless_the_cpu_is_asked_for():
    probe = ("import nums_tpu_torch\n"
             "print(nums_tpu_torch.init().backend.device.type)")
    out = subprocess.run(
        [sys.executable, "-c", probe], cwd=REPO, env=_env(),
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "RuntimeError" in out.stderr and 'device="cpu"' in out.stderr


@pytest.mark.parametrize("module", [
    "nums_tpu_torch.api",
    "nums_tpu_torch.core.io.filesystem",
    "nums_tpu_torch.core.io.checkpoint",
    "nums_tpu_torch.core.array.diskarray",
    "nums_tpu_torch.core.ops.streaming",
    "nums_tpu_torch.models._common",
    "nums_tpu_torch.core.ops.linalg",
    "nums_tpu_torch.models.preprocessing",
    "nums_tpu_torch.models.decomposition",
    "nums_tpu_torch.core.io._native",
    "nums_tpu_torch.core.io.shard_native",
    "nums_tpu_torch.core.io.fake_s3",
    "nums_tpu_torch.experimental.nums_modin",
    "nums_tpu_torch.core.ops.threefry",
    "nums_tpu_torch.core.ops.random_ops",
    "nums_tpu_torch.core.array.random",
    "nums_tpu_torch.numpy",
    "nums_tpu_torch.numpy.random",
    "nums_tpu_torch.numpy.api",
    "nums_tpu_torch.numpy.extra",
    "nums_tpu_torch.numpy.extra2",
    "nums_tpu_torch.numpy.extra3",
    "nums_tpu_torch.numpy.extra4",
    "nums_tpu_torch.numpy.compat",
    "nums_tpu_torch.numpy.tail",
    "nums_tpu_torch.numpy.fft",
    "nums_tpu_torch.cmds.api_coverage",
    "nums_tpu_torch.numpy.linalg",
    "nums_tpu_torch.core.trace",
    "nums_tpu_torch.core.ops.masking",
    "nums_tpu_torch._version",
    "nums_tpu_torch.autodiff",
    "nums_tpu_torch.optimize",
    "nums_tpu_torch.models.cluster",
    "nums_tpu_torch.models.trees",
    "nums_tpu_torch.experimental.nums_xgb",
    "nums_tpu_torch.core.multiprocess",
    "nums_tpu_torch.core.ops.summa",
    "nums_tpu_torch.core.backend",
    "nums_tpu_torch.core.application_manager",
    "nums_tpu_torch.core.array.application",
    "nums_tpu_torch.models.fast_glm",
    "nums_tpu_torch.models.glms",
])
def test_io_and_ooc_modules_import_first(module):
    """Each module of the I/O, out-of-core, linalg, ingestion, random,
    facade, models and mesh slices (and of their multi-process branches)
    imports as the first module of a process (no
    import cycle), with jax, nums_tpu and optax blocked."""
    probe = _PROBE.split("import nums_tpu_torch\n")[0] + (
        f"import {module}\n"
        "bad = [m for m in sys.modules\n"
        "       if m.split('.')[0] in ('jax', 'jaxlib', 'nums_tpu', 'optax')]\n"
        "assert not bad, bad\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", probe], cwd=REPO, env=_env(),
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr


def test_mesh_init_needs_a_card_unless_the_cpu_is_asked_for():
    """``init(backend="mesh")`` takes the card of its local rank and
    raises without one; with ``device="cpu"`` a process alone is a mesh of
    one device over gloo."""
    probe = ("import nums_tpu_torch\n"
             "print(nums_tpu_torch.init(backend='mesh').backend.device)")
    out = subprocess.run(
        [sys.executable, "-c", probe], cwd=REPO, env=_env(),
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "RuntimeError" in out.stderr and 'device="cpu"' in out.stderr
    probe = ("import nums_tpu_torch, torch.distributed as dist\n"
             "app = nums_tpu_torch.init(backend='mesh', device='cpu')\n"
             "print(app.backend.name, app.backend.cluster_shape,\n"
             "      dist.get_backend())")
    out = subprocess.run(
        [sys.executable, "-c", _PROBE.split("import nums_tpu_torch\n")[0]
         + probe], cwd=REPO, env=_env(), capture_output=True, text=True,
        timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["mesh", "(1,", "1)", "gloo"]


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
            assert name.split(".")[0] not in (
                "jax", "jaxlib", "nums_tpu", "optax"), (path, name)


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


def test_version_is_the_reference_version():
    import nums_tpu
    import nums_tpu_torch

    assert nums_tpu_torch.__version__ == nums_tpu.__version__ == "0.1.0"
    assert "__version__" in nums_tpu_torch.__all__
