"""The guard against JAX and the JAX package, and a run's refusals: no
card, or no program beside the benchmark, gives no result."""

import json
import subprocess
import sys
import types

import pytest

from benchmark.harness import guard, session
from benchmark.tests._util import ROOT, copy_benchmark, cpu_job


@pytest.mark.parametrize("modules,found", [
    (["nums_tpu_torch", "nums_tpu_torch.core.ops", "torch"], []),
    (["nums_tpu", "nums_tpu_torch"], ["nums_tpu"]),
    (["nums_tpu.core.array"], ["nums_tpu"]),
    (["jax", "jax.numpy"], ["jax"]),
    (["jaxlib.xla_client"], ["jaxlib"]),
    (["flax.linen"], ["flax"]),
    (["jaxtyping", "nums_tpu_extra", "jax_plugins"], []),
])
def test_top_level_names_are_compared_whole(modules, found):
    assert guard.forbidden_loaded(dict.fromkeys(modules)) == found


def test_a_run_that_loaded_jax_gives_no_result(tiny, monkeypatch):
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    with pytest.raises(RuntimeError, match="forbidden modules"):
        session.run(cpu_job(tiny, "gram.xtx.2p5m", seconds=0.05))


def _cli(cwd, *extra):
    return subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "gram.xtx.2p5m",
         "--seed", "3", "--seconds", "1", "--trace", "0", *extra],
        cwd=cwd, capture_output=True, text=True, timeout=120,
        env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": "",
             "HOME": str(cwd)})


def test_no_card_no_result():
    proc = _cli(ROOT)
    assert proc.returncode != 0 and proc.stdout == "", proc.stderr
    assert "CUDA" in proc.stderr


def test_benchmark_alone_no_result(tmp_path):
    root = copy_benchmark(tmp_path)
    assert sorted(p.name for p in root.iterdir()) == ["BENCHMARK.json",
                                                      "benchmark"]
    proc = _cli(root)
    assert proc.returncode != 0 and proc.stdout == "", proc.stderr


def test_result_line_shape_on_the_cpu(tiny):
    out = session.run(cpu_job(tiny, "gram.xtx.2p5m", seconds=0.05))
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(out)[-1] == "compared"
    json.dumps(out)
    # A CPU run writes no device metric.
    assert "peak_device_gb" not in out["metrics"]
    assert out["device"]["platform"] == "cpu"
