"""Helpers of the benchmark's CPU tests: a copy of the benchmark whose
configurations are cut to a size the CPU runs in seconds, every other
file as committed, and a job that runs a cell of it on the CPU."""

import json
import math
import shutil
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

# Rows a card and columns of the tiny copies. The gram's comparison is of
# sums over the rows, so it takes more of them to read as it does at size.
TINY = {"logreg_newton": (4096, 16), "gram": (65536, 16)}


def copy_benchmark(dst):
    """BENCHMARK.json and benchmark/ of this checkout under ``dst``."""
    dst = Path(dst)
    dst.mkdir(parents=True, exist_ok=True)
    shutil.copy(ROOT / "BENCHMARK.json", dst)
    shutil.copytree(ROOT / "benchmark", dst / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    return dst


def tiny_root(dst):
    root = copy_benchmark(dst)
    for f in (root / "benchmark" / "configs").glob("*.json"):
        cfg = json.loads(f.read_text())
        rows, cols = TINY[cfg["call"]]
        if "planted_beta_std" in cfg:   # Xβ spread as widely as at size
            cfg["planted_beta_std"] *= math.sqrt(cfg["features"] / cols)
        cfg["rows"], cfg["features"] = rows * cfg["chips"], cols
        f.write_text(json.dumps(cfg))
    return root


def cpu_job(root, workload, seed=2**31 + 11, seconds=0.3, trace=False):
    from benchmark.harness import session

    return session.Job(str(root), workload, seed, seconds, trace, "cpu",
                       time.monotonic())
