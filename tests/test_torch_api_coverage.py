"""``nums_tpu_torch.cmds.api_coverage`` against ``nums_tpu.cmds.api_coverage``:
the same sets, report and gates.

For each surface (numpy, numpy.random, numpy.linalg, numpy.fft) the
port's implemented, host-fallback, stub and missing names equal the
reference's; the report's text is the reference's; ``--min`` and
``--max-fallbacks`` pass and fail where the reference's do.
"""

import subprocess
import sys

import numpy as np
import pytest

from nums_tpu.cmds import api_coverage as jcov
from nums_tpu_torch.cmds import api_coverage as tcov


def test_lists_are_the_references():
    assert tcov.IGNORE == jcov.IGNORE
    assert tcov.HOST_FALLBACK == jcov.HOST_FALLBACK


@pytest.mark.parametrize("surface", ["", "random", "linalg", "fft"])
def test_sets_equal_the_references(surface):
    import nums_tpu.numpy as jnps
    import nums_tpu_torch.numpy as tnps

    def mod(root):
        return getattr(root, surface) if surface else root

    got = tcov._module_coverage(mod(np), mod(tnps))
    ref = jcov._module_coverage(mod(np), mod(jnps))
    for g, r, kind in zip(got, ref, ("implemented", "fallback", "stubs",
                                     "missing")):
        assert g == r, (kind, sorted(set(g) ^ set(r)))
    implemented, fallback, stubs, missing = got
    assert not stubs and not missing


def test_report_is_the_references():
    got, ref = {}, {}
    assert tcov.coverage_report(got) == jcov.coverage_report(ref)
    assert got == ref
    assert all(v == 100.0 for v in got.values())


def _cli(*args):
    out = subprocess.run(
        [sys.executable, "-m", "nums_tpu_torch.cmds.api_coverage", *args],
        capture_output=True, text=True, timeout=120)
    return out.returncode, out.stdout


def test_cli_gates():
    rc, out = _cli("--min", "numpy=100,numpy.fft=100",
                   "--max-fallbacks", "numpy=13,numpy.linalg=2")
    assert rc == 0, out
    lines = out.splitlines()
    assert [line.split(":")[0] for line in lines[:4]] == [
        "numpy", "numpy.random", "numpy.linalg", "numpy.fft"]
    assert all(line.endswith("stubs 0, missing 0") for line in lines[:4])
    assert "numpy.fft: implemented 18/18 (100.0%; 0 via host fallback)" \
        in out
    assert out.rstrip().endswith("coverage floors OK")


def test_cli_gates_fail(capsys):
    assert tcov.main(["--max-fallbacks", "numpy=12"]) == 1
    assert "FAIL: numpy host fallbacks 13 > ceiling 12" in \
        capsys.readouterr().out
    assert tcov.main(["--min", "numpy.nope=1"]) == 1
    assert "FAIL: numpy.nope" in capsys.readouterr().out
    assert tcov.main([]) == 0
    assert "coverage floors OK" not in capsys.readouterr().out
