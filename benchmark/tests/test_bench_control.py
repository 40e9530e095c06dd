"""The control comes out as not correct, and the program as correct, at a
size the CPU holds: for each one-card cell, on three seeds, the program's
answers and the control's (the plain reference with float8_e4m3fn where
the configuration states bf16) against the float64 reference, held to the
configuration's limits: the program within every one, the control past
one of them at least. ``benchmark/control.py`` reads the same numbers on
the card at the cells' own sizes."""

import pytest

from benchmark import control
from benchmark.harness import spec
from benchmark.tests._util import cpu_job

SEEDS = [2**31 + 1, 2**32 + 7, 12345]


@pytest.mark.parametrize("workload", ["logreg.fit.2p5m", "gram.xtx.2p5m"])
def test_control_fails_a_limit_the_program_holds(tiny, workload):
    rows = control.readings(cpu_job(tiny, workload), 0, 1, SEEDS)
    limits = spec.load_cell(workload, tiny).config["limits"]
    assert [r["seed"] for r in rows] == SEEDS
    for r in rows:
        assert set(r["program"]) == set(limits), r
        assert all(r["program"][n] <= limit for n, limit in limits.items())
        assert any(r["control"][n] > limit for n, limit in limits.items())
    summary = control.summary(rows)
    assert all(summary["program_max"][n] <= limit
               for n, limit in limits.items())
    assert any(limit < summary["control_min"][n]
               for n, limit in limits.items())
