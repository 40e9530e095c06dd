"""A run whose timed path is broken underneath comes out not correct.

Each test skips the run's look for a card and drives the rest of a run on
the CPU at a small size (the program's kernels take their plain torch
versions there, with the same bf16 rounding), with one fault planted in
the program: a step that returns its state unchanged, half of the batch
left out with the sums scaled up over the rest, the exchange between
chips left out, an answer altered where it is produced, and H alone
frozen at its first step, rounded to fp8 or taken from half of the rows
(``benchmark/faults.py``). A sound run of the same cell comes out
correct.
"""

import functools

import pytest

from benchmark import faults
from benchmark.harness import mesh, session
from benchmark.tests._util import cpu_job


def _faulty_run(job, rank, world, fault):
    with faults.planted(fault):
        return session.run(job, rank, world)


@pytest.mark.parametrize("workload,fault", [
    ("logreg.fit.2p5m", None),
    ("logreg.fit.2p5m", "step_unchanged"),
    ("logreg.fit.2p5m", "half_batch_fit"),
    ("logreg.fit.2p5m", "answer_altered_fit"),
    ("logreg.fit.2p5m", "hessian_frozen"),
    ("logreg.fit.2p5m", "hessian_fp8"),
    ("logreg.fit.2p5m", "hessian_half_rows"),
    ("gram.xtx.2p5m", None),
    ("gram.xtx.2p5m", "half_batch_gram"),
    ("gram.xtx.2p5m", "answer_altered_gram"),
])
def test_one_card_fault_comes_out_not_correct(tiny, workload, fault):
    out = _faulty_run(cpu_job(tiny, workload), 0, 1, fault)
    assert out["attempted"] > 0
    assert out["correct"] is (fault is None), out["compared"]
    assert list(out)[-1] == "compared"


@pytest.mark.parametrize("fault", ["hessian_frozen", "hessian_fp8",
                                   "hessian_half_rows"])
def test_a_hessian_fault_fails_a_probe(tiny, fault):
    """A fault of H alone fails a probe of the first steps, whatever the
    fit's own answer reads (at size it hardly depends on H)."""
    out = _faulty_run(cpu_job(tiny, "logreg.fit.2p5m"), 0, 1, fault)
    assert any(c["value"] > c["limit"] for n, c in out["compared"].items()
               if n.startswith("step")), out["compared"]


def test_a_planted_fault_is_taken_out_after_its_block():
    from nums_tpu_torch.core.ops import cuda_gram, cuda_newton
    from nums_tpu_torch.models import fast_glm

    before = (fast_glm.newton_fit, fast_glm._newton_step_penalized,
              fast_glm.mesh_reduce, cuda_newton.stats, cuda_gram.gram)
    for name in faults.FAULTS:
        with faults.planted(name):
            pass
    assert before == (fast_glm.newton_fit, fast_glm._newton_step_penalized,
                      fast_glm.mesh_reduce, cuda_newton.stats,
                      cuda_gram.gram)


@pytest.mark.parametrize("fault", [None, "exchange_left_out"])
def test_mesh_fault_comes_out_not_correct(tiny, fault):
    job = cpu_job(tiny, "logreg.fit.10m.mesh4", seconds=0.05)
    out = mesh.launch(job, 4, entry=functools.partial(_faulty_run,
                                                      fault=fault),
                      deadline_s=240.0)
    assert out["device"]["count"] == 4
    assert out["correct"] is (fault is None), out["compared"]
