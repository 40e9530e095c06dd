"""Shared pieces of the port's parity tests (tests/test_torch_*.py).

The same numpy inputs go through nums_tpu (JAX on the CPU, x64 on as
tests/conftest.py sets it) and nums_tpu_torch (torch on the CPU, where
every kernel wrapper takes its plain version), and the outputs are
compared with a tolerance stated in each test file.
"""

import numpy as np
import pytest
import torch

# The suite runs several pytest workers on few cores: one torch thread
# each keeps them from oversubscribing the CPU.
torch.set_num_threads(1)

# bf16 MACs with f32 accumulation: the reference kernels' own oracle
# tolerances (tests/core/ops/test_pallas_gram.py:11 and
# tests/core/ops/test_pallas_newton.py:11).
GRAM_BF16_REL = 2e-3
STATS_BF16_REL = 4e-3


def rel_err(got, ref):
    """max|got - ref| / max|ref| in float64."""
    got = np.asarray(got, dtype=np.float64)
    ref = np.asarray(ref, dtype=np.float64)
    return float(np.max(np.abs(got - ref)) / max(np.max(np.abs(ref)), 1e-30))


@pytest.fixture(scope="module")
def jax_app():
    """nums_tpu's serial application (no lane padding)."""
    from nums_tpu.core import application_manager, settings

    old = settings.backend_name
    settings.backend_name = "serial"
    application_manager.destroy()
    app = application_manager.create()
    application_manager.set_instance(app)
    yield app
    settings.backend_name = old
    application_manager.destroy()


@pytest.fixture(scope="module")
def torch_app():
    """nums_tpu_torch's application on the CPU."""
    from nums_tpu_torch.core import application_manager

    application_manager.destroy()
    app = application_manager.create(device="cpu")
    application_manager.set_instance(app)
    yield app
    application_manager.destroy()


@pytest.fixture()
def spy_calls(monkeypatch):
    """Record the calls of module functions: ``spy(module, "name")``
    returns the list that each call of ``module.name`` appends its
    arguments to."""

    def spy(module, name):
        calls = []
        orig = getattr(module, name)

        def wrapper(*args, **kwargs):
            calls.append(args)
            return orig(*args, **kwargs)

        monkeypatch.setattr(module, name, wrapper)
        return calls

    return spy
