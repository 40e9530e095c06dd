"""The port's op-event log and profiler hooks (``core/trace.py``), with
the cases of tests/core/test_trace.py: the same dispatch points log the
same op names as the reference's."""

import json

import numpy as np

from torch_parity import jax_app, torch_app  # noqa: F401

from nums_tpu.core import trace as jtrace
from nums_tpu_torch.core import trace


def _names(mod, app):
    mod.enable(record=True)
    mod.clear()
    try:
        x = app.array(np.ones((8, 4)), block_shape=(4, 4))
        y = x + 1.0
        y.sum(axis=0)
        y.mean()
        y.var(axis=1)
        y.std()
        app.exp(x)
        y.min(axis=0)
        _ = x.T @ x
        return [e[1] for e in mod.events()]
    finally:
        mod.disable()
        mod.clear()


def test_op_event_log(jax_app, torch_app):
    names = _names(trace, torch_app)
    assert {"add", "sum", "tensordot", "mean", "var", "std", "exp",
            "min"} <= set(names)
    assert names == _names(jtrace, jax_app)
    x = torch_app.array(np.ones((2, 2)), (2, 2))
    _ = x * 2.0
    assert trace.events() == [] and not trace.is_enabled()


def test_profile_writes_a_chrome_trace(torch_app, tmp_path):
    x = torch_app.array(np.ones((16, 4)), block_shape=(8, 4))
    with trace.profile(str(tmp_path / "prof")):
        with trace.annotate("region"):
            (x @ x.T).touch()
    path = tmp_path / "prof" / "trace.json"
    events = json.loads(path.read_text())["traceEvents"]
    assert any(e.get("name") == "region" for e in events)
