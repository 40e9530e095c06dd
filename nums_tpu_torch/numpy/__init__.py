"""nums_tpu_torch.numpy: the NumPy-shaped public surface.

Counterpart of ``nums_tpu/numpy/__init__.py``: ``api``, ``extra`` and
``extra3`` (only ``vecdot`` so far) star-imported, and the submodules
``linalg`` and ``random``. Every other numpy callable is filled with a
``_not_implemented`` stub that raises ``NotImplementedError``, so a program
that reaches a name not ported yet (those of the reference's ``extra2``,
``extra3``, ``extra4``, ``tail``, ``compat`` and ``fft``) fails loudly.
"""

import inspect as _inspect
import types as _types

import numpy as _np

from nums_tpu_torch.numpy import api as _api  # noqa: F401
from nums_tpu_torch.numpy.api import *  # noqa: F401,F403
from nums_tpu_torch.numpy.extra import *  # noqa: F401,F403
from nums_tpu_torch.numpy.extra3 import *  # noqa: F401,F403
from nums_tpu_torch.numpy.api import _not_implemented
from nums_tpu_torch.numpy import linalg  # noqa: F401
from nums_tpu_torch.numpy import random  # noqa: F401
from nums_tpu_torch.core.array.blockarray import BlockArray  # noqa: F401


def _fill_missing():
    g = globals()
    for name in _np.__dict__:
        if name.startswith("_") or name in g:
            continue
        obj = _np.__dict__[name]
        if callable(obj) and (
            _inspect.isroutine(obj) or isinstance(obj, _np.ufunc)
        ):
            g[name] = _not_implemented(obj)


def _stub_module(name, source):
    """A submodule not ported yet: each public callable of ``source``
    (numpy's own) as a raising stub."""
    mod = _types.ModuleType(f"{__name__}.{name}",
                            f"numpy.{name}: not ported yet (stubs).")
    for attr in dir(source):
        obj = getattr(source, attr)
        if not attr.startswith("_") and callable(obj):
            setattr(mod, attr, _not_implemented(obj))
    return mod


_fill_missing()
fft = _stub_module("fft", _np.fft)
del _fill_missing, _stub_module
