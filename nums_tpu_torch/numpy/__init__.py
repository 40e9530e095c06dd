"""nums_tpu_torch.numpy: the NumPy-shaped public surface.

Counterpart of ``nums_tpu/numpy/__init__.py``: ``api``, ``extra``,
``extra2``, ``extra3``, ``extra4``, ``compat`` and ``tail`` star-imported,
and the submodules ``linalg``, ``random`` and ``fft``. It implements every
name the reference implements; any other numpy callable (one newer than
the reference's numpy, say) is filled with a ``_not_implemented`` stub
that raises ``NotImplementedError``, so a program that reaches it fails
loudly. ``python -m nums_tpu_torch.cmds.api_coverage`` reports the
surface.
"""

import inspect as _inspect

import numpy as _np

from nums_tpu_torch.numpy import api as _api  # noqa: F401
from nums_tpu_torch.numpy.api import *  # noqa: F401,F403
from nums_tpu_torch.numpy.extra import *  # noqa: F401,F403
from nums_tpu_torch.numpy.extra2 import *  # noqa: F401,F403
from nums_tpu_torch.numpy.extra3 import *  # noqa: F401,F403
from nums_tpu_torch.numpy.extra4 import *  # noqa: F401,F403
from nums_tpu_torch.numpy.compat import *  # noqa: F401,F403
from nums_tpu_torch.numpy.tail import *  # noqa: F401,F403
from nums_tpu_torch.numpy.api import _not_implemented
from nums_tpu_torch.numpy import linalg  # noqa: F401
from nums_tpu_torch.numpy import random  # noqa: F401
from nums_tpu_torch.numpy import fft  # noqa: F401
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


_fill_missing()
del _fill_missing
