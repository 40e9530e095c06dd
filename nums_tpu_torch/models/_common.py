"""Shared helpers for the models package (``_to_ba`` of
``nums_tpu/models/_common.py``; its save/load helpers need the filesystem
port)."""

import numpy as np

from nums_tpu_torch.core.application_manager import instance as _instance
from nums_tpu_torch.core.array.blockarray import BlockArray


def _to_ba(x):
    """Anything array-like → BlockArray on the active application."""
    if isinstance(x, BlockArray):
        return x
    return _instance().array(np.asarray(x), block_shape=None)
