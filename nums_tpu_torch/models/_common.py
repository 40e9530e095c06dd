"""Shared helpers for the models package (``nums_tpu/models/_common.py``):
``_to_ba``, and the persistence format that every model other than the
GLMs shares, ``save_model_arrays``/``load_model_arrays``."""

import json
import os
import shutil

import numpy as np

from nums_tpu_torch.core.application_manager import instance as _instance
from nums_tpu_torch.core.array.blockarray import BlockArray
from nums_tpu_torch.core.io.filesystem import _fs_path


def _to_ba(x):
    """Anything array-like → BlockArray on the active application."""
    if isinstance(x, BlockArray):
        return x
    return _instance().array(np.asarray(x), block_shape=None)


def save_model_arrays(path: str, meta: dict, arrays: dict):
    """Persist a fitted model: ``model.json`` (hyperparameters and
    scalars) and ``arrays.npz`` (the fitted arrays; None values are left
    out), published by rename with a backup of the earlier version until
    the new one is in place."""
    path = _fs_path(path)
    tmp = f"{path}.tmp-{os.getpid()}"
    if os.path.isdir(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    host = {
        k: (np.asarray(v.get()) if hasattr(v, "get") else np.asarray(v))
        for k, v in arrays.items() if v is not None
    }
    np.savez(os.path.join(tmp, "arrays.npz"), **host)
    with open(os.path.join(tmp, "model.json"), "w") as f:
        json.dump(meta, f)
    bak = None
    if os.path.isdir(path):
        bak = f"{path}.old-{os.getpid()}"
        if os.path.isdir(bak):
            shutil.rmtree(bak)
        os.rename(path, bak)
    elif os.path.exists(path):
        os.remove(path)  # a stale regular file at the target
    try:
        os.rename(tmp, path)
    except BaseException:
        if bak is not None and not os.path.exists(path):
            os.rename(bak, path)  # restore the earlier version
        raise
    if bak is not None:
        shutil.rmtree(bak, ignore_errors=True)


def load_model_arrays(path: str):
    """(meta, {name: np.ndarray}) from ``save_model_arrays`` output."""
    path = _fs_path(path)
    with open(os.path.join(path, "model.json")) as f:
        meta = json.load(f)
    with np.load(os.path.join(path, "arrays.npz")) as z:
        arrays = {k: z[k] for k in z.files}
    return meta, arrays
