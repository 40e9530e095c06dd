"""Array creation as plain torch calls.

Counterpart of ``nums_tpu/core/ops/creation.py``: each creator allocates
the whole array on the backend's device in one call (the reference
compiles one program per creator into its target sharding).
"""

import torch

_CREATORS = {
    "zeros": torch.zeros,
    "ones": torch.ones,
}


def new_array(op_name: str, shape: tuple, dtype: torch.dtype, device):
    return _CREATORS[op_name](tuple(shape), dtype=dtype, device=device)


def full(shape: tuple, fill_value, dtype: torch.dtype, device):
    return torch.full(tuple(shape), fill_value, dtype=dtype, device=device)


def eye(shape: tuple, dtype: torch.dtype, device, k: int = 0):
    """Ones on the k-th diagonal (k > 0 above the main one), as
    ``numpy.eye``."""
    rows, cols = shape
    if k == 0:
        return torch.eye(rows, cols, dtype=dtype, device=device)
    i = torch.arange(rows, device=device)[:, None]
    j = torch.arange(cols, device=device)[None, :]
    return (j - i == k).to(dtype)


def diag(x):
    """Vector to diagonal matrix, or square matrix to its diagonal."""
    return torch.diag(x)
