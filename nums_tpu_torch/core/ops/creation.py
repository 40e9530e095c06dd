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


def eye(shape: tuple, dtype: torch.dtype, device):
    rows, cols = shape
    return torch.eye(rows, cols, dtype=dtype, device=device)


def diag(x):
    """Vector to diagonal matrix, or square matrix to its diagonal."""
    return torch.diag(x)
